"""Sharded NVR serving demo on the PyTorch port (the counterpart of
``examples/sharded_serving.py``): one camera set, 1..N shards.

The single-host NVR demo (``nvr_serving_torch.py``) multiplexes every
camera onto one replica pool; this one spreads the SAME camera set over
shards — each shard its own ``DetectionEngine`` (replica pool +
lockstep ``B = cameras-per-shard`` tracker), per-shard reports merged
into one global report.  The last leg runs the mini-SSD's detect + NMS
over a serving mesh of torch devices (``launch.mesh.make_serving_mesh``:
one shard a visible card, up to 4; one host device on the CPU).

  PYTHONPATH=src python examples/sharded_serving_torch.py [--cameras 8]
      [--frames 24] [--rate 2.0] [--replicas 2] [--device cuda|cpu]

Everything runs on ``--device`` (default ``cuda``, raising without one;
``--device cpu`` runs on the CPU).
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.core import evaluate_streams, proxy_detect_fn_streams
from repro_torch.launch.mesh import make_serving_mesh, visible_devices
from repro_torch.serving import (FrameRequest, ShardedDetectionEngine,
                                 make_nvr_streams, make_skewed_streams)


def serve(n_shards, n_cameras, n_frames, rate, n_replicas, device):
    frames, frame_of, videos, dets = make_nvr_streams(n_cameras,
                                                      n_frames, rate)
    eng = ShardedDetectionEngine(
        n_shards=n_shards,
        detect_fn=proxy_detect_fn_streams(videos, dets, frame_of),
        n_replicas=n_replicas, service_time=0.4,
        track_and_interpolate=True, device=device)
    out = eng.serve(frames)
    return out, evaluate_streams(videos, out["streams"], n_frames)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cameras", type=int, default=8)
    ap.add_argument("--frames", type=int, default=24)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--replicas", type=int, default=2,
                    help="replicas PER SHARD")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device
    results = {}

    lam = args.cameras * args.rate
    print(f"== sharded NVR: {args.cameras} cameras x {args.rate} FPS = "
          f"{lam:.1f} FPS, {args.replicas} replicas/shard ==")
    print(f"  {'shards':>6s} {'cams/shard':>10s} {'interp':>6s} "
          f"{'cover%':>6s} {'mAP%':>6s} {'minmAP%':>7s} {'IDsw':>4s}")
    for n in (1, 2, 4):
        out, q = serve(n, args.cameras, args.frames, args.rate,
                       args.replicas, dev)
        results[f"shards{n}"] = (out, q)
        cams = max(len(s["streams"]) for s in out["per_shard"])
        assert out["coverage"] == 1.0
        print(f"  {n:6d} {cams:10d} {out['interpolated']:6d} "
              f"{out['coverage']*100:6.1f} {q['map_mean']*100:6.1f} "
              f"{q['map_min']*100:7.1f} {q['id_switches_total']:4.0f}")

    out, q = results["shards4"]
    print("== shard view (4 shards) ==")
    for h, shard in enumerate(out["per_shard"]):
        print(f"  shard {h}: cameras={shard['streams']} "
              f"frames={shard['frames']} dropped={shard['dropped']} "
              f"interpolated={shard['interpolated']} "
              f"tracker_launches={shard['tracker_launches']}")
    print(f"  merged report: {out['n_streams']} streams, "
          f"{len(out['responses'])} responses, "
          f"{len(out['per_replica'])} replicas across "
          f"{out['n_shards']} shards")

    # cross-shard work stealing: skew the load (the cameras the static
    # partition puts on shard 0 run at 2x rate) and compare the static
    # partition against epoch-based rebalancing in drop mode — the rate
    # mismatch the paper diagnoses, fixed at runtime by migrating one
    # hot camera to an idle shard
    print("== cross-shard work stealing (shard-0 cameras at 2x rate, "
          "drop mode) ==")
    print(f"  {'policy':>9s} {'drops':>5s} {'cov_min%':>8s} "
          f"{'migrations':>10s}")
    sk_frames, sk_of, sk_videos, sk_dets = make_skewed_streams(
        6, args.frames, 1.0, 2)
    sk_oracle = proxy_detect_fn_streams(sk_videos, sk_dets, sk_of)
    for policy, extra in (("static", {}),
                          ("stealing", {"rebalance": True,
                                        "epoch_s": args.frames / 3})):
        eng = ShardedDetectionEngine(
            n_shards=2, detect_fn=sk_oracle, n_replicas=args.replicas,
            service_time=0.36, drop_when_busy=True, device=dev, **extra)
        r = eng.serve(sk_frames)
        results[policy] = r
        cov = min(v["coverage"] for v in r["per_stream"].values())
        moves = ", ".join(
            f"cam{m['stream']}:{m['src']}->{m['dst']}@e{m['epoch']}"
            for m in r.get("migrations", [])) or "-"
        print(f"  {policy:>9s} {len(r['dropped']):5d} {cov*100:8.1f} "
              f"{moves:>10s}")

    # the mesh leg: the same engine with mesh= runs the mini-SSD's detect
    # + NMS on every device of the serving mesh, a block of each
    # micro-batch a device
    n_dev = min(4, len(visible_devices(dev)))
    mesh = make_serving_mesh(n_dev, device=dev)
    rng = np.random.default_rng(0)
    spmd_frames = [FrameRequest(i, rng.random((64, 64, 3))
                                .astype(np.float32), i / 40.0,
                                stream_id=i % n_dev)
                   for i in range(8 * n_dev)]
    eng = ShardedDetectionEngine(n_shards=n_dev, mesh=mesh,
                                 n_replicas=args.replicas,
                                 service_time=0.05,
                                 track_and_interpolate=True, device=dev)
    spmd = eng.serve(spmd_frames)
    results["spmd"] = spmd
    print(f"== SPMD mesh leg: one compiled detect+NMS program over "
          f"{n_dev} devices ==")
    print(f"  {spmd['n_streams']} cameras / {n_dev} shards, "
          f"coverage={spmd['coverage']:.2f}, "
          f"{len(spmd['responses'])} mini-SSD responses")
    return results


if __name__ == "__main__":
    main()
