"""Multi-camera NVR serving demo on the PyTorch port (the counterpart of
``examples/nvr_serving.py``): several cameras multiplexed onto one
shared detector pool (the paper's parallel detection generalized from
one video stream to an NVR deployment).

Each camera paces its own synthetic stream; all frames interleave into
the SAME micro-batches and replicas, and ONE batched tracker (B =
number of cameras, lockstep, one launch per tick) fills every frame
the overloaded pool drops — so each camera still gets full-coverage
output with per-camera accuracy accounting.

  PYTHONPATH=src python examples/nvr_serving_torch.py [--cameras 4]
      [--frames 48] [--rate 2.0] [--replicas 2] [--device cuda|cpu]

The tracker runs on ``--device`` (default ``cuda``, raising without
one; ``--device cpu`` runs on the CPU).
"""
from __future__ import annotations

import argparse

from repro_torch.core import evaluate_streams, proxy_detect_fn_streams
from repro_torch.serving import DetectionEngine, make_nvr_streams


def serve(n_cameras, n_frames, rate, n_replicas, device, **kw):
    frames, frame_of, videos, dets = make_nvr_streams(n_cameras,
                                                      n_frames, rate)
    eng = DetectionEngine(
        detect_fn=proxy_detect_fn_streams(videos, dets, frame_of),
        n_replicas=n_replicas, service_time=0.4, device=device, **kw)
    out = eng.serve(frames)
    return out, evaluate_streams(videos, out["streams"], n_frames)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    lam = args.cameras * args.rate
    mu = args.replicas / 0.4
    print(f"== NVR: {args.cameras} cameras x {args.rate} FPS = "
          f"{lam:.1f} FPS onto a {mu:.1f} FPS pool "
          f"({args.replicas} replicas) ==")

    print("-- drop-when-busy (the paper's behaviour, per camera) --")
    out_d, q_d = serve(args.cameras, args.frames, args.rate,
                       args.replicas, dev, drop_when_busy=True)
    print("-- track-and-interpolate (one batched tracker, "
          f"B={args.cameras}) --")
    out_t, q_t = serve(args.cameras, args.frames, args.rate,
                       args.replicas, dev, track_and_interpolate=True)
    assert out_t["tracker_launches"] == out_t["tracker_ticks"]

    print(f"  {'cam':>4s} {'frames':>6s} {'drop':>5s} {'interp':>6s} "
          f"{'cover%':>6s} {'FPS':>6s} {'mAP%':>6s} {'dropmAP%':>8s} "
          f"{'IDsw':>4s}")
    for s in sorted(out_t["per_stream"]):
        v = out_t["per_stream"][s]
        qt = q_t["per_stream"][s]
        qd = q_d["per_stream"].get(s, {"map": 0.0})
        print(f"  {s:4d} {v['frames']:6d} "
              f"{out_d['per_stream'][s]['dropped']:5d} "
              f"{v['interpolated']:6d} {v['coverage']*100:6.1f} "
              f"{v['throughput_fps']:6.2f} {qt['map']*100:6.1f} "
              f"{qd['map']*100:8.1f} {qt['id_switches']:4.0f}")
    print(f"  mean tracked mAP {q_t['map_mean']*100:.1f}% vs dropped "
          f"{q_d['map_mean']*100:.1f}%  |  "
          f"{out_t['tracker_launches']} tracker launches for "
          f"{out_t['tracker_ticks']} ticks x {args.cameras} cameras")

    print("== scaling: cameras sharing the same pool ==")
    print(f"  {'cams':>5s} {'dropcov%':>8s} {'trk mAP%':>8s} "
          f"{'drop mAP%':>9s}")
    scaling = []
    for n in (1, 2, 4, 8):
        o_d, s_d = serve(n, args.frames, args.rate, args.replicas, dev,
                         drop_when_busy=True)
        o_t, s_t = serve(n, args.frames, args.rate, args.replicas, dev,
                         track_and_interpolate=True)
        scaling.append((o_d, s_d, o_t, s_t))
        print(f"  {n:5d} {o_d['coverage']*100:8.1f} "
              f"{s_t['map_mean']*100:8.1f} {s_d['map_mean']*100:9.1f}")
    return {"drop": (out_d, q_d), "track": (out_t, q_t),
            "scaling": scaling}


if __name__ == "__main__":
    main()
