"""Serving launcher (the port of the reference package's
``launch/serve.py``): the parallel-replica LLM serving engine on an
assigned architecture, or the sharded NVR detection path.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
      --n-replicas 4 --scheduler fcfs --requests 24

``--payload frames`` switches to the detection/NVR path: a synthetic
multi-camera trace served by ``ShardedDetectionEngine``.  ``--spmd``
runs the real mini-SSD over a mesh of torch devices, one device a shard
(``serving_mesh``); more shards than CUDA devices falls back to the
meshless proxy oracle with a message, as the reference does.

  PYTHONPATH=src python -m repro_torch.launch.serve --payload frames \\
      --shards 2 --cameras 8 --frames 24

Everything runs on ``--device`` (default ``cuda``, raising where no CUDA
device exists; ``--device cpu`` runs the plain versions of the kernels).
"""
from __future__ import annotations

import argparse
from typing import Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device


def serving_mesh(n_shards: int, device) -> Optional[Tuple[str, ...]]:
    """The ``--spmd`` mesh: ``n_shards`` torch devices, one a shard.  On
    the CPU each entry is ``"cpu"`` (the reference fakes host devices
    for its CPU meshes); on CUDA the first ``n_shards`` cards, or None
    where there are fewer cards than shards."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return ("cpu",) * n_shards
    if n_shards > torch.cuda.device_count():
        return None
    return tuple(f"cuda:{i}" for i in range(n_shards))


def serve_frames(args):
    """Serve-mode mesh entry point for sharded NVR detection."""
    from ..core import evaluate_streams, proxy_detect_fn_streams
    from ..serving import ShardedDetectionEngine, make_nvr_streams

    recorder = None
    if args.trace:
        from ..obs import TraceRecorder
        recorder = TraceRecorder()
    frames, frame_of, videos, dets = make_nvr_streams(
        args.cameras, args.frames, args.rate)
    mesh = None
    if args.spmd:
        mesh = serving_mesh(args.shards, args.device)
        if mesh is None:
            print(f"# {args.shards} shards > {torch.cuda.device_count()} "
                  "devices: meshless fallback")
    kw = dict(n_shards=args.shards, n_replicas=args.n_replicas,
              scheduler=args.scheduler, track_and_interpolate=True,
              recorder=recorder, device=args.device)
    catalog = None
    if args.models:
        from ..serving import ModelCatalog, paper_catalog
        full = paper_catalog()
        names = [m.strip() for m in args.models.split(",") if m.strip()]
        catalog = ModelCatalog([full[m] for m in names])
        spec = videos[0].spec
        kw.update(catalog=catalog, roi=args.roi,
                  roi_bounds=(spec.width, spec.height))
    if mesh is not None:
        eng = ShardedDetectionEngine(mesh=mesh, **kw)
        # the mesh path runs the real mini-SSD: give it real-sized
        # images (the oracle trace carries 4x4 placeholders)
        size = eng.cfg.image_size
        rng = np.random.default_rng(0)
        for f in frames:
            f.image = rng.random((size, size, 3)).astype(np.float32)
    elif catalog is not None:   # transprecise oracle: per-band detectors
        from ..serving import make_cascade_detect_fn
        eng = ShardedDetectionEngine(
            detect_fn=make_cascade_detect_fn(videos, frame_of, catalog),
            **kw)
    else:                      # oracle fallback: per-camera proxy detectors
        eng = ShardedDetectionEngine(
            detect_fn=proxy_detect_fn_streams(videos, dets, frame_of),
            service_time=0.4, **kw)
    out = eng.serve(frames)
    q = evaluate_streams(videos, out["streams"], args.frames) \
        if mesh is None else None
    print(f"payload=frames shards={out['n_shards']} "
          f"cameras={out['n_streams']} spmd={mesh is not None}")
    print(f"coverage={out['coverage']:.3f} "
          f"interpolated={out['interpolated']} "
          f"throughput={out['throughput_fps']:.2f} fps")
    for h, shard in enumerate(out["per_shard"]):
        print(f"  shard {h}: cameras={shard['streams']} "
              f"frames={shard['frames']} dropped={shard['dropped']} "
              f"tracker_launches={shard['tracker_launches']}")
    if args.models:
        red = out["roi_pixel_reduction"]
        print(f"cascade models={out['models']} "
              f"switches={out['model_switches']} "
              f"map_estimate={out['map_estimate']:.3f} "
              f"roi_passes={out['roi_pixels']['passes']} "
              f"roi_pixel_reduction={red:.3f}")
    if q is not None:
        print(f"tracked mAP mean={q['map_mean']*100:.1f}% "
              f"min={q['map_min']*100:.1f}%")
    print(f"p95_latency={out['p95_latency']*1e3:.1f} ms "
          f"p99_latency={out['p99_latency']*1e3:.1f} ms")
    if recorder is not None:
        _write_trace(args.trace, recorder)


def _write_trace(path: str, recorder):
    """Export the recorded trace (Perfetto-viewable Chrome JSON) and
    audit it before writing — a trace that breaks the serving
    invariants fails at the source, not at inspection."""
    from ..obs import audit_recorder, write_chrome_trace
    res = audit_recorder(recorder)
    write_chrome_trace(path, recorder)
    print(f"trace: {len(recorder.events)} events -> {path} "
          f"(open at https://ui.perfetto.dev)  audit="
          f"{'ok' if res.ok else 'FAIL'}")
    if not res.ok:
        for v in res.violations[:5]:
            print(f"  audit violation: {v}")
        raise SystemExit(1)


def serve_tokens(args):
    """LLM token serving through ``ServingEngine``."""
    from ..configs import ARCH_IDS, get_config
    from ..serving import Request, ServingEngine

    if args.arch not in ARCH_IDS:
        raise SystemExit(f"unknown --arch {args.arch}; one of {ARCH_IDS}")
    cfg = get_config(args.arch, preset=args.preset)
    if cfg.encoder_only:
        raise SystemExit(f"{args.arch} is encoder-only: no decode serving")
    speeds = None
    if args.heterogeneous:
        speeds = [0.2] + [1.0] * (args.n_replicas - 1)
    recorder = None
    if args.trace:
        from ..obs import TraceRecorder
        recorder = TraceRecorder()
    engine = ServingEngine(cfg, n_replicas=args.n_replicas,
                           scheduler=args.scheduler, cache_len=256,
                           replica_speeds=speeds, recorder=recorder,
                           device=args.device)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size - 1, args.prompt_len)
                    .astype(np.int32), args.new_tokens, i / args.rate)
            for i in range(args.requests)]
    out = engine.serve(reqs)
    print(f"arch={args.arch} n={args.n_replicas} sched={args.scheduler}")
    print(f"throughput={out['throughput_rps']:.2f} req/s  "
          f"p50_latency={out['p50_latency']*1e3:.1f} ms  "
          f"dropped={len(out['dropped'])}")
    print(f"p95_latency={out['p95_latency']*1e3:.1f} ms  "
          f"p99_latency={out['p99_latency']*1e3:.1f} ms")
    print(f"per-replica counts: {out['per_replica']}")
    first = out["responses"][0]
    print(f"first response tokens: {first.tokens.tolist()}")
    if recorder is not None:
        _write_trace(args.trace, recorder)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--payload", default="tokens",
                    choices=["tokens", "frames"],
                    help="tokens: LLM serving; frames: sharded NVR "
                         "detection")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run (cuda or cpu)")
    ap.add_argument("--shards", type=int, default=1,
                    help="frames payload: shards for the camera set")
    ap.add_argument("--cameras", type=int, default=4)
    ap.add_argument("--frames", type=int, default=24,
                    help="frames payload: frames per camera")
    ap.add_argument("--spmd", action="store_true",
                    help="frames payload: the mesh detect path (mini-SSD, "
                         "one device a shard) instead of the proxy oracle")
    ap.add_argument("--models", default=None, metavar="fast,heavy",
                    help="frames payload: comma subset of "
                         "fast/medium/heavy -> transprecise cascade "
                         "(per-micro-batch model selection over the "
                         "paper_catalog profiles)")
    ap.add_argument("--roi", action="store_true",
                    help="frames payload: hierarchical ROI second pass "
                         "(cheap first-pass boxes re-detected by the "
                         "heaviest catalog model; needs --models)")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--preset", default="smoke")
    ap.add_argument("--n-replicas", type=int, default=4)
    ap.add_argument("--scheduler", default="fcfs",
                    choices=["fcfs", "rr", "wrr", "proportional"])
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--rate", type=float, default=None,
                    help="arrival rate: req/s for tokens (default 20), "
                         "per-camera FPS for frames (default 2)")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=8)
    ap.add_argument("--heterogeneous", action="store_true",
                    help="replica 0 is 5x faster (the paper's fast-CPU+"
                         "NCS2 mix)")
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record the frame-lifecycle trace and export "
                         "it as Chrome-trace-event JSON (open at "
                         "https://ui.perfetto.dev); the trace is "
                         "audited before writing")
    args = ap.parse_args(argv)

    if args.rate is None:
        args.rate = 2.0 if args.payload == "frames" else 20.0
    if args.payload == "frames":
        serve_frames(args)
    else:
        serve_tokens(args)


if __name__ == "__main__":
    main()
