"""The paper's multi-model parallelism as an LLM serving feature, on the
PyTorch port (the counterpart of ``examples/llm_serving.py``): batched
requests over n model replicas of an assigned architecture, FCFS vs RR,
homogeneous vs heterogeneous replicas, with real prefill/decode compute.

  PYTHONPATH=src python examples/llm_serving_torch.py [--arch qwen3-4b]
      [--device cuda|cpu]

The device defaults to ``cuda`` and the run raises without one; pass
``--device cpu`` to run on the CPU.  The weights are random, drawn from
seed 0 by ``repro_torch.models.init_model``.
"""
from __future__ import annotations

import argparse

import numpy as np

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.serving import Request, ServingEngine


def burst(cfg, n, rate, prompt_len=16, new_tokens=6, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(i, rng.integers(0, cfg.vocab_size - 1, prompt_len)
                    .astype(np.int32), new_tokens, i / rate)
            for i in range(n)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch, preset="smoke")
    if cfg.encoder_only:
        raise SystemExit("encoder-only arch: no decode serving")

    print(f"== serving {args.arch} (smoke config) on {args.device}, "
          f"{args.requests} requests ==")
    print("-- homogeneous: 1 vs 4 replicas (the paper's n-scaling) --")
    for n in (1, 4):
        eng = ServingEngine(cfg, n_replicas=n, scheduler="fcfs",
                            cache_len=64, device=args.device)
        out = eng.serve(burst(cfg, args.requests, rate=400.0))
        print(f"  n={n}: throughput={out['throughput_rps']:6.2f} req/s  "
              f"p50={out['p50_latency']*1e3:6.1f} ms  "
              f"per-replica={out['per_replica']}")

    print("-- heterogeneous (replica 0 is 5x slower): RR vs FCFS --")
    speeds = [5.0, 1.0, 1.0, 1.0]
    for sched in ("rr", "fcfs"):
        eng = ServingEngine(cfg, n_replicas=4, scheduler=sched,
                            cache_len=64, replica_speeds=speeds,
                            device=args.device)
        out = eng.serve(burst(cfg, args.requests, rate=400.0))
        print(f"  {sched:4s}: throughput={out['throughput_rps']:6.2f} "
              f"req/s  per-replica={out['per_replica']}")
    print("(FCFS routes around the slow replica; lockstep RR is dragged "
          "to n x min-rate — the paper's Table VII effect)")


if __name__ == "__main__":
    main()
