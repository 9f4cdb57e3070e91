"""Quickstart on the PyTorch port (the counterpart of
``examples/quickstart.py``): the paper's multi-model parallel detection
in ~20 lines.

  PYTHONPATH=src python examples/quickstart_torch.py [--device cuda|cpu]

The device (where each run keeps its tracker table) defaults to ``cuda``
and the run raises without one; pass ``--device cpu`` to run on the CPU.
"""
from __future__ import annotations

import argparse

from repro_torch.core import ParallelDetector, choose_n

LAMBDA, MU = 14.0, 2.5          # ETH-Sunnyday stream rate; NCS2 YOLOv3 rate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    # 1. The problem: one accelerator is 5.6x too slow -> random frame drops
    single = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"],
                              device=dev).run()
    print(f"single NCS2:  sigma={single.sigma:.1f} FPS  "
          f"mAP={single.map_score*100:.1f}%  "
          f"(~{single.drops_per_processed:.0f} drops per processed frame)")

    # 2. The paper's fix: n = ceil(lambda/mu) parallel detection models
    n = choose_n(LAMBDA, MU, "conservative")
    parallel = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"] * n,
                                scheduler="fcfs", device=dev).run()
    print(f"{n} parallel:   sigma={parallel.sigma:.1f} FPS  "
          f"mAP={parallel.map_score*100:.1f}%  (near real-time, near-zero "
          f"drops)")

    # 3. Heterogeneous devices: FCFS vs the round-robin baseline
    hetero = {}
    for sched in ("rr", "fcfs"):
        r = ParallelDetector("ETH-Sunnyday", "yolov3",
                             ["fast_cpu"] + ["ncs2"] * 3, sched,
                             device=dev).run(with_map=False)
        hetero[sched] = r
        print(f"fast CPU + 3 NCS2, {sched:4s}: sigma={r.sigma:.1f} FPS")
    return {"single": single, "parallel": parallel, "hetero": hetero}


if __name__ == "__main__":
    main()
