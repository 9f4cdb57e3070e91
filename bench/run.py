"""Run one cell of the benchmark and print its result line.

    python3 -m bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  It measures the PyTorch port
(``src/repro_torch``) on a CUDA device and refuses to run without enough
of them; ``BENCHMARK.json`` names the cells.

    python3 -m bench.run --workload <name> --control 1,2,3 --seconds <s>

reads instead, for each seed in one process, the numbers ``correct``
compares beside the control's (the reference put in the program's place
at the next lower precision), one JSON line a seed: the readings the
limits are set from.  The benchmark's own runs never run the control."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", metavar="SEEDS",
                    help="comma-separated seeds: read the control's numbers")
    args = ap.parse_args(argv)
    if (args.seed is None) == (args.control is None):
        ap.error("give --seed or --control")
    # any compile cache stays at a fixed place inside the checkout (the
    # program's own kernels build into its fixed build/kernels/)
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(harness.BENCH / ".cache" / sub)
    sys.path.insert(0, str(harness.ROOT / "src"))
    cell, _, _, _ = harness.cell_of(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} CUDA device(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 3
    import repro_torch  # noqa: F401  (fails where the port is absent)
    torch.set_num_threads(4)
    if args.control:
        return control(args)
    res = harness.run_cell(args.workload, args.seed, args.seconds,
                           bool(args.trace), "cuda:0", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark measures "
              "the port alone", file=sys.stderr)
        return 4
    harness.print_result(res)
    return 0


def control(args) -> int:
    t = T_START
    for seed in (int(s) for s in args.control.split(",")):
        res = harness.run_cell(args.workload, seed, args.seconds, False,
                               "cuda:0", t, control=True)
        print(json.dumps({"seed": seed, "compared": res["compared"],
                          "metrics": res["metrics"],
                          "counts": res["counts"],
                          "device": res["device"]}), flush=True)
        t = time.perf_counter()
    return 0


if __name__ == "__main__":
    sys.exit(main())
