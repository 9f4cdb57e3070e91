"""The harness: finds a cell's configuration, mix, system module and
metric readers by name from ``BENCHMARK.json``, runs the cell, and
assembles the result line.  Nothing of one cell is written here: a
configuration is ``configs/<name>.json`` (its ``system`` names the module
``systems/<system>.py``), a mix ``traffic/<name>.json``, a per-layer
metric ``metrics/<name>.py`` (or its family's, ``load_reader``)."""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from dataclasses import dataclass
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_of(workload: str, bench: dict | None = None):
    """(workload entry, configuration entry, its file's contents, mix)."""
    bench = bench or spec()
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}; known: "
                         f"{', '.join(sorted(cells))}")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((ROOT / entry["file"]).read_text())
    mix = json.loads((BENCH / "traffic" / f"{cell['traffic']}.json")
                     .read_text())
    return cell, entry, config, mix


def forbidden_modules() -> list:
    """Loaded modules whose top-level name (before the first dot) is JAX,
    flax or the JAX package, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


@dataclass
class Ctx:
    cell: dict
    config: dict
    mix: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    t_start: float
    control: bool = False
    t_open: float | None = None
    memory_peak: int = 0

    def open_window(self) -> float:
        """Open the measured window and return its start.  The set-up's
        objects leave the garbage collector's scans (``gc.freeze``), so a
        collection in the window walks only what the window made."""
        gc.collect()
        gc.freeze()
        self.t_open = time.perf_counter()
        return self.t_open

    def close_window(self):
        gc.unfreeze()

    def read_memory(self):
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            self.memory_peak = int(torch.cuda.max_memory_allocated(
                self.device))


def load_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``, or, for a
    metric ``<family>.<cells>`` with no file of its own,
    ``metrics/<family>.py``."""
    path = BENCH / "metrics" / f"{name}.py"
    if not path.is_file() and "." in name:
        path = BENCH / "metrics" / f"{name.rsplit('.', 1)[0]}.py"
    mod_spec = importlib.util.spec_from_file_location(
        f"bench.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(mod)
    return mod.read


def applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device, t_start: float, control: bool = False,
             config_override=None, mix_override=None, bench=None) -> dict:
    """Run one cell and return its result: the contract's keys, with
    ``compared`` (name -> [value, limit]) last."""
    import torch
    bench = bench or spec()
    cell, entry, config, mix = cell_of(workload, bench)
    if config_override:
        config = config_override(config)
    if mix_override:
        mix = mix_override(mix)
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.cuda.init()
        torch.zeros(1, device=device)
        torch.cuda.reset_peak_memory_stats(device)
    system = importlib.import_module(f"bench.systems.{config['system']}")
    ctx = Ctx(cell, config, mix, seed, seconds, trace, device, t_start,
              control=control)
    out = system.run(ctx)
    e2e = dict(out["e2e"], setup_s=ctx.t_open - t_start)
    metrics = {}
    if trace:
        reading = out["trace"]
        for m in bench["per_layer"]:
            if applies(m, workload):
                v = load_reader(m["name"])(ctx, out)
                if v is not None:
                    metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in bench["end_to_end"]:
            if applies(m, workload):
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
    compared = {k: [v, lim] for k, (v, lim) in out["compared"].items()}
    correct = out["failed"] == 0 and all(
        lim is not None and v <= lim for k, (v, lim) in compared.items()
        if not k.startswith("control."))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": ctx.memory_peak}
    res = {"correct": bool(correct), "attempted": int(out["attempted"]),
           "failed": int(out["failed"]), "metrics": metrics, "device": dev}
    if trace:
        dev["busy_s"] = reading.busy_s
        dev["window_s"] = reading.window_s
        res["breakdown"] = {"device_ops": reading.top_ops(),
                            "idle_gaps": reading.idle_gaps()}
    res["counts"] = out.get("counts", {})
    res["compared"] = compared
    return res


def print_result(res: dict):
    """The compared numbers as the last lines of standard error, and the
    result as the last line of standard output."""
    for k, (v, lim) in res["compared"].items():
        print(f"compared {k} = {v!r} (limit {lim!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(res), flush=True)


def p95_ms(walls) -> float:
    """The 95th percentile of every wall in the window (seconds), in ms,
    interpolated between order statistics (numpy's default)."""
    import numpy as np
    return float(np.percentile(np.asarray(walls, float), 95)) * 1e3


def rate(n: float, window_s: float) -> float:
    """All the window's work over all its time."""
    return n / window_s
