"""Dry run of the full configurations over the production meshes (the
port of the reference package's ``launch/dryrun.py``).

For each (architecture x input shape x mesh) pair: the parameter count,
the bytes each device of the mesh holds of the step's arguments (each
leaf's bytes over the product of the mesh axes its spec shards it on:
parameters and optimizer state for train, parameters and cache for
decode, plus the batch), and the step's global FLOPs and bytes counted
on ``meta`` tensors (``cost.model_step_cost``; they do not depend on
the mesh, so a pair counts them once for both meshes).  Nothing is
allocated or compiled: the reference lowers and compiles each pair with
XLA, which PyTorch has no counterpart for.

  PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch all]
      [--shape all] [--mesh single|multi|both] [--skip-existing]
      [--out experiments/dryrun_torch]

One JSON a pair, ``<arch>__<shape>__<mesh>.json``; a failure is recorded
with its ``error`` and ``traceback`` and the sweep goes on.
"""
from __future__ import annotations

import argparse
import json
import math
import time
import traceback
from pathlib import Path

from ..configs import ARCH_IDS, SHAPES, get_config, supported_shapes
from ..configs.base import InputShape
from ..cost import model_step_cost, step_cost
from ..models import param_shapes
from ..optim import AdamWConfig, adamw_init, make_schedule
from ..optim.adamw import tree_leaves
from ..runtime import (input_specs, make_decode_step, make_prefill_step,
                       make_train_step)
from ..sharding import batch_spec, param_specs, sharded_bytes
from .mesh import make_production_mesh

OUT_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

# long_500k needs sub-quadratic attention: SSM/hybrid run natively; the
# full-attention archs run the sliding-window variant.
NATIVE_LONG = {"rwkv6-3b", "jamba-v0.1-52b"}


def variant_for(arch: str, shape: str):
    if shape == "long_500k" and arch not in NATIVE_LONG:
        return "swa"
    return None


def opt_config(n_params: int) -> AdamWConfig:
    # >50B params: bf16 moments so FSDP-sharded AdamW fits 16GB/chip HBM
    moment = "bfloat16" if n_params > 5e10 else "float32"
    return AdamWConfig(moment_dtype=moment)


def count_params(params) -> int:
    return sum(math.prod(t.shape) for t in tree_leaves(params))


def step_args(arch: str, cfg, shape: InputShape, n_params=None,
              params=None):
    """``(step, args)`` of one (arch x shape) pair on ``meta`` tensors:
    the reference's step for the shape's kind (the train step with
    remat, the WSD schedule for minicpm-2b and cosine otherwise), and
    its arguments: the state (parameters and AdamW moments, whose dtype
    follows the full config's ``n_params``) or the parameters
    (``params``, else ``models.param_shapes``), then the batch of
    ``runtime.input_specs``."""
    params = param_shapes(cfg) if params is None else params
    specs = input_specs(cfg, shape)
    if shape.kind == "train":
        ocfg = opt_config(n_params or count_params(params))
        sched = make_schedule("wsd" if arch == "minicpm-2b" else "cosine",
                              3e-4, 10000)
        state = {"params": params, "opt": adamw_init(params, ocfg)}
        return make_train_step(cfg, ocfg, sched, remat=True), (state, specs)
    if shape.kind == "prefill":
        return make_prefill_step(cfg), (params, specs)
    return make_decode_step(cfg), (params, specs)


def pair_cost(arch: str, cfg, shape: InputShape, n_params=None):
    """The step's global ``{"flops", "bytes"}``, counted on ``meta`` at
    cut depths and extrapolated to ``cfg``'s (``cost.model_step_cost``).
    A decode step is counted at ``decode_pos`` = S, as
    ``concrete_batch`` gives it."""
    def count(cut):
        step, args = step_args(arch, cut, shape, n_params)
        if shape.kind == "decode":
            args = (args[0], dict(args[1], decode_pos=shape.seq_len))
        return step_cost(step, *args)
    return model_step_cost(cfg, count)


def argument_bytes(arch: str, cfg, shape: InputShape, mesh,
                   params=None) -> int:
    """The bytes one device of ``mesh`` holds of the step's arguments,
    laid out by ``param_specs`` (parameters and optimizer state) and
    ``batch_spec`` (the batch, with the decode cache)."""
    _, (state, batch) = step_args(arch, cfg, shape, params=params)
    return (sharded_bytes(state, param_specs(state, mesh), mesh)
            + sharded_bytes(batch, batch_spec(batch, mesh), mesh))


def run_pair(arch: str, shape_name: str, multi_pod: bool, out_dir=OUT_DIR,
             cache=None, save=True):
    """One pair's record (written to ``out_dir``).  ``cache`` keeps each
    config's parameter tree and each (arch, shape)'s counted cost across
    meshes."""
    mesh_name = "multi" if multi_pod else "single"
    t0 = time.time()
    mesh = make_production_mesh(multi_pod=multi_pod)
    result = {"arch": arch, "shape": shape_name, "mesh": mesh_name}
    try:
        variant = variant_for(arch, shape_name)
        cfg = get_config(arch, "full", variant)
        if shape_name not in supported_shapes(cfg, variant):
            result.update({"skipped": True,
                           "reason": ("encoder-only: no decode step"
                                      if cfg.encoder_only else
                                      "full attention at 524k: needs swa "
                                      "variant")})
            print(f"[dryrun] SKIP {arch} x {shape_name} "
                  f"({result['reason']})")
        else:
            shape = SHAPES[shape_name]
            cache = {} if cache is None else cache
            if (arch, variant) not in cache:
                params = param_shapes(cfg)
                cache[(arch, variant)] = params, count_params(params)
            params, n_params = cache[(arch, variant)]
            arg_bytes = argument_bytes(arch, cfg, shape, mesh, params)
            t_build = time.time()
            if (arch, shape_name) not in cache:
                cache[(arch, shape_name)] = pair_cost(arch, cfg, shape,
                                                      n_params)
            t_count = time.time()
            result.update({
                "variant": variant, "n_params": n_params,
                "kind": shape.kind, "mesh_name": mesh_name,
                "mesh": dict(zip(mesh.axis_names, mesh.sizes)),
                "memory": {"argument_size_in_bytes": arg_bytes},
                "step_cost": cache[(arch, shape_name)],
                "timing": {"build_s": t_build - t0,
                           "count_s": t_count - t_build}})
            print(f"[dryrun] OK   {arch} x {shape_name} x {mesh_name} "
                  f"(build {t_build - t0:.1f}s count "
                  f"{t_count - t_build:.1f}s, {n_params / 1e9:.1f}B "
                  f"params)")
            print(f"         argument bytes a device: {arg_bytes}")
            print(f"         flops={result['step_cost']['flops']:.3e} "
                  f"bytes={result['step_cost']['bytes']:.3e} (global)")
    except Exception as e:  # noqa: BLE001 — record the failure, keep going
        result["error"] = f"{type(e).__name__}: {e}"
        result["traceback"] = traceback.format_exc()[-4000:]
        print(f"[dryrun] FAIL {arch} x {shape_name} x {mesh_name}: "
              f"{result['error']}")
    if save:
        out_dir = Path(out_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        out = out_dir / f"{arch}__{shape_name}__{mesh_name}.json"
        out.write_text(json.dumps(result, indent=1))
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all",
                    help="architecture id or 'all'")
    ap.add_argument("--shape", default="all", help="input shape or 'all'")
    ap.add_argument("--mesh", default="single",
                    choices=["single", "multi", "both"])
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--out", default=str(OUT_DIR),
                    help="directory of the JSON records")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]
    out_dir = Path(args.out)

    n_fail, cache, t0 = 0, {}, time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                mesh_name = "multi" if mp else "single"
                out = out_dir / f"{arch}__{shape}__{mesh_name}.json"
                if args.skip_existing and out.exists():
                    prev = json.loads(out.read_text())
                    if "error" not in prev:
                        continue
                res = run_pair(arch, shape, mp, out_dir, cache)
                n_fail += 1 if "error" in res else 0
    print(f"[dryrun] done, {n_fail} failures in {time.time() - t0:.1f}s")
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
