"""The port's dry run (``repro_torch.launch.dryrun``) on the CPU, at full
width on ``meta`` tensors.

* A train pair (qwen3-4b x train_4k) and a decode pair (minicpm-2b x
  decode_32k) on both production meshes: the record's fields, the
  reference's parameter count, and the per-device argument bytes equal
  to the same sum over the reference's ``jax.eval_shape`` trees laid out
  by the reference's own specs.  The prefill pair is in
  ``test_torch_dryrun_prefill.py``.
* The skips carry the reference's reasons; ``--skip-existing`` and the
  exit codes.
* The MoE expert counts of the ``scatter_add_`` repair equal
  ``torch.bincount``'s, and the dispatch tables equal those of the
  boolean-indexing form they replaced, bit for bit, with overflow.
"""
import json
import math

import jax
import jax.numpy as jnp
import jax.sharding as jsh
import numpy as np
import pytest
import torch

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.models import init_model as jinit
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.runtime import input_specs as jinput_specs
from repro.sharding import rules as jrules
from repro_torch.launch import dryrun
from repro_torch.models import moe

MESH = {"single": {"data": 16, "model": 16},
        "multi": {"pod": 2, "data": 16, "model": 16}}


def _ref_mesh(sizes):
    dev = np.array(jax.devices()[:1])
    shape = tuple(sizes.values())
    return jsh.Mesh(np.tile(dev, int(np.prod(shape))).reshape(shape),
                    tuple(sizes))


def _ref_argument_bytes(arch, shape, sizes):
    """Each leaf's bytes over the product of the mesh axes the
    reference's spec shards it on, summed over the reference's state (or
    parameters) and input specs."""
    jcfg = jget(arch, "full")
    params = jax.eval_shape(lambda k: jinit(jcfg, k),
                            jax.ShapeDtypeStruct((2,), jnp.uint32))
    n = sum(math.prod(x.shape) for x in jax.tree.leaves(params))
    specs = jinput_specs(jcfg, JSHAPES[shape])
    mesh = _ref_mesh(sizes)
    if JSHAPES[shape].kind == "train":
        moment = "bfloat16" if n > 5e10 else "float32"
        ocfg = JAdamWConfig(moment_dtype=moment)
        params = {"params": params,
                  "opt": jax.eval_shape(lambda p: jadamw_init(p, ocfg),
                                        params)}
    total = 0
    for tree, spec in ((params, jrules.param_specs(params, mesh)),
                       (specs, jrules.batch_spec(specs, mesh))):
        flat = jax.tree.leaves(spec, is_leaf=lambda x: isinstance(
            x, jsh.PartitionSpec))
        for leaf, s in zip(jax.tree.leaves(tree), flat):
            div = 1
            for entry in s:
                for a in (entry if isinstance(entry, tuple) else (entry,)):
                    if a is not None:
                        div *= sizes[a]
            nbytes = math.prod(leaf.shape) * np.dtype(leaf.dtype).itemsize
            assert nbytes % div == 0
            total += nbytes // div
    return n, total


@pytest.mark.parametrize("arch,shape", [("qwen3-4b", "train_4k"),
                                        ("minicpm-2b", "decode_32k")])
def test_pair_records_match_the_reference(tmp_path, arch, shape):
    cache = {}
    for mesh in ("single", "multi"):
        rec = dryrun.run_pair(arch, shape, mesh == "multi", tmp_path, cache)
        assert rec == json.loads(
            (tmp_path / f"{arch}__{shape}__{mesh}.json").read_text())
        assert "error" not in rec, rec.get("traceback")
        n, arg_bytes = _ref_argument_bytes(arch, shape, MESH[mesh])
        assert rec["n_params"] == n
        assert rec["memory"]["argument_size_in_bytes"] == arg_bytes
        assert rec["mesh"] == MESH[mesh] and rec["mesh_name"] == mesh
        assert rec["kind"] == JSHAPES[shape].kind
        assert rec["variant"] is None
        assert rec["step_cost"]["flops"] > 0 and rec["step_cost"]["bytes"] > 0
        assert set(rec["timing"]) == {"build_s", "count_s"}
    assert len([k for k in cache if k == (arch, shape)]) == 1


def test_skips_carry_the_reference_reasons(tmp_path, capsys):
    for shape in ("decode_32k", "long_500k"):
        rec = dryrun.run_pair("hubert-xlarge", shape, False, tmp_path)
        assert rec == {"arch": "hubert-xlarge", "shape": shape,
                       "mesh": "single", "skipped": True,
                       "reason": "encoder-only: no decode step"}
    assert "[dryrun] SKIP hubert-xlarge x long_500k (encoder-only: no " \
        "decode step)" in capsys.readouterr().out
    assert dryrun.variant_for("qwen3-4b", "long_500k") == "swa"
    assert dryrun.variant_for("rwkv6-3b", "long_500k") is None
    assert dryrun.opt_config(int(5e10) + 1).moment_dtype == "bfloat16"
    assert dryrun.opt_config(int(5e10)).moment_dtype == "float32"


def test_cli_writes_records_and_skips_existing(tmp_path, capsys):
    argv = ["--arch", "hubert-xlarge", "--shape", "decode_32k", "--mesh",
            "both", "--out", str(tmp_path)]
    with pytest.raises(SystemExit) as ex:
        dryrun.main(argv)
    assert ex.value.code == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "hubert-xlarge__decode_32k__multi.json",
        "hubert-xlarge__decode_32k__single.json"]
    out = capsys.readouterr().out
    assert out.count("[dryrun] SKIP") == 2 and "done, 0 failures" in out
    with pytest.raises(SystemExit):
        dryrun.main(argv + ["--skip-existing"])
    assert "SKIP" not in capsys.readouterr().out


def test_a_failed_pair_records_its_error(tmp_path, monkeypatch):
    def boom(cfg):
        raise RuntimeError("no shapes")
    monkeypatch.setattr(dryrun, "param_shapes", boom)
    rec = dryrun.run_pair("qwen3-4b", "decode_32k", False, tmp_path)
    assert rec["error"] == "RuntimeError: no shapes"
    assert "Traceback" in rec["traceback"]
    with pytest.raises(SystemExit) as ex:
        dryrun.main(["--arch", "qwen3-4b", "--shape", "decode_32k",
                     "--out", str(tmp_path)])
    assert ex.value.code == 1


def _old_dispatch_tables(w, idx, T, E, k, C):
    """The dispatch tables as the port computed them before the meta
    repair: ``torch.bincount`` and boolean indexing."""
    e_flat = idx.reshape(-1)
    order = torch.argsort(e_flat, stable=True)
    e_sorted = e_flat[order]
    counts = torch.bincount(e_flat, minlength=E)
    starts = torch.cumsum(counts, 0) - counts
    pos = torch.arange(T * k) - starts[e_sorted]
    valid = pos < C
    dest = torch.where(valid, e_sorted * C + pos, torch.full_like(pos, E * C))
    tok_of = torch.div(order, k, rounding_mode="floor")
    slot_tok = torch.zeros(E * C, dtype=torch.int64)
    slot_w = torch.zeros(E * C, dtype=torch.float32)
    slot_tok[dest[valid]] = tok_of[valid]
    slot_w[dest[valid]] = w.reshape(-1)[order][valid].float()
    pair_slot = torch.empty_like(dest)
    pair_slot[order] = dest
    return slot_tok, slot_w, pair_slot.reshape(T, k)


@pytest.mark.parametrize("seed", range(6))
def test_moe_counts_and_tables_equal_the_bincount_form(seed):
    g = torch.Generator().manual_seed(seed)
    T, E, k = 37, 8, 2
    scores = torch.rand((T, E), generator=g)
    if seed % 2:                       # every token on the same experts
        scores[:, :2] += 10.0
    w, idx = moe.top_k(scores, k)
    assert torch.equal(moe.expert_counts(idx, E),
                       torch.bincount(idx.reshape(-1), minlength=E))
    for C in (4, 8, T):
        got = moe._dispatch_tables(w, idx, T, E, k, C)
        want = _old_dispatch_tables(w, idx, T, E, k, C)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and torch.equal(a, b)
    meta = moe.expert_counts(idx.to("meta"), E)
    assert meta.shape == (E,) and meta.dtype == torch.int64
