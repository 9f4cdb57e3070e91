"""The port's sharding context and rules (``repro_torch.sharding``)
against the reference's, on the CPU.

* ``param_specs`` of all ten full configs (the port's ``meta`` build,
  the reference's ``jax.eval_shape``) on both production meshes, leaf by
  leaf: a leaf of a stage's layers is compared with the reference's
  stacked leaf's spec without its leading None (the port holds one
  tensor a layer, the reference a stack over ``repeats``).
* ``batch_spec`` over ``input_specs`` for every supported (arch, shape)
  pair on both meshes, the decode caches the same way.
* ``resolve_spec`` on hypothesis-drawn shapes, names and axis sizes.
* ``constrain`` and ``constrain_like_params``: the identity off a mesh
  and on one, a rank mismatch raising the reference's ``ValueError``.
* Placements: ``Shard(d)`` for each mesh axis the spec puts on dim d,
  ``Replicate()`` for the others.
* ``count_params`` of every full config equals the reference's count.
"""
import functools
import math

import jax
import jax.numpy as jnp
import jax.sharding as jsh
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import SHAPES as JSHAPES
from repro.configs import get_config as jget
from repro.configs import supported_shapes as jsupported
from repro.models import init_model as jinit
from repro.runtime import input_specs as jinput_specs
from repro.sharding import context as jcontext
from repro.sharding import rules as jrules
from repro_torch.configs import ARCH_IDS, SHAPES, get_config
from repro_torch.launch.dryrun import count_params, variant_for
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import param_shapes
from repro_torch.runtime import input_specs
from repro_torch.sharding import (LOGICAL_AXES, Mesh, PartitionSpec,
                                  active_mesh, batch_spec, constrain,
                                  constrain_like_params, input_shardings,
                                  mesh_context, param_shardings, param_specs,
                                  resolve_spec)
from repro_torch.sharding.rules import tree_map_with_path

MESHES = {"single": False, "multi": True}


def _ref_mesh(axes, sizes):
    """A reference mesh of the given axis sizes over the one CPU device,
    tiled (as ``tests/test_model_invariants.py`` builds it)."""
    dev = np.array(jax.devices()[:1])
    return jsh.Mesh(np.tile(dev, int(np.prod(sizes))).reshape(sizes), axes)


def _meshes(multi):
    port = make_production_mesh(multi_pod=multi)
    return port, _ref_mesh(port.axis_names, port.sizes)


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    return jax.eval_shape(lambda k: jinit(jget(arch, "full"), k),
                          jax.ShapeDtypeStruct((2,), jnp.uint32))


def _ref_by_path(specs):
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jsh.PartitionSpec))[0]
    return {jrules._path_str(kp): tuple(s) for kp, s in flat}


def _port_by_path(specs):
    out = {}
    tree_map_with_path(lambda path, s: out.__setitem__(path, tuple(s)),
                       specs)
    return out


def _ref_path(path, cfg, holder):
    """The reference's path of a port leaf: the n-th layer of stage i
    sits in the stack of pattern position n mod P.  Returns (path,
    stacked)."""
    parts = path.split("/")
    for j in range(len(parts) - 2):
        if parts[j] == holder and parts[j + 2] in ("layers", "caches"):
            P = len(cfg.stages[int(parts[j + 1])].pattern)
            parts[j + 3] = str(int(parts[j + 3]) % P)
            return "/".join(parts), True
    return path, False


def _assert_same_specs(port, ref, cfg, holder):
    assert port and len({_ref_path(p, cfg, holder)[0] for p in port}) == \
        len(ref)
    for path, spec in port.items():
        rpath, stacked = _ref_path(path, cfg, holder)
        want = ref[rpath]
        if stacked:
            assert want[0] is None, (rpath, want)
            want = want[1:]
        assert spec == want, (path, spec, want)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_match_the_reference(arch, mesh):
    port_mesh, ref_mesh = _meshes(MESHES[mesh])
    cfg = get_config(arch, "full")
    port = _port_by_path(param_specs(param_shapes(cfg), port_mesh))
    ref = _ref_by_path(jrules.param_specs(_ref_params(arch), ref_mesh))
    _assert_same_specs(port, ref, cfg, "stages")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_spec_matches_the_reference(arch):
    for shape in SHAPES:
        variant = variant_for(arch, shape)
        cfg = get_config(arch, "full", variant)
        jcfg = jget(arch, "full", variant)
        if shape not in jsupported(jcfg, variant):
            continue
        port_in = input_specs(cfg, shape)
        ref_in = jinput_specs(jcfg, JSHAPES[shape])
        for multi in MESHES.values():
            port_mesh, ref_mesh = _meshes(multi)
            port = _port_by_path(batch_spec(port_in, port_mesh))
            ref = _ref_by_path(jrules.batch_spec(ref_in, ref_mesh))
            _assert_same_specs(port, ref, cfg, "cache")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_count_params_matches_the_reference(arch):
    ref = sum(math.prod(x.shape) for x in jax.tree.leaves(_ref_params(arch)))
    assert count_params(param_shapes(get_config(arch, "full"))) == ref


_NAMES = st.sampled_from([None] + sorted(LOGICAL_AXES))
_DIMS = st.sampled_from([1, 2, 3, 4, 6, 8, 12, 16, 24, 40, 64, 96, 256])


@settings(max_examples=200, deadline=None)
@given(multi=st.booleans(),
       sizes=st.lists(st.sampled_from([1, 2, 3, 4]), min_size=3,
                      max_size=3),
       dims=st.lists(_DIMS, min_size=1, max_size=4),
       names=st.lists(_NAMES, min_size=4, max_size=4))
def test_resolve_spec_matches_the_reference(multi, sizes, dims, names):
    axes = ("pod", "data", "model") if multi else ("data", "model")
    sizes = tuple(sizes[:len(axes)])
    logical = names[:len(dims)]
    got = resolve_spec(logical, dims, Mesh(axes, sizes))
    want = jcontext.resolve_spec(logical, dims, _ref_mesh(axes, sizes))
    assert isinstance(got, PartitionSpec)
    assert tuple(got) == tuple(want)


def test_constrain_is_the_identity_and_checks_the_rank():
    x = torch.zeros((4, 6, 8))
    assert constrain(x, "batch", None) is x          # off-mesh: no check
    tree = {"w": x, "layers": [x]}
    assert constrain_like_params(tree) is tree
    with mesh_context(make_production_mesh()) as mesh:
        assert constrain(x, "batch", "seq", None) is x
        assert constrain_like_params(tree) is tree
        with pytest.raises(ValueError, match="rank mismatch"):
            constrain(x, "batch", None)
        with mesh_context(Mesh(("data", "model"), (2, 1))):
            assert active_mesh().sizes == (2, 1)
        assert active_mesh() is mesh                 # the outer restored
    assert active_mesh() is None
    assert constrain(x, "batch") is x


def test_constrain_in_the_model_leaves_logits_unchanged():
    """A decode step of the qwen3-4b smoke preset inside a mesh context
    gives the logits it gives outside one, bit for bit."""
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import init_cache, init_model
    from repro_torch.runtime import make_decode_step
    cfg = get_config("qwen3-4b", "smoke")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    step = make_decode_step(cfg)
    batch = {"tokens": torch.tensor([[3], [5]], dtype=torch.int32),
             "cache": init_cache(cfg, 2, 16, device="cpu"), "decode_pos": 4}
    want, _ = step(params, batch)
    with mesh_context(make_host_mesh(device="cpu")):
        got, _ = step(params, batch)
    assert torch.equal(got, want)


def test_placements_follow_the_spec():
    from torch.distributed.tensor import Replicate, Shard
    multi = make_production_mesh(multi_pod=True)
    tree = {"embed": {"table": torch.empty((1024, 512), device="meta")},
            "b": torch.empty((7,), device="meta")}
    specs = param_specs(tree, multi)
    assert tuple(specs["embed"]["table"]) == ("model", ("pod", "data"))
    assert param_shardings(tree, multi) == {
        "embed": {"table": (Shard(1), Shard(1), Shard(0))},
        "b": (Replicate(), Replicate(), Replicate())}
    batch = {"tokens": torch.empty((32, 8), dtype=torch.int32,
                                   device="meta"),
             "decode_pos": torch.empty((), dtype=torch.int32, device="meta")}
    single = make_production_mesh()
    assert input_shardings(batch, single) == {
        "tokens": (Shard(0), Replicate()),
        "decode_pos": (Replicate(), Replicate())}
