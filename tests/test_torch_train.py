"""The port's LLM training pieces (``repro_torch.data``, ``.optim``,
``models.layers.cross_entropy``, ``runtime.checkpoint`` and
``runtime.specs``) against the JAX package, on the CPU, from the same
numpy inputs.

Tolerances, stated per test: data, masks and batches are exact (the same
numpy draws); the schedules and ``adamw_update`` at rtol 1e-6 (float32
arithmetic in the same order; XLA's ``cos`` and ``pow`` may differ from
PyTorch's by an ULP); ``cross_entropy`` at rtol 1e-6 (float32 sums in
other orders); checkpoints bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import LMBatchIterator as JIterator
from repro.data import make_modality_batch as jmodality
from repro.data import synthetic_corpus as jcorpus
from repro.models import layers as jlayers
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import adamw_init as jadamw_init
from repro.optim import adamw_update as jadamw_update
from repro.optim import make_schedule as jschedule
from repro.runtime import checkpoint as jckpt
from repro.runtime import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.configs.base import InputShape
from repro_torch.data import (LMBatchIterator, make_lm_batches,
                              make_modality_batch, synthetic_corpus)
from repro_torch.models import layers as tlayers
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               make_schedule)
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import checkpoint as tckpt
from repro_torch.runtime import concrete_batch, make_positions

RTOL = 1e-6


def _n(x):
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.numpy()
    x = np.array(x)
    return x.astype(np.float32) if x.dtype.name == "bfloat16" else x


def _t(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(a)


def _same_batch(got, want):
    assert set(got) == set(want)
    for k in want:
        w = np.array(want[k])
        g = got[k]
        assert g.device.type == "cpu"
        assert str(g.dtype).removeprefix("torch.") == w.dtype.name, k
        np.testing.assert_array_equal(_n(g), w.astype(_n(g).dtype), k)


# ------------------------------------------------------------------ data
@pytest.mark.parametrize("vocab,n,seed", [(512, 3000, 0), (32768, 5000, 7)])
def test_synthetic_corpus_equals_reference(vocab, n, seed):
    got = synthetic_corpus(vocab, n, seed=seed)
    want = jcorpus(vocab, n, seed=seed)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["minicpm-2b", "deepseek-v3-671b"])
def test_lm_batch_iterator_equals_reference(arch):
    """Three batches of ``LMBatchIterator``: tokens and labels int32 (the
    reference's dtype), the mask float32 ones, all equal."""
    jcfg, tcfg = jget(arch, preset="smoke"), get_config(arch, preset="smoke")
    jit, tit = iter(JIterator(jcfg, 3, 24, seed=5)), \
        iter(LMBatchIterator(tcfg, 3, 24, seed=5, device="cpu"))
    for _ in range(3):
        _same_batch(next(tit), next(jit))
    batches = make_lm_batches(tcfg, 2, 8, 2, seed=1, device="cpu")
    assert [b["tokens"].shape for b in batches] == [(2, 8)] * 2


@pytest.mark.parametrize("arch", ["hubert-xlarge", "pixtral-12b"])
def test_modality_batch_equals_reference(arch):
    """Audio features with the masked-unit mask; VLM image embeds with a
    text-only mask."""
    jcfg, tcfg = jget(arch, preset="smoke"), get_config(arch, preset="smoke")
    for seed in (0, 3):
        got = make_modality_batch(tcfg, 2, 16, seed=seed, device="cpu")
        _same_batch(got, jmodality(jcfg, 2, 16, seed=seed))
    if tcfg.modality == "vlm":
        n_img = got["image_embeds"].shape[1]
        assert n_img > 0 and not got["loss_mask"][:, :n_img].any()
        assert got["loss_mask"][:, n_img:].all()
    with pytest.raises(ValueError):
        make_modality_batch(get_config("qwen3-4b", preset="smoke"), 1, 4,
                            device="cpu")


@pytest.mark.parametrize("arch,shape", [
    ("qwen3-4b", InputShape("t", 12, 2, "train")),
    ("hubert-xlarge", InputShape("t", 12, 2, "train")),
    ("pixtral-12b", InputShape("t", 24, 2, "train")),
    ("pixtral-12b", InputShape("p", 24, 2, "prefill")),
    ("jamba-v0.1-52b", InputShape("d", 16, 2, "decode")),
])
def test_concrete_batch_equals_reference(arch, shape):
    jcfg, tcfg = jget(arch, preset="smoke"), get_config(arch, preset="smoke")
    got = concrete_batch(tcfg, shape, seed=3, device="cpu")
    want = jspecs.concrete_batch(jcfg, shape, seed=3)
    if shape.kind == "decode":
        assert got["decode_pos"] == int(want["decode_pos"]) == 16
        np.testing.assert_array_equal(_n(got["tokens"]), want["tokens"])
        return
    _same_batch(got, want)
    np.testing.assert_array_equal(_n(make_positions(2, 5, device="cpu")),
                                  jspecs.make_positions(2, 5))


# ------------------------------------------------------------- schedules
@pytest.mark.parametrize("kind", ["cosine", "wsd"])
@pytest.mark.parametrize("peak,total,warmup", [
    (3e-4, 16, 100), (3e-3, 20, 2), (1e-2, 101, 7)])
def test_schedules_equal_reference(kind, peak, total, warmup):
    """Steps 0 .. total + 5, as ints and as int32 tensors, float32."""
    got_fn = make_schedule(kind, peak, total, warmup_steps=warmup)
    want_fn = jschedule(kind, peak, total, warmup_steps=warmup)
    for step in range(total + 6):
        want = np.asarray(want_fn(jnp.asarray(step, jnp.int32)))
        for s in (step, torch.tensor(step, dtype=torch.int32)):
            got = got_fn(s)
            assert got.dtype == torch.float32 and got.shape == ()
            np.testing.assert_allclose(_n(got), want, rtol=RTOL, atol=0)


# ----------------------------------------------------------------- adamw
def _random_tree(rng, param_dtype):
    shapes = {"a": (7, 5), "b": {"w": (33,), "z": (3, 4, 2)},
              "layers": [(6,), (2, 9)]}

    def make(s):
        return (rng.standard_normal(s) * 0.5).astype(np.float32)
    tree = {"a": make(shapes["a"]),
            "b": {"w": make(shapes["b"]["w"]), "z": make(shapes["b"]["z"])},
            "layers": [make(s) for s in shapes["layers"]]}
    params = jax.tree.map(lambda x: jnp.asarray(x, param_dtype), tree)
    return params


def _to_port(tree):
    return jax.tree.map(lambda x: _t(np.array(x)), tree)


def _dyadic_grads(rng, like, scale):
    """Gradients k / 64 * scale, k an integer in [-64, 64] and ``scale`` a
    power of two: every square is a multiple of (scale / 64)^2 and the
    sum of squares over the tree stays below 2^24 of those units, so
    the global norm's float32 sums are exact in any order."""
    return jax.tree.map(lambda x: jnp.asarray(
        rng.integers(-64, 65, x.shape) / 64 * scale, x.dtype), like)


def test_global_norm_equals_reference():
    """The global norm on random float32 gradients at rtol 1e-6: the
    per-leaf sums of squares in XLA's and PyTorch's reduction orders."""
    from repro.optim.adamw import _global_norm as jnorm
    from repro_torch.optim.adamw import _global_norm as tnorm
    rng = np.random.default_rng(3)
    for scale in (1e-3, 1.0, 30.0):
        g = jax.tree.map(lambda x: jnp.asarray(
            rng.standard_normal(x.shape) * scale, jnp.float32),
            _random_tree(rng, "float32"))
        np.testing.assert_allclose(_n(tnorm(_to_port(g))),
                                   np.asarray(jnorm(g)), rtol=RTOL)


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("grad_scale", [2.0 ** -4, 8.0],
                         ids=["no-clip", "clip"])
def test_adamw_update_equals_reference(param_dtype, moment_dtype,
                                       grad_scale):
    """Three steps on a random tree of dicts and lists: the gradients'
    global norm below the clip (1.0) and far above it; parameters,
    moments (in their dtypes), step and norm at rtol 1e-6.  The
    gradients are dyadic (``_dyadic_grads``) so that the norm, and with
    it the clip's scale, is the same float32 number in both packages: a
    one-ULP difference in the norm from another summation order
    (``test_global_norm_equals_reference``) moves a moment that nearly
    cancels (0.9 m + 0.1 g) by more than 1e-6 of itself."""
    rng = np.random.default_rng(11)
    jcfg = JAdamWConfig(peak_lr=1e-2, moment_dtype=moment_dtype)
    tcfg = AdamWConfig(peak_lr=1e-2, moment_dtype=moment_dtype)
    jp = _random_tree(rng, param_dtype)
    js = jadamw_init(jp, jcfg)
    tp, ts = _to_port(jp), adamw_init(_to_port(jp), tcfg)
    assert ts["step"].dtype == torch.int32 and int(ts["step"]) == 0
    for i in range(3):
        g = _dyadic_grads(rng, jp, grad_scale)
        lr = jnp.float32(1e-2 * (i + 1) / 3)
        jp, js, jn = jadamw_update(jp, g, js, jcfg, lr)
        tp, ts, tn = adamw_update(tp, _to_port(g), ts, tcfg,
                                  torch.tensor(float(lr)))
        np.testing.assert_allclose(_n(tn), np.asarray(jn), rtol=RTOL)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        for got, want in ((tp, jp), (ts["m"], js["m"]), (ts["v"], js["v"])):
            gl, wl = tree_leaves(got), jax.tree.leaves(want)
            assert len(gl) == len(wl)
            for a, b in zip(gl, wl):
                assert str(a.dtype).removeprefix("torch.") == b.dtype.name
                np.testing.assert_allclose(_n(a), _n(b), rtol=RTOL,
                                           atol=1e-30)
    assert (float(tn) > 1.0) == (grad_scale > 1.0)


def test_adamw_update_donate_writes_in_place():
    """``donate`` gives the same values, written into the given tensors."""
    rng = np.random.default_rng(2)
    cfg = AdamWConfig(moment_dtype="bfloat16")
    jp = _random_tree(rng, "bfloat16")
    g = _to_port(jax.tree.map(
        lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype), jp))
    p0 = _to_port(jp)
    s0 = adamw_init(p0, cfg)
    lr = torch.tensor(3e-3)
    want_p, want_s, want_n = adamw_update(p0, g, s0, cfg, lr)
    p1 = _to_port(jp)
    s1 = adamw_init(p1, cfg)
    ptrs = [t.data_ptr() for t in tree_leaves(p1) + tree_leaves(s1)]
    got_p, got_s, got_n = adamw_update(p1, g, s1, cfg, lr, donate=True)
    assert [t.data_ptr() for t in tree_leaves(got_p) + tree_leaves(got_s)] \
        == ptrs
    assert torch.equal(got_n, want_n)
    for a, b in zip(tree_leaves(got_p) + tree_leaves(got_s),
                    tree_leaves(want_p) + tree_leaves(want_s)):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------- cross-entropy
@pytest.mark.parametrize("mask", ["none", "random", "zeros"])
def test_cross_entropy_equals_reference(mask):
    """float32 logsumexp, the masked mean over ``max(sum(mask), 1)``: an
    all-zero mask gives 0; labels in int32 as the batches carry them."""
    rng = np.random.default_rng(4)
    logits = (rng.standard_normal((3, 7, 50)) * 3).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    m = {"none": None,
         "random": (rng.random((3, 7)) < 0.5).astype(np.float32),
         "zeros": np.zeros((3, 7), np.float32)}[mask]
    want = jlayers.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
    got = tlayers.cross_entropy(_t(logits), _t(labels),
                                None if m is None else _t(m))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_n(got), np.asarray(want), rtol=RTOL)
    if mask == "zeros":
        assert float(got) == 0.0
    bf = tlayers.cross_entropy(_t(logits).to(torch.bfloat16), _t(labels))
    assert bf.dtype == torch.float32


# ----------------------------------------------------------- checkpoints
def _state_tree(dtype):
    g = torch.Generator().manual_seed(0)
    return {"params": {"embed": {"table": torch.randn(5, 3, generator=g)
                                 .to(dtype)},
                       "stages": [{"layers": [
                           {"w": torch.randn(4, generator=g).to(dtype)},
                           {"w": torch.randn(2, 2, generator=g).to(dtype)}]}],
                       "router": torch.randn(3, generator=g)},
            "opt": {"step": torch.tensor(7, dtype=torch.int32)}}


def _bits(t):
    return t.reshape(-1).view(torch.uint8)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_checkpoint_round_trip_bit_for_bit(tmp_path, dtype):
    """Every leaf back in its dtype with its bits (a bf16 leaf through
    its 16-bit pattern, a NaN and -0.0 included); the reference's layout
    (``arrays.npz``, ``manifest.json`` with ``step`` and the sorted keys
    in ``jax``'s ``keystr`` form); a stale ``.tmp`` cleared."""
    tree = _state_tree(dtype)
    tree["params"]["embed"]["table"][0, :2] = torch.tensor(
        [float("nan"), -0.0])
    path = tmp_path / "ck"
    stale = tmp_path / "ck.tmp"
    stale.mkdir()
    (stale / "junk").write_text("x")
    tckpt.save_checkpoint(path, tree, step=12)
    assert not stale.exists() and tckpt.checkpoint_step(path) == 12
    manifest = json.loads((path / "manifest.json").read_text())
    jtree = jax.tree.map(lambda t: np.zeros(t.shape), tree)
    want_keys = sorted(jax.tree_util.keystr(kp) for kp, _ in
                       jax.tree_util.tree_flatten_with_path(jtree)[0])
    assert manifest["keys"] == want_keys
    assert sorted(p.name for p in path.iterdir()) == ["arrays.npz",
                                                      "manifest.json"]
    like = jax.tree.map(torch.zeros_like, tree)
    got = tckpt.restore_checkpoint(path, like, device="cpu")
    for a, b in zip(tree_leaves(got), tree_leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(_bits(a), _bits(b))
    # saving again over an existing checkpoint replaces it
    tckpt.save_checkpoint(path, like, step=13)
    assert tckpt.checkpoint_step(path) == 13
    got = tckpt.restore_checkpoint(path, tree, device="cpu")
    assert all(torch.equal(_bits(a), _bits(b)) for a, b in
               zip(tree_leaves(got), tree_leaves(like)))
    with pytest.raises(ValueError, match="shape"):
        tckpt.restore_checkpoint(path, {"opt": {"step": torch.zeros(2)}},
                                 device="cpu")


def test_reference_written_bf16_checkpoint_restores_in_port(tmp_path):
    """A checkpoint the reference wrote, one leaf bf16 (stored by numpy as
    raw ``V2`` records, which the reference's own restore cannot cast):
    the port restores it bit for bit, the float32 leaf too, and reads its
    step."""
    rng = np.random.default_rng(9)
    jtree = {"a": jnp.asarray(rng.standard_normal((4, 3)), jnp.bfloat16),
             "b": [jnp.asarray(rng.standard_normal(5), jnp.float32)]}
    jckpt.save_checkpoint(tmp_path / "ref", jtree, step=3)
    with np.load(tmp_path / "ref" / "arrays.npz") as data:
        assert data["['a']"].dtype.kind == "V"
    with pytest.raises(ValueError):
        jckpt.restore_checkpoint(tmp_path / "ref", jtree)
    like = {"a": torch.zeros((4, 3), dtype=torch.bfloat16),
            "b": [torch.zeros(5)]}
    got = tckpt.restore_checkpoint(tmp_path / "ref", like, device="cpu")
    assert got["a"].dtype == torch.bfloat16
    assert torch.equal(_bits(got["a"]), _bits(_t(np.array(jtree["a"]))))
    assert torch.equal(got["b"][0], _t(np.array(jtree["b"][0])))
    assert tckpt.checkpoint_step(tmp_path / "ref") == 3


# ------------------------------------------- chip_smoke's Adam-step gate
def _smoke():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _two_adam_steps(g0, g1, lr):
    p = {"w": torch.linspace(-0.05, 0.05, g0.numel()).reshape(g0.shape)}
    cfg = AdamWConfig()
    s = adamw_init(p, cfg)
    p, s, _ = adamw_update(p, {"w": g0}, s, cfg, torch.tensor(0.0))
    return adamw_update(p, {"w": g1}, s, cfg, torch.tensor(lr))


def test_hold_adam_step_passes_gradients_within_tolerance_only():
    """``chip_smoke.hold_adam_step``, which the card-against-CPU phases and
    ``tests/test_torch_train_families.py`` hold a second AdamW step to:
    gradients moved inside ``GRAD_RTOL`` |g| + ``GRAD_ATOL`` (at both
    steps, moments nearly cancelling included) pass; a parameter moved
    by 1e-3 of itself where the gradient is large, or by 3 lr where it
    is at rounding level, fails."""
    smoke = _smoke()
    rng = np.random.default_rng(5)
    n, lr = 4000, 3e-3
    g0 = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e-3)
    g1 = -0.9 * g0 + torch.from_numpy(
        rng.standard_normal(n).astype(np.float32) * 1e-5)   # m2 near 0
    g0[:50] = 1e-9
    g1[:50] = torch.from_numpy(rng.standard_normal(50).astype(np.float32)
                               * 1e-8)
    want, ws, _ = _two_adam_steps(g0, g1, lr)
    shift = lambda g, f: g + f * (smoke.GRAD_RTOL * g.abs()
                                  + smoke.GRAD_ATOL) * torch.from_numpy(
        rng.uniform(-1, 1, n).astype(np.float32))
    got, _, _ = _two_adam_steps(shift(g0, 0.9), shift(g1, 0.9), lr)
    args = ({"w": g0}, {"w": g1}, ws["m"], ws["v"], (1.0, 1.0), lr,
            AdamWConfig())
    n_small, n_cond = smoke.hold_adam_step("t", got, want, *args)
    assert n_small >= 50 and n_cond > 0
    assert smoke.hold_adam_step("t", want, want, *args) == (n_small, 0)
    for idx, by in ((100, 1e-3 * float(want["w"][100].abs()) + 1e-9),
                    (10, 3 * lr)):
        bad = {"w": want["w"].clone()}
        bad["w"][idx] += by
        with pytest.raises(smoke.SmokeFailure, match="a parameter off"):
            smoke.hold_adam_step("t", bad, want, *args)


# ------------------------------------- chip_smoke's profiled device time
def _profiled(smoke, monkeypatch, traces, per_call=1):
    """``smoke.device_ms_a_call`` on one call that adds ``per_call`` to a
    stand-in launch counter, with ``profile_calls`` replaced by one that
    makes the real one's 2 * reps + 1 calls and returns the next of
    ``traces`` (each a list of ``_device_rows``)."""
    from types import SimpleNamespace
    count = {"greedy_assign": 0}
    traces = list(traces)

    def fn():
        count["greedy_assign"] += per_call

    def profile_calls(label, calls, reps):
        for _ in range(2 * reps + 1):
            calls[0][1]()
        return {calls[0][0]: traces.pop(0)}

    monkeypatch.setattr(smoke, "ops",
                        SimpleNamespace(launches=lambda: dict(count)))
    monkeypatch.setattr(smoke, "profile_calls", profile_calls)
    out = smoke.device_ms_a_call("assign", [("B=4", "::assign_kernel", fn)],
                                 reps=20)
    return out, traces


def test_device_ms_a_call_traces_again_only_when_nothing_recorded(
        monkeypatch, capsys):
    """A trace with no device event is taken again, up to
    ``PROFILE_TRIES`` traces; a trace that records another kernel, or
    launches counted other than one a call, fail at once."""
    smoke = _smoke()
    row = [(80.0, 20, "void ::assign_kernel<1>(...)")]
    out, left = _profiled(smoke, monkeypatch, [[], row, row])
    assert out == {"B=4": 80.0 / 20 / 1e3} and left == [row]
    assert "trace 1 recorded no device event" in capsys.readouterr().out
    with pytest.raises(smoke.SmokeFailure, match="in trace 3 of 3"):
        _profiled(smoke, monkeypatch, [[]] * smoke.PROFILE_TRIES)
    with pytest.raises(smoke.SmokeFailure, match="in trace 1 of 3"):
        _profiled(smoke, monkeypatch,
                  [[(5.0, 20, "void ::nms_kernel(...)")], row])
    with pytest.raises(smoke.SmokeFailure, match="launches counted"):
        _profiled(smoke, monkeypatch, [row], per_call=2)
