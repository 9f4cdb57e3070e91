"""Training of every architecture of ``ARCH_IDS`` on the port against the
JAX package, on the CPU, at the ``smoke`` presets in float32, from the
reference's weights (``models.params_from_numpy``) and batches.

The reference runs two jitted train steps from its initial state (the
first at the schedule's lr of 0, which only fills the moments); the
port's ``loss_fn`` and ``grad_fn`` are held against its loss and
``jax.grad`` at the initial parameters, and one port
``make_train_step(remat=True)`` from the reference's state after step 1
(``train_state_from_numpy``) against its state after step 2.

Tolerances, stated per test: metrics within 1e-5 absolute (losses of
O(6); measured about 5e-7); gradients within rtol 1e-5 + atol 1e-6
(measured at most 5.5e-7 beyond rtol, jamba's); new parameters, wherever
the reference's gradient exceeds 1e-5 in magnitude, within rtol 1e-5
plus what the gradient tolerance can move Adam's step by (chip_smoke's
``adam_step_tolerance``), and elsewhere within 2 lr plus that rtol:
where a gradient sits at rounding level Adam's step is about +-lr times
the sign of a number that is mostly rounding, while the decay term is
the same in both; the moments within rtol 1e-5 + atol 1e-7.  The port's
remat on and off are bit-equal on the CPU.  The chunked attention's
backward is held against ``jax.grad`` of the reference's
``sdpa_masked`` at rtol 1e-5 + atol 1e-6.
"""
import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.data import LMBatchIterator as JIterator
from repro.data import make_modality_batch as jmodality
from repro.models import attention as jattn
from repro.optim import AdamWConfig as JAdamWConfig
from repro.optim import make_schedule as jschedule
from repro.runtime.steps import loss_fn as jloss_fn
from repro.runtime.steps import make_train_step as jmake_train_step
from repro.runtime.steps import train_state_init as jtrain_state_init
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.models import params_from_numpy, train_state_from_numpy
from repro_torch.models import attention as tattn
from repro_torch.optim import AdamWConfig, make_schedule
from repro_torch.optim.adamw import tree_leaves
from repro_torch.runtime import grad_fn, loss_fn, make_train_step

#: chip_smoke.py, loaded by path: its ``hold_adam_step`` and the
#: tolerances it shares with these tests
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
SMOKE = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(SMOKE)

METRIC_ATOL = 1e-5
GRAD_RTOL, GRAD_ATOL = SMOKE.GRAD_RTOL, SMOKE.GRAD_ATOL      # 1e-5, 1e-6
PARAM_RTOL = SMOKE.PARAM_RTOL                                # 1e-5
#: a reference gradient at most this large is at rounding level (1e-5)
SMALL_GRAD = SMOKE.SMALL_GRAD
MOMENT_ATOL = SMOKE.MOMENT_ATOL                              # 1e-7
LR, STEPS, WARMUP = 1e-2, 8, 2
B, T = 2, 32


def _t(a):
    return torch.from_numpy(np.array(a))


def _n(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.array(x)


def _schedule_kind(arch):
    return "wsd" if "minicpm" in arch else "cosine"


@functools.cache
def reference_run(arch):
    """The reference's two train steps (lr 0, then LR / WARMUP): its
    initial state, batches, loss metrics and ``jax.grad`` at the initial
    parameters, the states after steps 1 and 2, the gradients at step
    2's parameters and both steps' metrics, all numpy.  Read only."""
    jcfg = jget(arch, preset="smoke")
    opt = JAdamWConfig(peak_lr=LR)
    sched = jschedule(_schedule_kind(arch), LR, STEPS, warmup_steps=WARMUP)
    step = jmake_train_step(jcfg, opt, sched, remat=True)
    if jcfg.modality == "text":
        it = iter(JIterator(jcfg, B, T, seed=3))
        batches = [next(it) for _ in range(2)]
    else:
        batches = [jmodality(jcfg, B, T, seed=s) for s in (1, 2)]

    @jax.jit
    def both(state, batch):
        (_, metrics), grads = jax.value_and_grad(
            lambda p: jloss_fn(p, jcfg, batch), has_aux=True)(
                state["params"])
        return metrics, grads, step(state, batch)

    s0 = jtrain_state_init(jcfg, jax.random.PRNGKey(0), opt)
    m0, g0, (s1, sm0) = both(s0, batches[0])
    _, g1, (s2, sm1) = both(s1, batches[1])
    numpy = lambda t: jax.tree.map(np.array, t)
    return {"state0": numpy(s0), "batches": numpy(batches),
            "metrics0": numpy(m0), "grads0": numpy(g0), "state1": numpy(s1),
            "grads1": numpy(g1), "state2": numpy(s2),
            "metrics1": numpy(sm0), "metrics2": numpy(sm1)}


def _port(arch):
    cfg = get_config(arch, preset="smoke")
    ref = reference_run(arch)
    batches = [{k: _t(v) for k, v in b.items()} for b in ref["batches"]]
    return cfg, ref, batches


def _close_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(_n(got[k]), want[k], rtol=0,
                                   atol=METRIC_ATOL, err_msg=k)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_loss_fn_metrics_equal_reference(arch):
    cfg, ref, batches = _port(arch)
    params = params_from_numpy(cfg, ref["state0"]["params"], device="cpu")
    with torch.no_grad():
        total, metrics = loss_fn(params, cfg, batches[0])
    _close_metrics(metrics, ref["metrics0"])
    assert float(total) == float(metrics["total_loss"])
    assert ("mtp_loss" in metrics) == cfg.mtp


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_grads_equal_jax_grad(arch):
    """Every parameter's gradient (the reference's tree unstacked into
    per-layer leaves, as ``params_from_numpy`` does) within rtol 1e-5 +
    atol 1e-6 of ``jax.grad``; the metrics ``grad_fn`` returns within
    1e-5."""
    cfg, ref, batches = _port(arch)
    params = params_from_numpy(cfg, ref["state0"]["params"], device="cpu")
    grads, metrics = grad_fn(params, cfg, batches[0], remat=True)
    _close_metrics(metrics, ref["metrics0"])
    want = params_from_numpy(cfg, ref["grads0"], device="cpu")
    got_l, want_l = tree_leaves(grads), tree_leaves(want)
    assert len(got_l) == len(want_l) == len(tree_leaves(params))
    for g, w, p in zip(got_l, want_l, tree_leaves(params)):
        assert g.dtype == p.dtype and g.shape == p.shape
        np.testing.assert_allclose(_n(g), _n(w), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_continues_reference_run(arch):
    """The reference's state after its step 1 carried into the port; one
    port ``make_train_step(remat=True)`` against the reference's step 2:
    metrics (``grad_norm``, ``lr`` included) within 1e-5, the step count,
    the moments within ``PARAM_RTOL`` + ``MOMENT_ATOL``, and the
    parameters by chip_smoke's ``hold_adam_step``: where the reference's
    |g| > ``SMALL_GRAD`` within ``adam_step_tolerance`` (``PARAM_RTOL``
    plus what the gradient tolerance can move Adam's step by), elsewhere
    within 2 lr plus ``PARAM_RTOL`` (the counts printed).  A tolerance
    of ``PARAM_RTOL`` alone fails where the first moment nearly cancels
    (0.9 * 0.1 g1 + 0.1 g2 near 0; 3,188 elements of hubert's, 14,968 of
    jamba's): there a gradient difference well inside ``GRAD_ATOL``
    moves Adam's step by a few 1e-4 of lr, which the propagated
    tolerance bounds."""
    cfg, ref, batches = _port(arch)
    state = train_state_from_numpy(cfg, ref["state1"], device="cpu")
    assert state["opt"]["step"].dtype == torch.int32
    opt = AdamWConfig(peak_lr=LR)
    step = make_train_step(cfg, opt,
                           make_schedule(_schedule_kind(arch), LR, STEPS,
                                         warmup_steps=WARMUP), remat=True)
    new, metrics = step(state, batches[1])
    want_metrics = ref["metrics2"]
    _close_metrics(metrics, want_metrics)
    lr = float(want_metrics["lr"])
    assert lr > 0 and float(metrics["lr"]) == lr
    want = train_state_from_numpy(cfg, ref["state2"], device="cpu")
    assert int(new["opt"]["step"]) == int(want["opt"]["step"]) == 2
    scales = [min(1.0, opt.grad_clip / (float(m["grad_norm"]) + 1e-9))
              for m in (ref["metrics1"], want_metrics)]
    n_small, n_cond = SMOKE.hold_adam_step(
        arch, new["params"], want["params"],
        params_from_numpy(cfg, ref["grads0"], device="cpu"),
        params_from_numpy(cfg, ref["grads1"], device="cpu"),
        want["opt"]["m"], want["opt"]["v"], scales, lr, opt)
    n_all = sum(t.numel() for t in tree_leaves(want["params"]))
    print(f"{arch}: of {n_all} parameters {n_small} had |g| <= "
          f"{SMALL_GRAD} (held within 2 lr), {n_cond} others sat beyond "
          f"rtol {PARAM_RTOL} and within the propagated tolerance")
    for key in ("m", "v"):
        for got, exp in zip(tree_leaves(new["opt"][key]),
                            tree_leaves(want["opt"][key])):
            np.testing.assert_allclose(_n(got), _n(exp), rtol=PARAM_RTOL,
                                       atol=MOMENT_ATOL)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_remat_on_and_off_bit_equal(arch):
    """Recomputing each pattern repetition in backward changes no value:
    gradients and metrics bit-equal with and without remat, and the loss
    equal to the forward under ``no_grad`` (where remat is off)."""
    cfg, ref, batches = _port(arch)
    params = params_from_numpy(cfg, ref["state0"]["params"], device="cpu")
    g_on, m_on = grad_fn(params, cfg, batches[0], remat=True)
    g_off, m_off = grad_fn(params, cfg, batches[0], remat=False)
    for a, b in zip(tree_leaves(g_on), tree_leaves(g_off)):
        assert torch.equal(a, b)
    assert all(torch.equal(m_on[k], m_off[k]) for k in m_on)
    with torch.no_grad():
        _, m_eval = loss_fn(params, cfg, batches[0], remat=True)
    assert torch.equal(m_eval["total_loss"], m_on["total_loss"])


def test_chunked_attention_backward_recomputes_each_tile(monkeypatch):
    """The chunked online softmax at T = S = 2048 (B = 1, H = 2, D = 16,
    causal; the path ``sdpa_masked`` takes at T >= 1024, S >= 2048):
    output and the gradients of q, k and v against the reference's
    ``sdpa_masked`` and ``jax.grad`` (rtol 1e-5 + atol 1e-6).  Counted by
    a ``saved_tensors_hooks`` pair around the forward, autograd saves,
    with the running (m, l, acc) each recomputed tile keeps, less than
    one (T, S) float32 matrix; the same loop with each tile kept for
    backward saves more than that, and gives the same gradients."""
    rng = np.random.default_rng(0)
    Bq, H, Tq, D = 1, 2, 2048, 16
    q, k, v, w = (rng.standard_normal((Bq, Tq, H, D)).astype(np.float32)
                  for _ in range(4))
    pos = np.broadcast_to(np.arange(Tq, dtype=np.int32), (Bq, Tq))
    scale = D ** -0.5

    def jloss(q, k, v):
        out = jattn.sdpa_masked(q, k, v, pos, pos, True, None, None, scale)
        return jnp.sum(out * w), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(q, k, v)

    def run():
        ts = [_t(a).requires_grad_() for a in (q, k, v)]
        saved = []

        def pack(x):
            saved.append(x.numel() * x.element_size())
            return x
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda x: x):
            p = _t(pos).long()
            out = tattn.sdpa_masked(*ts, p, p, True, None, None, scale)
        grads = torch.autograd.grad(torch.sum(out * _t(w)), ts)
        return out, grads, sum(saved)

    out, grads, saved = run()
    np.testing.assert_allclose(_n(out), np.array(jout), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL)
    for g, jg in zip(grads, jgrads):
        np.testing.assert_allclose(_n(g), np.array(jg), rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL)
    tiles = (Tq // tattn.Q_CHUNK) * (Tq // tattn.K_CHUNK)
    carry = tiles * Bq * H * tattn.Q_CHUNK * (2 + D) * 4   # m, l, acc
    one_matrix = Tq * Tq * 4
    print(f"chunked attention: autograd saved {saved} bytes, the tiles' "
          f"running (m, l, acc) {carry}; one (T, S) float32 matrix is "
          f"{one_matrix}")
    assert saved + carry < one_matrix
    monkeypatch.setattr(tattn, "checkpoint", lambda fn, *a, **kw: fn(*a))
    _, kept_grads, kept_saved = run()
    assert kept_saved > one_matrix
    for a, b in zip(grads, kept_grads):
        assert torch.equal(a, b)
