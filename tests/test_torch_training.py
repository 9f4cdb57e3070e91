"""The mini-SSD's training path on the port against the JAX package, on
the CPU: ``detector_loss`` (``repro_torch.detector.ssd``) and the SGD
loop of ``examples/video_analytics_torch.py`` against the reference's
``detector_loss`` and ``examples/video_analytics.py``.

The same weights (the reference's ``init_ssd`` through
``params_from_numpy``) and the example's numpy batches go through both:

* the loss and its three parts within rtol 1e-6 (sums over the batch
  in another order), ``pos`` and the matched ground truth exactly;
* every gradient, mapped back to the reference's layout with
  ``params_to_numpy``, within rtol 1e-5 + atol 1e-6 (7e-8 measured);
* the weights after four SGD steps within the same tolerance, step by
  step beside a JAX loop written as the example's ``step``, and after
  three steps of the example's own ``train_detector``.

A step holds IEEE float32 and deterministic cuDNN over its forward
and backward convolutions, with both TF32 switches on around it."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.core import SyntheticVideo as JVideo
from repro.core.stream import ETH_SUNNYDAY
from repro.detector import ssd as jssd
from repro_torch.core import SyntheticVideo as TVideo
from repro_torch.detector import ssd as tssd
from test_torch_repairs import NEW_API, _ieee, _settings, _tf32_on

REPO = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-6
GRAD_RTOL, GRAD_ATOL = 1e-5, 1e-6


def load_example(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


EX = load_example("video_analytics_torch")


def reference_params():
    return jssd.init_ssd(jssd.SSDConfig(), jax.random.PRNGKey(0))


def to_numpy(tree):
    return jax.tree.map(lambda a: np.array(a), tree)


def assert_trees_close(ref, port, what):
    flat_r, tdef = jax.tree.flatten(ref)
    flat_p, tdef_p = jax.tree.flatten(port)
    assert tdef == tdef_p, what
    for i, (a, b) in enumerate(zip(flat_r, flat_p)):
        assert a.shape == b.shape and b.dtype == np.float32, (what, i)
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL, atol=GRAD_ATOL,
                                   err_msg=f"{what} leaf {i}")


def batches(batch, n, seed=0):
    make = EX.make_batch_fn(TVideo(ETH_SUNNYDAY), tssd.SSDConfig(), batch)
    rng = np.random.default_rng(seed)
    return [make(rng) for _ in range(n)]


def port_loss_and_grads(params, batch):
    cfg = tssd.SSDConfig()
    ws = [w.detach().requires_grad_(True) for w in EX.leaves(params)]
    p = EX.rebuild(params, iter(ws))
    loss, parts = tssd.detector_loss(
        p, cfg, *(torch.from_numpy(a) for a in batch),
        torch.from_numpy(tssd.make_anchors(cfg)))
    grads = torch.autograd.grad(loss, ws)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in parts.items()},
            tssd.params_to_numpy(EX.rebuild(params, iter(grads))))


_JLOSS = jax.jit(jax.value_and_grad(
    lambda p, *batch: jssd.detector_loss(
        p, jssd.SSDConfig(), *batch, jssd.make_anchors(jssd.SSDConfig())),
    has_aux=True))


def reference_loss_and_grads(jparams, batch):
    (loss, parts), grads = _JLOSS(jparams, *(jnp.asarray(a) for a in batch))
    return (float(loss), {k: float(v) for k, v in parts.items()},
            to_numpy(grads))


def test_params_round_trip_exactly():
    tree = to_numpy(reference_params())
    back = tssd.params_to_numpy(tssd.params_from_numpy(tree, device="cpu"))
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("batch", [2, 4])
def test_positive_anchors_match_reference_exactly(batch):
    """``_iou`` in the reference's order: the IoU, the masked argmax and
    ``pos = best_iou >= 0.45`` equal the reference's, including a row
    whose ground truth is all masked (argmax picks box 0 in both)."""
    cfg = jssd.SSDConfig()
    anchors = jssd.make_anchors(cfg)
    _, boxes, _, mask = batches(batch, 1)[0]
    mask = mask.copy()
    mask[0, :] = 0.0                            # an all-masked image
    mask[-1, 1::2] = 0.0
    jiou = np.array(jax.vmap(lambda g, m: jssd._iou(
        jnp.asarray(anchors), g) * m[None, :])(jnp.asarray(boxes),
                                               jnp.asarray(mask)))
    tiou = (tssd._iou(torch.from_numpy(anchors), torch.from_numpy(boxes))
            * torch.from_numpy(mask)[:, None, :]).numpy()
    assert np.array_equal(jiou, tiou)
    assert np.array_equal(np.argmax(jiou, -1),
                          torch.argmax(torch.from_numpy(tiou), -1).numpy())
    jpos, tpos = jiou.max(-1) >= 0.45, tiou.max(-1) >= 0.45
    assert np.array_equal(jpos, tpos) and tpos[1:].any()
    assert not tpos[0].any()


@pytest.mark.parametrize("batch", [2, 4])
def test_loss_parts_and_gradients_match_reference(batch):
    jparams = reference_params()
    params = tssd.params_from_numpy(to_numpy(jparams), device="cpu")
    for b in batches(batch, 2, seed=batch):
        jl, jparts, jg = reference_loss_and_grads(jparams, b)
        tl, tparts, tg = port_loss_and_grads(params, b)
        np.testing.assert_allclose(tl, jl, rtol=LOSS_RTOL)
        for k in ("box", "obj", "cls"):
            np.testing.assert_allclose(tparts[k], jparts[k], rtol=LOSS_RTOL,
                                       err_msg=k)
        assert_trees_close(jg, tg, "gradients")


def test_sgd_steps_match_reference_step_by_step():
    """Four steps of the port's ``sgd_step`` against a JAX loop written
    as the example's ``step`` (value_and_grad, then ``p - 3e-3 * g``):
    each step's loss and parts, and the weights after every step."""
    jcfg, tcfg = jssd.SSDConfig(), tssd.SSDConfig()
    anchors = jssd.make_anchors(jcfg)

    @jax.jit
    def jstep(p, imgs, boxes, cls, mask):
        (loss, parts), grads = jax.value_and_grad(
            lambda q: jssd.detector_loss(q, jcfg, imgs, boxes, cls, mask,
                                         anchors), has_aux=True)(p)
        return jax.tree.map(lambda a, g: a - 3e-3 * g, p, grads), loss, parts

    jparams = reference_params()
    params = tssd.params_from_numpy(to_numpy(jparams), device="cpu")
    tanchors = torch.from_numpy(anchors)
    for k, b in enumerate(batches(3, 4)):
        jparams, jl, jparts = jstep(jparams, *(jnp.asarray(a) for a in b))
        params, tl, tparts = EX.sgd_step(params, tcfg, tanchors,
                                         *(torch.from_numpy(a) for a in b))
        np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_RTOL,
                                   err_msg=f"step {k}")
        for key in ("box", "obj", "cls"):
            np.testing.assert_allclose(float(tparts[key]), float(jparts[key]),
                                       rtol=LOSS_RTOL, atol=1e-7,
                                       err_msg=f"step {k} {key}")
        assert_trees_close(to_numpy(jparams), tssd.params_to_numpy(params),
                           f"weights after step {k}")


def test_train_detector_matches_reference_example(capsys):
    """The example's own ``train_detector`` (JAX) against the port's, on
    the reference's initial weights: the same batches, the same printed
    points, the weights after three steps within the stated tolerance;
    the port's ``history`` holds one row a step."""
    ref = load_example("video_analytics")
    _, jparams, _ = ref.train_detector(JVideo(ETH_SUNNYDAY), 3, batch=2)
    jlog = capsys.readouterr().out
    p0 = tssd.params_from_numpy(to_numpy(reference_params()), device="cpu")
    hist = []
    cfg, params, anchors = EX.train_detector(
        TVideo(ETH_SUNNYDAY), 3, batch=2, device="cpu", params=p0,
        history=hist)
    tlog = capsys.readouterr().out
    assert cfg == tssd.SSDConfig() and anchors.device.type == "cpu"
    assert len(hist) == 3 and all(np.isfinite(r).all() for r in hist)
    assert tlog == jlog                      # 3 decimals: equal losses
    assert_trees_close(to_numpy(jparams), tssd.params_to_numpy(params),
                       "weights after train_detector")


def test_train_detector_runs_on_cpu_from_its_own_init():
    hist = []
    cfg, params, anchors = EX.train_detector(
        TVideo(ETH_SUNNYDAY), 4, batch=2, device="cpu", history=hist,
        log=lambda s: None)
    assert len(hist) == 4 and all(np.isfinite(r).all() for r in hist)
    assert all(t.device.type == "cpu" for t in EX.leaves(params))
    per_frame = EX.inference_ms(params, cfg, anchors, TVideo(ETH_SUNNYDAY),
                                n=2)
    assert per_frame > 0


class _ConvSwitches(TorchDispatchMode):
    """Records the TF32 and cuDNN switches at every forward and backward
    convolution dispatched inside it."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in (torch.ops.aten.convolution.default,
                    torch.ops.aten.convolution_backward.default):
            self.seen.append((func.overloadpacket.__name__, _settings(),
                              torch.backends.cudnn.deterministic,
                              torch.backends.cudnn.benchmark))
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("how", ["legacy", "per-operation"])
def test_step_holds_ieee_and_deterministic_cudnn(monkeypatch, how):
    """With TF32 on process-wide (either API) and cuDNN left free, every
    convolution of a step, forward and backward, runs with IEEE float32
    and deterministic cuDNN in force; afterwards every switch is as it
    was."""
    _tf32_on(monkeypatch, how)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    before = (_settings(), torch.backends.cudnn.deterministic,
              torch.backends.cudnn.benchmark)
    cfg = tssd.SSDConfig()
    params = tssd.init_ssd(cfg, torch.Generator().manual_seed(0),
                           device="cpu")
    b = batches(2, 1)[0]
    rec = _ConvSwitches()
    with rec:
        EX.sgd_step(params, cfg, torch.from_numpy(tssd.make_anchors(cfg)),
                    *(torch.from_numpy(a) for a in b))
    n = len(cfg.channels) + 2
    kinds = [s[0] for s in rec.seen]
    assert kinds.count("convolution") == n
    assert kinds.count("convolution_backward") == n
    assert all(_ieee(s[1]) and s[2] is True and s[3] is False
               for s in rec.seen), rec.seen
    if NEW_API:
        assert all(s[1][1] == "ieee" for s in rec.seen), rec.seen
    assert (_settings(), torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == before
