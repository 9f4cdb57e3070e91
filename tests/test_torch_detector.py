"""The port's mini-SSD against the JAX package on the CPU: the same
parameters (carried across by ``params_from_numpy``) give the same head
outputs within 1e-4 (convolution sums run in another order), and the
decode + NMS tail on bit-identical head outputs gives identical
``keep``/``valid``/``classes`` with boxes and scores within rtol 1e-6
(``exp``/``sigmoid`` may differ by an ULP between the libraries; boxes
near 0 also get atol 1e-7)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.detector.ssd as jssd
import repro_torch.detector.ssd as tssd
from repro.kernels import nms as jnms

FWD_ATOL = 1e-4


@pytest.fixture(scope="module")
def jax_params():
    cfg = jssd.SSDConfig()
    params = jssd.init_ssd(cfg, jax.random.PRNGKey(0))
    return cfg, params, jax.tree.map(lambda a: np.array(a), params)


def _images(seed, B, size=64):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (B, size, size, 3)).astype(np.float32)


def test_params_from_numpy_layout(jax_params):
    _, params, tree = jax_params
    p = tssd.params_from_numpy(tree, device="cpu")
    w_j = tree["backbone"][1]["w"]                 # (kh, kw, in, out)
    w_t = p["backbone"][1]["w"].numpy()            # (out, in, kh, kw)
    assert w_t.shape == (w_j.shape[3], w_j.shape[2], 3, 3)
    np.testing.assert_array_equal(w_t, w_j.transpose(3, 2, 0, 1))
    assert len(p["backbone"]) == len(tree["backbone"])
    np.testing.assert_array_equal(p["head16"]["b"].numpy(),
                                  tree["head16"]["b"])


def test_make_anchors_equal():
    cfg = jssd.SSDConfig()
    np.testing.assert_array_equal(tssd.make_anchors(tssd.SSDConfig()),
                                  jssd.make_anchors(cfg))


@pytest.mark.parametrize("B", [1, 3])
def test_ssd_forward_matches_reference(jax_params, B):
    cfg, params, tree = jax_params
    imgs = _images(B, B)
    out_j = jssd.ssd_forward(params, cfg, jnp.asarray(imgs))
    out_t = tssd.ssd_forward(tssd.params_from_numpy(tree, device="cpu"),
                             tssd.SSDConfig(), torch.from_numpy(imgs))
    for a, b in zip(out_j, out_t):
        assert b.shape == a.shape
        np.testing.assert_allclose(b.numpy(), np.array(a), rtol=0,
                                   atol=FWD_ATOL)


def test_same_padding_is_asymmetric_for_stride_two():
    """JAX "SAME" pads a stride-2 3x3 conv on an even input (0, 1): a
    symmetric padding=1 would shift every feature map by one pixel."""
    assert tssd._same_pad(64, 3, 2) == (0, 1)
    assert tssd._same_pad(8, 3, 1) == (1, 1)
    x = torch.arange(2 * 8 * 8, dtype=torch.float32).reshape(1, 2, 8, 8)
    w = torch.zeros(1, 2, 3, 3)
    w[0, 0, 0, 0] = 1.0                            # picks the top-left tap
    y = tssd._conv({"w": w, "b": torch.zeros(1)}, x, stride=2)
    assert y.shape == (1, 1, 4, 4)
    np.testing.assert_array_equal(y[0, 0].numpy(), x[0, 0, ::2, ::2].numpy())


def test_init_ssd_deterministic_per_generator():
    cfg = tssd.SSDConfig()
    a = tssd.init_ssd(cfg, torch.Generator().manual_seed(3),
                      device="cpu")
    b = tssd.init_ssd(cfg, torch.Generator().manual_seed(3),
                      device="cpu")
    c = tssd.init_ssd(cfg, torch.Generator().manual_seed(4),
                      device="cpu")
    w = [p["backbone"][0]["w"] for p in (a, b, c)]
    assert torch.equal(w[0], w[1]) and not torch.equal(w[0], w[2])
    assert w[0].shape == (16, 3, 3, 3)
    std = 1.0 / np.sqrt(27)
    assert float(w[0].abs().max()) <= 2 * std + 1e-6     # truncated at 2σ


def _head_outputs(seed, B, A, C=3):
    rng = np.random.default_rng(seed)
    deltas = rng.normal(0, 0.5, (B, A, 4)).astype(np.float32)
    obj = rng.normal(-2.5, 1.5, (B, A)).astype(np.float32)   # ~10% pass
    cls = rng.normal(0, 1, (B, A, C)).astype(np.float32)
    return deltas, obj, cls


def _assert_margins(deltas, obj, anchors, score_thr=0.4, iou_thr=0.5,
                    margin=1e-5):
    """No score and no candidate IoU lies within ``margin`` of its
    threshold, so an ULP difference cannot flip a decision: a failure
    of the comparison below is then a port fault, not noise."""
    scores = 1 / (1 + np.exp(-obj.astype(np.float64)))
    assert np.abs(scores - score_thr).min() > margin
    anc = anchors.astype(np.float64)
    wh_a, c_a = anc[:, 2:] - anc[:, :2], (anc[:, :2] + anc[:, 2:]) / 2
    c = c_a + deltas[..., :2] * wh_a
    wh = wh_a * np.exp(np.clip(deltas[..., 2:], -4, 4))
    boxes = np.concatenate([c - wh / 2, c + wh / 2], -1)
    iou = np.array(jnms._pair_iou(jnp.asarray(boxes, jnp.float32),
                                  jnp.asarray(boxes, jnp.float32)))
    assert np.abs(iou - iou_thr).min() > margin


@pytest.mark.parametrize("B", [1, 4])
def test_decode_tail_on_identical_head_outputs(monkeypatch, B):
    cfg = jssd.SSDConfig()
    anchors = jssd.make_anchors(cfg)
    deltas, obj, cls = _head_outputs(B + 10, B, anchors.shape[0])
    _assert_margins(deltas, obj, anchors)
    monkeypatch.setattr(jssd, "ssd_forward", lambda p, c, x: (
        jnp.asarray(deltas), jnp.asarray(obj), jnp.asarray(cls)))
    monkeypatch.setattr(tssd, "ssd_forward", lambda p, c, x: (
        torch.from_numpy(deltas), torch.from_numpy(obj),
        torch.from_numpy(cls)))
    images = np.zeros((B, 64, 64, 3), np.float32)
    out_j = [np.array(a) for a in jssd.decode_detections(
        None, cfg, jnp.asarray(images), anchors)]
    out_t = [a.numpy() for a in tssd.decode_detections(
        None, tssd.SSDConfig(), torch.from_numpy(images),
        torch.from_numpy(anchors))]
    (bj, sj, cj, vj), (bt, st, ct, vt) = out_j, out_t
    assert vj.any() and not vj.all()
    np.testing.assert_array_equal(vt, vj)
    np.testing.assert_array_equal(ct, cj)
    # boxes are c - wh/2 with c, wh ~ 0.5: a one-ULP difference in exp
    # (6e-8 at that scale) survives the cancellation near 0, so boxes
    # also get an absolute floor of 1e-7
    np.testing.assert_allclose(bt, bj, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(st, sj, rtol=1e-6, atol=0)
    assert ct.dtype == cj.dtype == np.int32


def test_decode_detections_end_to_end(jax_params):
    """Full decode from the same weights and images: the discrete
    outputs agree and the floats agree to the forward tolerance."""
    cfg, params, tree = jax_params
    imgs = _images(42, 2)
    anchors = jssd.make_anchors(cfg)
    out_j = [np.array(a) for a in jssd.decode_detections(
        params, cfg, jnp.asarray(imgs), anchors)]
    out_t = [a.numpy() for a in tssd.decode_detections(
        tssd.params_from_numpy(tree, device="cpu"), tssd.SSDConfig(),
        torch.from_numpy(imgs), torch.from_numpy(anchors))]
    np.testing.assert_array_equal(out_t[3], out_j[3])
    np.testing.assert_array_equal(out_t[2], out_j[2])
    np.testing.assert_allclose(out_t[0], out_j[0], rtol=0, atol=FWD_ATOL)
    np.testing.assert_allclose(out_t[1], out_j[1], rtol=0, atol=FWD_ATOL)
