"""The port's IoU matrix and its seed NMS path against the JAX package, on
the CPU.

``iou_matrix_torch`` follows the Pallas kernel's operation order and
equals the JAX oracle (run op by op) bit for bit; against the Pallas
kernel in interpret mode, whose body XLA jits and rewrites, it agrees to
the reference's own kernel-vs-oracle tolerance (rtol 1e-5, atol 1e-6,
``tests/test_kernels.py``).  ``ops.nms_serial`` (IoU kernel + A-step
greedy loop) and ``ops.nms`` (the batched NMS kernel at B=1) must equal
the JAX ``ops.nms_serial`` exactly on ``keep`` and ``valid``, with the
Pallas IoU and with the oracle.  The CUDA kernel is held against
``iou_matrix_torch`` on the card by ``chip_smoke.py``."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.iou import iou_matrix as jiou_pallas
from repro_torch.detector import SSDConfig, init_ssd, make_anchors
from repro_torch.detector import ssd_candidates
from repro_torch.kernels import ops
from repro_torch.kernels import ref as tref
from repro_torch.kernels.iou import iou_matrix_torch


def _boxes(rng, k, span=100.0):
    tl = rng.uniform(0, span, (k, 2))
    wh = rng.uniform(span / 100, span / 2, (k, 2))
    return np.concatenate([tl, tl + wh], -1).astype(np.float32)


@pytest.mark.parametrize("n,m,seed", [
    (1, 1, 0), (1, 300, 1), (300, 1, 2), (127, 129, 3), (128, 128, 4),
    (300, 300, 5), (17, 250, 6)])
def test_iou_plain_matches_pallas_and_oracles(n, m, seed):
    rng = np.random.default_rng(seed)
    a, b = _boxes(rng, n), _boxes(rng, m)
    got = iou_matrix_torch(torch.from_numpy(a), torch.from_numpy(b))
    assert got.shape == (n, m) and got.dtype == torch.float32
    got = got.numpy()
    oracle = np.array(jref.iou_matrix_ref(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(got, tref.iou_matrix_ref(
        torch.from_numpy(a), torch.from_numpy(b)).numpy())
    pallas = np.array(jiou_pallas(jnp.asarray(a), jnp.asarray(b),
                                  interpret=True))
    np.testing.assert_allclose(got, pallas, rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(ops.iou_matrix(
        torch.from_numpy(a), torch.from_numpy(b)).numpy(), got)


def test_iou_edge_boxes_and_bf16_input():
    """Zero-area, identical and disjoint boxes, and bfloat16 input (read
    as float32, as the reference casts)."""
    rng = np.random.default_rng(7)
    a = _boxes(rng, 40)
    a[::5, 2:] = a[::5, :2]                       # zero area
    a[1::5] = a[2::5]                             # identical pairs
    a[3::5] += 500.0                              # far from the rest
    a16 = torch.from_numpy(a).to(torch.bfloat16)
    got = iou_matrix_torch(a16, a16).numpy()
    a32 = a16.float().numpy()
    np.testing.assert_array_equal(got, np.array(jref.iou_matrix_ref(
        jnp.asarray(a32), jnp.asarray(a32))))
    assert np.all(np.diag(got)[::5] == 0.0)
    np.testing.assert_allclose(np.diag(got)[1::5], 1.0, rtol=1e-6)


def _nms_case(kind, seed):
    rng = np.random.default_rng(seed)
    A = 160
    boxes = _boxes(rng, A, span=1.0)
    scores = rng.uniform(0, 1, A).astype(np.float32)
    if kind == "ties":
        scores[1::2] = scores[::2]
        boxes[1::4] = boxes[::4]
    elif kind == "dense":
        boxes = _boxes(rng, A, span=0.3)          # many suppressions
    elif kind == "ssd":
        cfg = SSDConfig()
        params = init_ssd(cfg, torch.Generator().manual_seed(seed),
                          device="cpu")
        imgs = torch.from_numpy(rng.random((1, 64, 64, 3), np.float32))
        anchors = torch.from_numpy(make_anchors(cfg))
        b, s, _ = ssd_candidates(params, cfg, imgs, anchors)
        boxes, scores = b[0].numpy(), s[0].numpy()
    return boxes, scores


@pytest.mark.parametrize("kind", ["random", "ties", "dense", "ssd"])
@pytest.mark.parametrize("max_out", [32, 5])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_nms_serial_and_nms_equal_jax_nms_serial(kind, max_out, use_pallas):
    """max_out=5 sits below every case's survivor count: the JAX loop
    drops the later writes and keeps counting, so ``valid`` is all
    true."""
    boxes, scores = _nms_case(kind, seed=11)
    kj, vj = jops.nms_serial(jnp.asarray(boxes), jnp.asarray(scores),
                             iou_thr=0.5, max_out=max_out,
                             use_pallas=use_pallas)
    kj, vj = np.array(kj), np.array(vj)
    tb, ts = torch.from_numpy(boxes), torch.from_numpy(scores)
    for fn in (ops.nms_serial, ops.nms):
        kt, vt = fn(tb, ts, iou_thr=0.5, max_out=max_out)
        assert kt.dtype == torch.int32 and vt.dtype == torch.bool
        np.testing.assert_array_equal(kt.numpy(), kj)
        np.testing.assert_array_equal(vt.numpy(), vj)
    if max_out == 5:
        assert vj.all()
    kr, vr = tref.nms_ref(tb, ts, 0.5, max_out)
    np.testing.assert_array_equal(kr.numpy(), kj)
    np.testing.assert_array_equal(vr.numpy(), vj)


def test_nms_serial_few_survivors_leave_zero_slots():
    """Fewer survivors than max_out: unused slots hold 0 and are not
    valid; a single box and identical boxes keep exactly one."""
    boxes = np.tile(np.float32([[0.1, 0.1, 0.4, 0.4]]), (6, 1))
    boxes[5] = [0.6, 0.6, 0.9, 0.9]
    scores = np.float32([0.2, 0.9, 0.9, 0.5, 0.1, 0.3])
    kt, vt = ops.nms_serial(torch.from_numpy(boxes),
                            torch.from_numpy(scores), max_out=8)
    kj, vj = jops.nms_serial(jnp.asarray(boxes), jnp.asarray(scores),
                             max_out=8)
    np.testing.assert_array_equal(kt.numpy(), np.array(kj))
    np.testing.assert_array_equal(vt.numpy(), np.array(vj))
    assert kt.tolist() == [1, 5, 0, 0, 0, 0, 0, 0]
    assert vt.tolist() == [True, True] + [False] * 6
    k1, v1 = ops.nms_serial(torch.from_numpy(boxes[:1]),
                            torch.from_numpy(scores[:1]), max_out=3)
    assert k1.tolist() == [0, 0, 0] and v1.tolist() == [True, False, False]
