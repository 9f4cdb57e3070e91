"""Two properties of the port that hold whatever the process around it
does, on the CPU:

* TF32 stays out of the port's float32 convolutions and matrix
  products: with PyTorch's process-wide TF32 switches turned on (the
  legacy ``allow_tf32`` flags and the per-operation ``fp32_precision``
  ones), every ``conv2d`` of ``ssd_forward`` and every product of the
  attention plain versions runs with IEEE float32 in force, and the
  switches are as they were afterwards;
* batch-size invariance: the same frames served with ``micro_batch`` 1
  and 5 give the same ``valid`` masks, classes, keep order and track
  ids, and boxes and scores within ``BATCH_ATOL`` (the convolutions sum
  in another order for another batch size; 1.2e-7 measured).  The
  reference's own property test compares the floats exactly and fails
  on that; this is the port's version of the property, not a copy of
  that test."""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch.core.stream import BENCHMARK_VIDEOS, SyntheticVideo
from repro_torch.detector import SSDConfig, init_ssd, ssd_forward
from repro_torch.device import ieee_float32
from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.obs import TraceRecorder
from repro_torch.serving import DetectionEngine, FrameRequest, \
    make_nvr_streams

BATCH_ATOL = 1e-6
NEW_API = hasattr(torch.backends.cudnn, "conv")


def _settings():
    """(cudnn legacy, conv precision, matmul legacy, matmul precision);
    None where this torch lacks the control or the legacy flag cannot be
    read (it disagrees with the per-operation one)."""
    def read(obj, attr):
        try:
            return getattr(obj, attr)
        except (AttributeError, RuntimeError):
            return None
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    return (read(cudnn, "allow_tf32"),
            read(getattr(cudnn, "conv", None), "fp32_precision"),
            read(matmul, "allow_tf32"), read(matmul, "fp32_precision"))


def _tf32_on(monkeypatch, how):
    """Turn TF32 on process-wide, through the legacy flags or through
    the per-operation precisions; monkeypatch restores both."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    if NEW_API:     # registered first, so restored last, exactly
        for op in (cudnn.conv, cudnn.rnn, matmul):
            monkeypatch.setattr(op, "fp32_precision", op.fp32_precision)
    if how == "legacy":
        monkeypatch.setattr(cudnn, "allow_tf32", True)
        monkeypatch.setattr(matmul, "allow_tf32", True)
    else:
        if not NEW_API:
            pytest.fail("per-operation precision needs torch >= 2.9")
        monkeypatch.setattr(cudnn.conv, "fp32_precision", "tf32")
        monkeypatch.setattr(matmul, "fp32_precision", "tf32")


def _ieee(settings):
    cudnn_legacy, conv, mm_legacy, mm = settings
    return (cudnn_legacy in (False, None) and conv in ("ieee", None)
            and mm_legacy in (False, None) and mm in ("ieee", None))


@pytest.mark.parametrize("how", ["legacy", "per-operation"])
def test_ssd_convs_run_in_ieee_float32(monkeypatch, how):
    _tf32_on(monkeypatch, how)
    before = _settings()
    seen = []
    conv2d = F.conv2d

    def recording(*a, **k):
        seen.append(_settings())
        return conv2d(*a, **k)

    monkeypatch.setattr(F, "conv2d", recording)
    cfg = SSDConfig()
    params = init_ssd(cfg, torch.Generator().manual_seed(0), device="cpu")
    imgs = torch.from_numpy(np.random.default_rng(0).random(
        (2, 64, 64, 3)).astype(np.float32))
    ssd_forward(params, cfg, imgs)
    assert len(seen) == len(cfg.channels) + 2
    assert all(_ieee(s) for s in seen), seen
    if NEW_API:
        assert all(s[1] == "ieee" for s in seen), seen
    assert _settings() == before


@pytest.mark.parametrize("how", ["legacy", "per-operation"])
def test_attention_plain_products_run_in_ieee_float32(monkeypatch, how):
    _tf32_on(monkeypatch, how)
    before = _settings()
    seen = []
    einsum = torch.einsum

    def recording(*a, **k):
        seen.append(_settings())
        return einsum(*a, **k)

    monkeypatch.setattr(torch, "einsum", recording)
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn((1, 2, 128, 16), generator=g) for _ in range(3))
    flash_attention_torch(q, k, v)
    decode_attention_torch(q[:, :, 0], k.transpose(1, 2), v.transpose(1, 2))
    assert len(seen) == 4 and all(_ieee(s) for s in seen), seen
    if NEW_API:
        assert all(s[3] == "ieee" for s in seen), seen
    assert _settings() == before


def test_ieee_float32_restores_what_it_changed():
    """Nested and repeated use leaves the switches as found, and does
    not touch cuDNN's ``enabled``/``benchmark`` flags (which
    ``torch.backends.cudnn.flags`` would)."""
    before = _settings()
    flags = (torch.backends.cudnn.enabled, torch.backends.cudnn.benchmark)
    with ieee_float32():
        inside = _settings()
        with ieee_float32():
            assert _settings() == inside
        assert _settings() == inside
        assert (torch.backends.cudnn.enabled,
                torch.backends.cudnn.benchmark) == flags
    assert _ieee(inside) and _settings() == before


def _frames(n_cams, n_frames, rate):
    frames, frame_of, _, _ = make_nvr_streams(n_cams, n_frames, rate)
    vids = [SyntheticVideo(v) for v in BENCHMARK_VIDEOS.values()]
    return [FrameRequest(f.rid, vids[frame_of[f.rid][0] % len(vids)].pixels(
        frame_of[f.rid][1]), f.t_arrival, stream_id=frame_of[f.rid][0])
        for f in frames]


@pytest.mark.parametrize("n_cams,n_frames", [(1, 5), (2, 10)])
def test_micro_batch_size_keeps_every_discrete_output(n_cams, n_frames):
    frames = _frames(n_cams, n_frames, rate=50.0)
    cfg = SSDConfig()
    params = init_ssd(cfg, torch.Generator().manual_seed(0), device="cpu")
    reps = {}
    for mb in (1, 5):
        rec = TraceRecorder()
        reps[mb] = DetectionEngine(
            cfg=cfg, params=params, n_replicas=2, micro_batch=mb,
            service_time=0.001, track_and_interpolate=True, recorder=rec,
            device="cpu").serve(frames)
        stages = [e for e in rec.events if e["kind"] == "stage"
                  and e["stage"] == "detect"]
        assert len(stages) == len(frames) // mb     # batches of mb frames
    worst = 0.0
    a_resp, b_resp = reps[1]["responses"], reps[5]["responses"]
    assert len(a_resp) == len(b_resp) == len(frames)
    for a, b in zip(a_resp, b_resp):
        for f in ("rid", "interpolated", "stream_id", "seq"):
            assert getattr(a, f) == getattr(b, f), f
        for f in ("valid", "classes", "track_ids"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), (a.rid, f)
        # slot by slot: the same boxes in the same keep order
        for f in ("boxes", "scores"):
            worst = max(worst, float(np.abs(getattr(a, f) -
                                            getattr(b, f)).max()))
    assert sum(int(r.valid.sum()) for r in a_resp) > 0
    assert worst <= BATCH_ATOL, worst
