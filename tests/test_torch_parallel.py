"""The paper's parallel-detection pipeline in the port
(``repro_torch.core.parallel``, ``repro_torch.tracking.interpolate``)
against the JAX package, on the CPU.

* ``n_range`` / ``choose_n`` equal the reference on the paper's worked
  examples and on any rates (hypothesis).
* ``ParallelDetector(...).run()`` gives the reference's ``Report`` for
  n = 1, 3, 7 on ETH-Sunnyday: with ``track=False`` every field exact
  (the pipeline is the same pure Python); with ``track=True`` the
  tracker runs on the port's tensors, so ``track_coverage`` and
  ``id_switches`` stay exact and ``map_tracked`` is held within 1e-6.
* ``fill_stream`` equals the reference frame for frame: index,
  ``interpolated`` and ``track_ids`` exact; boxes and scores within
  the interpolated tolerance (rtol 1e-5, atol 1e-4: XLA fuses the
  float32 Kalman arithmetic, PyTorch runs it op by op).
* Tracked mAP beats stale reuse for n = 1 and 3, as in
  ``tests/test_tracking.py``.
"""
import math
from dataclasses import fields

import numpy as np
import pytest

from repro.core import parallel as jpar
from repro.core import simulate as jsimulate
from repro.core.stream import FrameStream as JStream
from repro.tracking import fill_stream as jfill
from repro_torch.core import (FrameStream, ParallelDetector, Report,
                              SequenceSynchronizer, choose_n,
                              evaluate_map, evaluate_map_dets, n_range,
                              simulate, track_quality)
from repro_torch.core import parallel as tpar
from repro_torch.tracking import TrackedFrame, fill_stream

try:
    from hypothesis import given, settings
    from hypothesis import strategies as st
except ImportError:                     # pragma: no cover
    given = None

INTERP_RTOL, INTERP_ATOL = 1e-5, 1e-4
MAP_ATOL = 1e-6


# ------------------------------------------------------ n-selection
def test_n_range_matches_paper_examples():
    for lam, mu, want in ((14, 2.5, (4, 6)), (30, 2.3, (5, 14)),
                          (30, 2.5, (4, 12)), (10, 2.5, (4, 4))):
        assert n_range(lam, mu) == want == jpar.n_range(lam, mu)
    for mode in ("near_real_time", "conservative"):
        assert choose_n(14, 2.5, mode) == jpar.choose_n(14, 2.5, mode)
    assert choose_n(14, 2.5) == 4
    assert choose_n(14, 2.5, "conservative") == 6
    assert tpar.HUMAN_COMFORT_FPS == jpar.HUMAN_COMFORT_FPS


@pytest.mark.parametrize("lam,mu", [(0.5, 0.1), (12.0, 3.0), (12.5, 3.0),
                                    (60.0, 0.7), (14.0, 14.0)])
def test_n_range_matches_reference_at_fixed_rates(lam, mu):
    assert n_range(lam, mu) == jpar.n_range(lam, mu)
    for mode in ("near_real_time", "conservative"):
        assert choose_n(lam, mu, mode) == jpar.choose_n(lam, mu, mode)


if given is not None:
    @settings(max_examples=60, deadline=None)
    @given(lam=st.floats(0.1, 120.0), mu=st.floats(0.05, 60.0),
           mode=st.sampled_from(["near_real_time", "conservative"]))
    def test_n_range_matches_reference_property(lam, mu, mode):
        lo, hi = n_range(lam, mu)
        assert (lo, hi) == jpar.n_range(lam, mu)
        assert 1 <= lo <= hi
        assert choose_n(lam, mu, mode) == jpar.choose_n(lam, mu, mode)


# --------------------------------------------------------- reports
def _reports(n, track):
    kw = dict(video="ETH-Sunnyday", model="yolov3", devices=["ncs2"] * n)
    base = jpar.ParallelDetector(**kw).run(track=track)
    port = ParallelDetector(device="cpu", **kw).run(track=track)
    return base, port


def _same(a, b):
    return a == b or (isinstance(a, float) and math.isnan(a)
                      and math.isnan(b))


@pytest.mark.parametrize("n", [1, 3, 7])
def test_report_equals_reference_untracked(n):
    base, port = _reports(n, track=False)
    assert isinstance(port, Report)
    for f in fields(jpar.Report):
        assert _same(getattr(base, f.name), getattr(port, f.name)), f.name
    assert port.row() == base.row()


@pytest.mark.parametrize("n", [1, 3, 7])
def test_report_matches_reference_tracked(n):
    base, port = _reports(n, track=True)
    for f in fields(jpar.Report):
        a, b = getattr(base, f.name), getattr(port, f.name)
        if f.name == "map_tracked":
            assert abs(a - b) <= MAP_ATOL, (a, b)
        else:
            assert _same(a, b), f.name
    assert 0.0 < port.track_coverage <= 1.0
    # with drops the tracker beats stale reuse; n = 7 drops nothing
    assert port.map_tracked > port.map_score if port.drop_rate else \
        port.map_tracked == port.map_score


def test_offline_report_equals_reference():
    kw = dict(video="ETH-Sunnyday", model="yolov3", devices=["ncs2"] * 2)
    base = jpar.ParallelDetector(**kw).run(offline=True)
    port = ParallelDetector(device="cpu", **kw).run(offline=True)
    for f in fields(jpar.Report):
        assert _same(getattr(base, f.name), getattr(port, f.name)), f.name


# ------------------------------------------------------ fill_stream
@pytest.mark.parametrize("n", [1, 3])
def test_fill_stream_matches_reference(n):
    jdet = jpar.ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"] * n)
    tdet = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"] * n,
                            device="cpu")
    jpaced = jsimulate(JStream(jdet.video), jdet.scheduler)
    tpaced = simulate(FrameStream(tdet.video), tdet.scheduler)
    base = jfill(jdet.video, jpaced, jdet.detector)
    port = fill_stream(tdet.video, tpaced, tdet.detector, device="cpu")
    assert len(port) == len(base) == tpaced.n_frames
    assert sum(t.interpolated for t in port) > 0
    for a, b in zip(base, port):
        assert isinstance(b, TrackedFrame)
        assert (a.index, a.interpolated) == (b.index, b.interpolated)
        np.testing.assert_array_equal(b.track_ids, a.track_ids,
                                      err_msg=f"frame {a.index}")
        np.testing.assert_array_equal(b.classes, a.classes,
                                      err_msg=f"frame {a.index}")
        for name in ("boxes", "scores"):
            np.testing.assert_allclose(
                getattr(b, name), getattr(a, name), rtol=INTERP_RTOL,
                atol=INTERP_ATOL, err_msg=f"frame {a.index} {name}")


@pytest.mark.parametrize("n", [1, 3])
def test_interpolated_map_beats_stale_reuse(n):
    det = ParallelDetector("ETH-Sunnyday", "yolov3", ["ncs2"] * n,
                           device="cpu")
    paced = simulate(FrameStream(det.video), det.scheduler)
    synced = SequenceSynchronizer().order(paced)
    stale = evaluate_map(det.video, synced, det.detector)
    tracked = fill_stream(det.video, paced, det.detector, device="cpu")
    assert [t.index for t in tracked] == list(range(paced.n_frames))
    tmap = evaluate_map_dets(det.video, tracked)
    assert tmap > stale, (n, tmap, stale)
    tq = track_quality(det.video, tracked)
    assert tq["coverage"] > 0.8
    assert tq["id_switches"] < 40
