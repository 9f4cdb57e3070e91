"""The port's sharded NVR serving (``repro_torch.serving.sharded``,
``repro_torch.sharding``) against the JAX package, on the CPU.

* The camera partition and the work-stealing rule: ``shard_streams``,
  ``streams_of_shard`` and ``rebalance_streams`` give the reference's
  answers on the reference tests' cases and on random observations.
* Oracle path (numpy proxy detector, pinned service time): the port's
  ``ShardedDetectionEngine`` report equals the reference's key for key
  (``assert_reports_match``: schedule, drops, per-stream maps, latency
  block, track ids exact; only the Kalman floats of ``interpolated``
  responses within rtol 1e-5 + atol 1e-4) under static sharding with 1,
  2 and 4 shards, under rebalancing on the skewed trace (migrations
  equal), through the incremental runtime (rolling reports, chunked
  ingest, ``drain`` after epoch boundaries), and ``n_shards=1`` equals
  ``DetectionEngine``.
* Mini-SSD path with the reference's weights: ``make_spmd_detect`` on a
  one-device mesh (``("cpu",)``) against the reference's on
  ``make_serving_mesh(1)``, discrete fields exact, boxes and scores
  within the forward tolerance 1e-4; mesh equals meshless bit for bit;
  the two-block split on ``("cpu", "cpu")`` keeps every discrete field
  of the one-device result and its floats within 1e-6 (convs of another
  batch size sum in another order, as in ``test_torch_repairs.py``).
* The fused tick under sharding: a rebalancing serve with the
  CUDA-graph holder stood in equals the serve whose ticks run the staged
  chain of the ``tracking`` functions, the shards' equal-shaped segments
  sharing one graph.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import proxy_detect_fn_streams as jproxy
from repro.detector import ssd as jssd
from repro.serving import DetectionEngine as JEngine
from repro.serving import FrameRequest as JFrame
from repro.serving import ServingRuntime as JRuntime
from repro.serving import ShardedDetectionEngine as JSharded
from repro.serving import make_nvr_streams as jstreams
from repro.serving import make_skewed_streams as jskewed
from repro.serving import merge_shard_reports as jmerge
from repro.sharding import serving_rules as jrules
from repro_torch.core import proxy_detect_fn_streams as tproxy
from repro_torch.detector import ssd as tssd
from repro_torch.kernels import ops
from repro_torch.serving import DetectionEngine as TEngine
from repro_torch.serving import FrameRequest as TFrame
from repro_torch.serving import ServingRuntime as TRuntime
from repro_torch.serving import ShardedDetectionEngine as TSharded
from repro_torch.serving import make_nvr_streams as tstreams
from repro_torch.serving import make_skewed_streams as tskewed
from repro_torch.serving import make_spmd_detect
from repro_torch.serving import merge_shard_reports as tmerge
from repro_torch.serving import pipeline as tpipe
from repro_torch.sharding import serving_rules as trules
from test_torch_pipeline import serve
from test_torch_pipeline import stand_in  # noqa: F401  (fixture)
from test_torch_serving import _pixel_frames, assert_reports_match

FORWARD_ATOL = 1e-4      # the mini-SSD forward, port vs reference
BLOCK_ATOL = 1e-6        # convs of another batch size (a mesh block)
SKEW_KW = dict(n_frames=12, rate=1.0)
MODE_KW = {"drop": {"drop_when_busy": True},
           "track": {"track_and_interpolate": True}}


# ------------------------------------------------- partition and policy
def test_shard_streams_matches_reference():
    rng = np.random.default_rng(0)
    for n_ids in (0, 1, 5, 7, 12):
        sids = [int(s) for s in rng.choice(100, n_ids, replace=False)]
        for n in (1, 2, 3, 4, 7):
            part = trules.shard_streams(sids, n)
            assert part == jrules.shard_streams(sids, n)
            assert part == trules.shard_streams(reversed(sids), n)
            for h in range(n):
                assert trules.streams_of_shard(part, h) == \
                    jrules.streams_of_shard(part, h)
    with pytest.raises(ValueError):
        trules.shard_streams([1, 2], 0)


REBALANCE_CASES = [
    # the reference tests' cases: a 2x-loaded donor, a balanced pair, a
    # single hot stream (rule 3 refuses), and evacuations
    ({0: 0, 2: 0, 4: 0, 1: 1, 3: 1, 5: 1},
     [{"drops": 7, "backlog_s": 2.5, "frames": {0: 16, 2: 16, 4: 16}},
      {"drops": 0, "backlog_s": 0.0, "frames": {1: 8, 3: 8, 5: 8}}],
     {}),
    ({0: 0, 2: 0, 1: 1, 3: 1},
     [{"drops": 0, "backlog_s": 0.0, "frames": {0: 8, 2: 8}},
      {"drops": 0, "backlog_s": 0.0, "frames": {1: 8, 3: 8}}], {}),
    ({0: 0, 1: 1},
     [{"drops": 9, "backlog_s": 4.0, "frames": {0: 32}},
      {"drops": 0, "backlog_s": 0.0, "frames": {1: 8}}], {}),
    ({0: 0, 1: 1, 2: 2, 3: 0, 4: 1, 5: 2},
     [{"drops": 3, "backlog_s": 1.0, "frames": {0: 5, 3: 9}},
      {"drops": 0, "backlog_s": 0.0, "frames": {1: 4, 4: 4}},
      {"drops": 1, "backlog_s": 0.5, "frames": {2: 2, 5: 7}}],
     {"evacuate": (0,), "max_moves": 2}),
]


@pytest.mark.parametrize("case", range(len(REBALANCE_CASES)))
def test_rebalance_streams_matches_reference(case):
    of, loads, kw = REBALANCE_CASES[case]
    assert trules.rebalance_streams(of, loads, **kw) == \
        jrules.rebalance_streams(of, loads, **kw)


def test_rebalance_streams_matches_reference_on_random_loads():
    rng = np.random.default_rng(1)
    for _ in range(200):
        n = int(rng.integers(2, 5))
        of = {s: int(rng.integers(n)) for s in range(int(rng.integers(1, 9)))}
        loads = [{"drops": int(rng.integers(0, 3)),
                  "backlog_s": float(rng.choice([0.0, 0.5, 1.0])),
                  "frames": {s: int(rng.integers(0, 9))
                             for s, h in of.items() if h == hh}}
                 for hh in range(n)]
        kw = {"max_moves": int(rng.integers(1, 3))}
        if rng.random() < 0.3:
            kw["evacuate"] = (int(rng.integers(n)),)
        assert trules.rebalance_streams(of, loads, **kw) == \
            jrules.rebalance_streams(of, loads, **kw)
    with pytest.raises(ValueError):
        trules.rebalance_streams({0: 0}, [{"drops": 0, "backlog_s": 0.0,
                                           "frames": {}}], evacuate=(0,))


def test_frame_blocks_and_placement():
    """Contiguous blocks when the mesh divides the batch, the whole batch
    on the first device otherwise; detections gather in block order."""
    assert trules.frame_blocks(8, 4) == [(0, 2), (2, 4), (4, 6), (6, 8)]
    assert trules.frame_blocks(6, 4) == [(0, 6)]
    assert trules.frame_blocks(5, 1) == [(0, 5)]
    imgs = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3)
    blocks = trules.constrain_frames(imgs, ("cpu", "cpu"))
    assert [b.shape[0] for b in blocks] == [4, 4]
    back = trules.constrain_detections([(b, b[:, 0]) for b in blocks])
    assert torch.equal(back[0], imgs) and torch.equal(back[1], imgs[:, 0])
    assert len(trules.constrain_frames(imgs[:6], ("cpu",) * 4)) == 1
    with pytest.raises(ValueError):
        trules.mesh_devices(())


def test_skewed_streams_match_reference():
    a = jskewed(6, n_shards=2, **SKEW_KW)
    b = tskewed(6, n_shards=2, **SKEW_KW)
    assert [(f.rid, f.t_arrival, f.stream_id) for f in a[0]] == \
        [(f.rid, f.t_arrival, f.stream_id) for f in b[0]]
    assert a[1] == b[1]


# ------------------------------------------------------ oracle serving
def oracle_pair(make_j, make_t, *args, **kw):
    """The same trace through both packages' stream builders, with each
    package's proxy detector oracle."""
    fj, foj, vj, dj = make_j(*args, **kw)
    ft, fot, vt, dt = make_t(*args, **kw)
    return (fj, jproxy(vj, dj, foj)), (ft, tproxy(vt, dt, fot))


def serve_both(make, args, mkw, **kw):
    (fj, oj), (ft, ot) = oracle_pair(*make, *args, **mkw)
    base = JSharded(detect_fn=oj, **kw).serve(fj)
    port = TSharded(detect_fn=ot, device="cpu", **kw).serve(ft)
    return base, port


NVR = (jstreams, tstreams)
SKEWED = (jskewed, tskewed)


@pytest.mark.parametrize("mode", ["drop", "track"])
@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_static_sharding_matches_reference(n_shards, mode):
    base, port = serve_both(NVR, (5, 12), {"rate": 4.0}, n_shards=n_shards,
                            n_replicas=2, service_time=0.4,
                            **MODE_KW[mode])
    assert base["dropped"]                          # the drop regime
    assert port["n_shards"] == n_shards
    assert_reports_match(base, port)


@pytest.mark.parametrize("mode", ["drop", "track"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_rebalancing_matches_reference(n_shards, mode):
    base, port = serve_both(SKEWED, (3 * n_shards,),
                            dict(n_shards=n_shards, **SKEW_KW),
                            n_shards=n_shards, n_replicas=2,
                            service_time=0.36, rebalance=True, epoch_s=4.0,
                            **MODE_KW[mode])
    assert base["migrations"]
    assert port["migrations"] == base["migrations"]
    assert_reports_match(base, port)


def test_single_shard_identical_to_detection_engine():
    f, fo, v, d = tstreams(3, 16, rate=2.0)
    kw = dict(detect_fn=tproxy(v, d, fo), n_replicas=2, service_time=0.4,
              track_and_interpolate=True, device="cpu")
    base = TEngine(**kw).serve(f)
    sh = TSharded(n_shards=1, **kw).serve(f)
    assert set(base) < set(sh)
    assert_reports_match(base, {k: sh[k] for k in base})
    assert sh["shard_of_stream"] == {0: 0, 1: 0, 2: 0}
    again = TSharded(n_shards=1, rebalance=True, epoch_s=1.0,
                     **kw).serve(f)
    assert "migrations" not in again
    assert_reports_match(base, {k: again[k] for k in base})


def test_merge_shard_reports_matches_reference_and_copies():
    (fj, oj), (ft, ot) = oracle_pair(*NVR, 4, 10, rate=3.0)
    reps = []
    for frames, oracle, Engine, rules, kw in (
            (fj, oj, JEngine, jrules, {}),
            (ft, ot, TEngine, trules, {"device": "cpu"})):
        part = rules.shard_streams(range(4), 2)
        subs = [[f for f in frames if part[f.stream_id] == h]
                for h in range(2)]
        reps.append([Engine(detect_fn=oracle, n_replicas=1,
                            service_time=0.2, drop_when_busy=True,
                            **kw).serve(s) for s in subs])
    base, port = jmerge(fj, reps[0], [1, 1]), tmerge(ft, reps[1], [1, 1])
    assert_reports_match(base, port)
    assert all(r.replica in (-1, 0) for rep in reps[1]
               for r in rep["responses"])          # the inputs untouched
    by_rid = {r.rid: r for r in port["responses"]}
    assert all(r is by_rid[r.rid] for rs in port["streams"].values()
               for r in rs)


def test_empty_trace_and_argument_errors():
    f, fo, v, d = tstreams(1, 1, rate=1.0)
    eng = TSharded(n_shards=2, detect_fn=tproxy(v, d, fo), n_replicas=1,
                   service_time=0.1, device="cpu")
    out = eng.serve([])
    assert out["responses"] == [] and out["coverage"] == 0.0
    assert set(out["per_replica"]) == {0, 1}
    with pytest.raises(ValueError):
        TSharded(mesh=("cpu",), detect_fn=lambda i, r: None, device="cpu")
    with pytest.raises(ValueError):
        TSharded(n_shards=0, device="cpu")


# ------------------------------------------------ incremental runtime
def runtimes(n_shards, rebalance, mode="track"):
    (fj, oj), (ft, ot) = oracle_pair(*SKEWED, 3 * n_shards,
                                     n_shards=n_shards, **SKEW_KW)
    kw = dict(n_shards=n_shards, n_replicas=2, service_time=0.36,
              rebalance=rebalance, epoch_s=4.0, **MODE_KW[mode])
    streams = range(3 * n_shards)
    return ((fj, JRuntime(JSharded(detect_fn=oj, **kw), streams=streams)),
            (ft, TRuntime(TSharded(detect_fn=ot, device="cpu", **kw),
                          streams=streams)))


@pytest.mark.parametrize("rebalance", [False, True])
def test_rolling_reports_and_drain_match_reference(rebalance):
    """Chunked ingest with ``advance`` and two explicit epoch boundaries:
    every rolling view and the drained report equal the reference's."""
    out = []
    for frames, rt in runtimes(2, rebalance):
        views = []
        for i in range(0, len(frames), 9):
            rt.ingest(frames[i:i + 9])
            rt.advance()
            if i in (27, 54):
                views.append(rt.epoch_boundary())
            views.append(rt.report(rolling=True))
        views.append(rt.report(rolling=False))
        out.append((views, rt.drain()))
    (jviews, jrep), (tviews, trep) = out
    # a sharded runtime's views are volume/latency rollups: plain data
    assert jviews == tviews and any(v for v in tviews)
    assert_reports_match(jrep, trep)


@pytest.mark.parametrize("rebalance", [False, True])
def test_chunked_ingest_equals_one_shot(rebalance):
    (_, _), (frames, rt) = runtimes(2, rebalance)
    for i in range(0, len(frames), 7):
        rt.ingest(frames[i:i + 7])
        rt.advance()
    chunked = rt.drain()
    f, fo, v, d = tskewed(6, n_shards=2, **SKEW_KW)
    one = TSharded(detect_fn=tproxy(v, d, fo), n_shards=2, n_replicas=2,
                   service_time=0.36, rebalance=rebalance, epoch_s=4.0,
                   track_and_interpolate=True, device="cpu").serve(f)
    assert_reports_match(one, chunked)


# ------------------------------------------------------ mini-SSD path
@pytest.fixture(scope="module")
def weights():
    params = jssd.init_ssd(jssd.SSDConfig(), jax.random.PRNGKey(0))
    return params, jax.tree.map(lambda a: np.array(a), params)


def _random_frames(Frame, n=8):
    rng = np.random.default_rng(3)
    return [Frame(i, rng.random((64, 64, 3)).astype(np.float32), i / 20.0,
                  stream_id=i % 2) for i in range(n)]


def test_spmd_detect_one_device_matches_reference(weights):
    from repro.launch.mesh import make_serving_mesh
    params, tree = weights
    kw = dict(n_replicas=2, service_time=0.05)
    base = JSharded(n_shards=1, mesh=make_serving_mesh(1), params=params,
                    **kw).serve(_random_frames(JFrame))
    tparams = tssd.params_from_numpy(tree, device="cpu")
    port = TSharded(n_shards=1, mesh=("cpu",), params=tparams, device="cpu",
                    **kw).serve(_random_frames(TFrame))
    meshless = TSharded(n_shards=1, params=tparams, device="cpu",
                        **kw).serve(_random_frames(TFrame))
    assert_reports_match(base, port, float_atol=FORWARD_ATOL)
    assert_reports_match(meshless, port)                 # bit for bit


def test_mesh_block_split_equals_one_device(weights):
    """Batches of 8 split into two blocks of 4 on ``("cpu", "cpu")``;
    a batch of 1 stays whole (the divisibility fallback)."""
    _, tree = weights
    cfg = tssd.SSDConfig()
    tparams = tssd.params_from_numpy(tree, device="cpu")
    one = make_spmd_detect(cfg, tparams, ("cpu",))
    two = make_spmd_detect(cfg, tparams, ("cpu", "cpu"))
    imgs = np.stack([f.image for f in _pixel_frames(TFrame, 4, 2, 8.0)])
    for batch in (imgs, imgs[:1]):
        a, b = one(batch), two(batch)
        for x, y, name in zip(a, b, ("boxes", "scores", "classes", "valid")):
            assert x.shape == y.shape and x.dtype == y.dtype, name
            if name in ("classes", "valid"):
                assert np.array_equal(x, y), name
            else:
                np.testing.assert_allclose(y, x, rtol=0, atol=BLOCK_ATOL,
                                           err_msg=name)
    kw = dict(cfg=cfg, params=tparams, n_shards=2, n_replicas=2,
              micro_batch=4, service_time=0.05, track_and_interpolate=True,
              device="cpu")
    frames = _pixel_frames(TFrame, 4, 4, 8.0)
    a = TSharded(mesh=("cpu",), **kw).serve(frames)
    b = TSharded(mesh=("cpu", "cpu"), **kw).serve(frames)
    assert_reports_match(a, b, float_atol=BLOCK_ATOL)


def test_meshless_shards_share_one_detector(weights):
    _, tree = weights
    eng = TSharded(n_shards=3, params=tssd.params_from_numpy(
        tree, device="cpu"), device="cpu")
    assert all(e._infer is eng.engines[0]._infer for e in eng.engines)
    assert all(e.params["head8"]["w"] is eng.engines[0].params["head8"]["w"]
               for e in eng.engines)


# ------------------------------------------------ fused tick, sharded
def test_fused_sharded_rebalance_equals_staged(monkeypatch, stand_in):
    """Both shards' segments have the same (B, D), so they replay one
    graph in turns, each from its own carried rows; the report equals
    the staged chain's exactly and every graph replay counted its
    launch."""
    monkeypatch.setattr(tpipe, "_fused", tpipe.graph_ticks)
    reps = {}
    for fused in (False, True):
        ops.reset_launches()
        f, fo, v, d = tskewed(6, n_shards=2, **SKEW_KW)
        reps[fused] = serve(TSharded(
            detect_fn=tproxy(v, d, fo), n_shards=2, n_replicas=2,
            service_time=0.36, rebalance=True, epoch_s=4.0,
            track_and_interpolate=True, device="cpu"), f, staged=not fused)
    assert reps[True]["migrations"]
    assert_reports_match(reps[False], reps[True])
    graphs = tpipe.tick_graphs()
    assert len(stand_in) == len(graphs) >= 1
    assert sum(g.replays for g in graphs) == reps[True]["tracker_launches"]
    launches = ops.launches()["greedy_assign"]
    assert launches == sum((1 + g.replays) * g.captured["greedy_assign"]
                           for g in graphs)
