"""CPU tests of the benchmark's yardstick: traffic, schedules, counts,
statistics, references, the import rule, the controls and the planted
faults.  Small sizes, the plain kernels; the chip is never looked for."""
import ast
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from bench import cost, harness, proxy, traffic
from bench.reference import detector as ref_det
from bench.reference import llm as ref_llm
from bench.reference import tracker as ref_trk
from bench.systems import llm as sys_llm
from bench.systems import nvr as sys_nvr

BENCH = Path(__file__).resolve().parent
CPU = torch.device("cpu")


def _cell(name):
    return harness.cell_of(name)


# ------------------------------------------------------------- traffic
def test_camera_traffic_is_a_function_of_the_seed():
    _, _, cfg, mix = _cell("nvr16-detect")
    a = traffic.Cameras(mix, 2 ** 31 + 7, 64)
    b = traffic.Cameras(mix, 2 ** 31 + 7, 64)
    c = traffic.Cameras(mix, 5, 64)
    for k in (0, 1, 299, 300, 1234):
        ta, tb = a.tick(k), b.tick(k)
        assert [x[:3] for x in ta] == [x[:3] for x in tb]
        assert all(np.array_equal(x[3], y[3]) for x, y in zip(ta, tb))
        assert [x[:3] for x in ta] == [x[:3] for x in c.tick(k)]
    assert a.start != c.start
    assert np.array_equal(a.image(3, 7), a.image(3, 307))   # the pool loops
    rid, cam, t, _ = a.tick(9)[5]
    assert a.frame_of(rid) == (cam, 9) and t == (9 + 5 / 16) / 30.0


def test_request_traffic_keeps_its_sizes_across_seeds():
    _, _, _, mix = _cell("grok1-decode")
    a, b, c = (traffic.Requests(mix, s, 1000) for s in (11, 11, 12))
    n = mix["set_size"]
    ra = [a.next() for _ in range(2 * n)]
    rb = [b.next() for _ in range(2 * n)]
    rc = [c.next() for _ in range(2 * n)]
    assert all(np.array_equal(x[0], y[0]) and x[1] == y[1]
               for x, y in zip(ra, rb))
    assert [(len(t), o) for t, o in ra] != [(len(t), o) for t, o in rc]
    for rs in (ra, rc):            # each pass serves the whole set once
        for p in (rs[:n], rs[n:]):
            assert sorted((len(t), o) for t, o in p) == sorted(a.sizes)
    lo, hi = mix["prompt_len"]
    assert min(p for p, _ in a.sizes) >= lo
    assert max(p for p, _ in a.sizes) <= hi


# ----------------------------------------------------------- schedules
def _serve_epochs(name, epochs):
    _, _, cfg, mix = _cell(name)
    cams = traffic.Cameras(mix, 3, cfg["detector"]["image_size"])
    source = sys_nvr.make_source(cfg, cams, 3, CPU)
    engine = sys_nvr.make_engine(cfg, mix, source, CPU)
    feed = sys_nvr.Feed(cams, engine, mix)
    reps = [feed.epoch() for _ in range(epochs)]
    return mix, feed, reps


def test_detect_schedule_drops_nothing():
    mix, feed, reps = _serve_epochs("nvr16-detect", 3)
    assert all(r["dropped"] == [] for r in reps)
    assert sum(len(r["responses"]) for r in reps) == feed.k * 16
    assert not any(x.interpolated for r in reps for x in r["responses"])
    # random weights: NMS ends at max_out on every frame
    assert all(x.valid.sum() == 32 for r in reps for x in r["responses"])


def test_shed_schedule_detects_what_the_pool_sustains():
    """32 replicas x 0.4 s a frame: ~80 of 480 frames a video-second
    detected, every camera within ``max_coast`` ticks, so the tracker
    confirms tracks and every filled frame carries boxes."""
    mix, feed, reps = _serve_epochs("nvr16-shed", 30)
    _, _, cfg, _ = _cell("nvr16-shed")
    assert feed.k == 300
    frames = [x for r in reps for x in r["responses"]]
    detected = sorted(x.rid for x in frames if not x.interpolated)
    assert len(frames) == feed.k * 16
    assert len(detected) == mix["detected_in_first_300_ticks"]
    for cam in range(16):
        ks = [rid // 16 for rid in detected if rid % 16 == cam]
        assert ks[0] == 0
        assert np.diff(ks).max() <= cfg["tracker"]["max_coast"]
    filled = [x for x in frames if x.interpolated]
    assert len(filled) == len(frames) - len(detected)
    assert all(np.asarray(x.valid).any() for x in filled)


def test_proxy_detections_are_a_function_of_the_seed():
    _, _, cfg, mix = _cell("nvr16-shed")
    det, D = cfg["detector"], cfg["deployment"]["max_out"]
    cams = traffic.Cameras(mix, 2 ** 31 + 9, det["image_size"])
    a, b = (proxy.ProxyDetections(cams, det, 2 ** 31 + 9, D)
            for _ in range(2))
    c = proxy.ProxyDetections(cams, det, 4, D)
    rids = [0, 5, 16 * 299 + 15, 16 * 300 + 3, -1]
    for x, y in zip(a.rows(rids), b.rows(rids)):
        assert np.array_equal(x, y)
    assert not np.array_equal(a.rows(rids)[0], c.rows(rids)[0])
    boxes, scores, classes, valid = a.rows(rids)
    assert not valid[-1].any() and valid[:-1].any(-1).all()
    assert np.array_equal(boxes[3], a.rows([3])[0][0])   # the pool loops
    # pixel boxes of the camera's video, scores in the profile's ranges
    assert boxes[0][valid[0]].max() > 64
    assert ((scores[valid] > 0.1) & (scores[valid] < 0.99)).all()


# -------------------------------------------------------------- counts
def test_ssd_flops_match_the_counter():
    from repro_torch.cost import step_cost
    from repro_torch.detector import SSDConfig, ssd_forward
    _, _, cfg, _ = _cell("nvr16-detect")
    det = cfg["detector"]
    params = sys_nvr.make_params(det, cfg["weights"], 1, CPU)
    x = torch.zeros(2, det["image_size"], det["image_size"], 3)
    got = step_cost(ssd_forward, params, SSDConfig(), x)["flops"]
    assert got == 2 * cost.ssd_conv_flops(det) == 2 * 8257536


def test_llm_flops_match_the_counter_with_the_programs_extra_work():
    """The program's counted prefill = the needed FLOPs + the capacity
    slots beyond the routed pairs + the masked half of the scores + the
    logits of every prompt position but the last."""
    from repro_torch.cost import step_cost
    from repro_torch.runtime import make_prefill_step
    c = _smoke_config(layers=2)
    cfg = sys_llm.model_config(c)
    params = sys_llm.make_params(cfg, c, 1, CPU)
    T = 24
    toks = torch.arange(T)[None] % c["vocab_size"]
    got = step_cost(make_prefill_step(cfg), params, {"tokens": toks})
    need = cost.llm_request_flops(c, T, 1)
    d, f, E, k = (c["hidden_size"], c["intermediate_size"],
                  c["num_experts"], c["num_experts_per_tok"])
    C = ref_llm.capacity(T, k, E, c["capacity_factor"])
    slots = (E * C - T * k) * 2 * 3 * d * f
    scores = 4 * c["num_attention_heads"] * c["head_dim"] * (
        T * T - T * (T + 1) // 2)
    logits = (T - 1) * 2 * d * c["vocab_size"]
    assert got["flops"] == need + c["num_hidden_layers"] * (slots + scores) \
        + logits


def test_moe_least_time_is_bytes_bound_in_decode():
    _, _, c, _ = _cell("grok1-decode")
    two = 2 * 3 * 6144 * 32768 * 2 / cost.PEAKS["hbm_bytes_per_s"]
    assert cost.moe_least_time(c, 1, 2) == pytest.approx(two)
    big = 2.0 * 3 * 6144 * 32768 * 4096 * 2 / cost.PEAKS["bf16_flops_per_s"]
    assert cost.moe_least_time(c, 4096, 8) == pytest.approx(big)


def test_nms_iou_count_on_a_hand_case():
    boxes = np.float32([[0, 0, 1, 1], [0, 0, 1, 1.1], [2, 2, 3, 3],
                        [5, 5, 6, 6]])
    scores = np.float32([0.9, 0.8, 0.7, 0.1])
    # kept 0 (3 alive after it), kills 1; kept 2 (1 alive: the zero
    # score is alive but the greedy stops at no tile boundary here)
    assert cost.nms_iou_count(boxes, scores, 0.5, 0.4, 32) == 3 + 1


# ---------------------------------------------------------- statistics
def test_window_statistics():
    walls = np.arange(1, 101) / 1000.0
    assert harness.p95_ms(walls) == pytest.approx(95.05)
    assert harness.rate(300, 2.0) == 150.0


# ---------------------------------------------------------- references
def test_detector_reference_equals_the_port():
    from repro_torch.detector import SSDConfig, decode_detections, make_anchors
    _, _, cfg, mix = _cell("nvr16-detect")
    det, dep = cfg["detector"], cfg["deployment"]
    params = sys_nvr.make_params(det, cfg["weights"], 9, CPU)
    cams = traffic.Cameras(mix, 9, det["image_size"])
    imgs = torch.from_numpy(np.stack([cams.image(s, 4) for s in range(6)]))
    assert np.array_equal(ref_det.anchors(det), make_anchors(SSDConfig()))
    got = [t.numpy() for t in decode_detections(
        params, SSDConfig(), imgs, torch.from_numpy(make_anchors(SSDConfig())),
        score_thr=dep["score_thr"], iou_thr=dep["iou_thr"],
        max_out=dep["max_out"])]
    b, s, lg = (t.numpy() for t in ref_det.candidates(
        params, det, imgs, torch.from_numpy(ref_det.anchors(det))))
    for i in range(len(imgs)):
        want = ref_det.nms(b[i], s[i], lg[i].argmax(-1).astype(np.int32),
                           dep["score_thr"], dep["iou_thr"], dep["max_out"])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g[i], w, atol=1e-6)
        err, gap = ref_det.judge_frame([g[i] for g in got], (b[i], s[i],
                                       lg[i]), dep["score_thr"],
                                       dep["iou_thr"], dep["max_out"])
        assert err <= 1e-6 and gap == 0.0


def test_tracker_reference_equals_the_port_bit_for_bit():
    from repro_torch import tracking as trk
    _, _, cfg, _ = _cell("nvr16-detect")
    tc = trk.TrackerConfig(**cfg["tracker"])
    rng = np.random.default_rng(0)
    B, D = 3, 8
    state = trk.init_state(B, tc, device="cpu")
    ref = ref_trk.Tracker(B, cfg["tracker"])
    base = rng.uniform(0, 200, (D, 2)).astype(np.float32)
    for k in range(40):
        xy = base + k * 1.5 + rng.normal(0, 0.5, (B, D, 2)).astype(
            np.float32)
        boxes = np.concatenate([xy, xy + 20], -1).astype(np.float32)
        scores = rng.uniform(0, 1, (B, D)).astype(np.float32)
        classes = rng.integers(0, 2, (B, D)).astype(np.int32)
        valid = rng.uniform(size=(B, D)) < (0.0 if k % 7 == 3 else 0.8)
        state, tid = trk.step(state, torch.from_numpy(boxes),
                              torch.from_numpy(scores),
                              torch.from_numpy(classes),
                              torch.from_numpy(valid), tc)
        want = ref.tick(boxes, scores, classes, valid)
        assert np.array_equal(tid.numpy(), want)
        for g, w in zip(trk.output(state, tc), ref.output()):
            assert np.array_equal(g.numpy(), w)


def _smoke_config(layers=2):
    _, _, c, _ = _cell("grok1-decode")
    return dict(c, port_preset="smoke", hidden_size=256,
                intermediate_size=512, num_attention_heads=4,
                num_key_value_heads=2, head_dim=64, num_experts=4,
                vocab_size=512, dispatch="global", torch_dtype="float32",
                num_hidden_layers=layers)


def test_llm_reference_equals_the_port_at_smoke_size():
    from repro_torch.models import model_apply
    c = _smoke_config()
    cfg = sys_llm.model_config(c)
    params = sys_llm.make_params(cfg, c, 5, CPU)
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, c["vocab_size"], 40))
    with torch.no_grad():
        want, _, _ = model_apply(params, cfg, {"tokens": toks[None]},
                                 mode="train")
    got, rgap, used = ref_llm.Reference(params, c).forward(
        [(toks, 40, list(range(40)))])
    torch.testing.assert_close(got[0], want[0].float(), atol=2e-4,
                               rtol=1e-4)
    assert rgap == [0.0] and len(used[0]) == c["num_hidden_layers"]
    again, rgap, _ = ref_llm.Reference(params, c).forward(
        [(toks, 40, list(range(40)))], used)
    assert torch.equal(again[0], got[0]) and rgap == [0.0]


# ------------------------------------------------------------- imports
def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_bench_imports_neither_jax_nor_the_jax_package():
    for path in BENCH.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & {"jax", "jaxlib", "flax", "repro"}, path
        if path.parent.name == "reference":
            assert "repro_torch" not in tops, path
    assert harness.forbidden_modules() == sorted(
        {m.split(".")[0] for m in __import__("sys").modules}
        & {"jax", "jaxlib", "flax", "repro"})


def test_benchmark_finds_every_piece_by_name():
    spec = harness.spec()
    for w in spec["workloads"]:
        cell, entry, config, mix = harness.cell_of(w["name"], spec)
        assert (BENCH / "systems" / f"{config['system']}.py").is_file()
        assert config["name"] == entry["name"]
    for m in spec["per_layer"]:
        assert callable(harness.load_reader(m["name"]))
    json.dumps(spec)


# ---------------------------------------------- controls and faults
def _nvr_run(control=False):
    small = lambda m: dict(m, cameras=4, pool_frames=20, warmup_epochs=1,
                           sample_frames=64,
                           engine=dict(m["engine"],
                                       micro_batch=m["engine"]["micro_batch"]
                                       and 4))
    return harness.run_cell("nvr16-detect", 77, 0.3, False, "cpu",
                            time.perf_counter(), control=control,
                            mix_override=small)


def test_nvr_sound_run_is_correct_and_its_control_is_not():
    res = _nvr_run(control=True)
    assert res["correct"], res["compared"]
    cmp = res["compared"]
    assert cmp["control.det_err"][0] > cmp["det_err"][1] or \
        cmp["control.nms_gap"][0] > cmp["nms_gap"][1]


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch",
                                   "altered_answer"])
def test_nvr_faults_are_not_correct(monkeypatch, fault):
    from repro_torch import tracking
    from repro_torch.serving import engine as eng_mod
    if fault == "unchanged_state":
        def step(state, boxes, *rows_cfg):
            return state, torch.full(boxes.shape[:2], -1, dtype=torch.int32)
        monkeypatch.setattr(tracking, "step", step)
    else:
        real = eng_mod.DetectionEngine._detect_batch

        def broken(self, images, rids=None, **kw):
            (b, s, c, v), wall = real(self, images, rids=rids, **kw)
            b, s = b.copy(), s.copy()
            if fault == "half_batch":
                h = len(b) // 2
                b[h:], s[h:] = b[:h].mean(0), s[:h].mean(0)
            else:
                b[0, 0] += 0.05
            return (b, s, c, v), wall
        monkeypatch.setattr(eng_mod.DetectionEngine, "_detect_batch", broken)
    res = _nvr_run()
    assert not res["correct"], res["compared"]


def _shed_run(control=False):
    small = lambda m: dict(m, cameras=4, pool_frames=40, warmup_epochs=1)
    four = lambda c: dict(c, deployment=dict(c["deployment"], n_replicas=8))
    return harness.run_cell("nvr16-shed", 79, 0.5, False, "cpu",
                            time.perf_counter(), control=control,
                            config_override=four, mix_override=small)


def test_shed_sound_run_is_correct_and_its_control_is_not():
    res = _shed_run(control=True)
    assert res["correct"], res["compared"]
    cmp = res["compared"]
    assert res["counts"]["detected"] < res["attempted"]
    assert cmp["fill_empty_share"][0] < 0.05
    assert cmp["control.track_mismatch"][0] > cmp["track_mismatch"][1]


@pytest.mark.parametrize("fault", ["empty_fill", "shifted_fill",
                                   "unchanged_state", "altered_answer"])
def test_shed_faults_are_not_correct(monkeypatch, fault):
    """A fill that emits nothing, a filled box moved by a pixel, a
    tracker step that returns its state unchanged, a detection altered
    where it is served: each makes ``correct`` false."""
    from repro_torch import tracking
    from repro_torch.serving import engine as eng_mod
    if fault == "unchanged_state":
        def step(state, boxes, *rows_cfg):
            return state, torch.full(boxes.shape[:2], -1, dtype=torch.int32)
        monkeypatch.setattr(tracking, "step", step)
    elif fault == "altered_answer":
        real = eng_mod.DetectionEngine._detect_batch

        def broken(self, images, rids=None, **kw):
            (b, s, c, v), wall = real(self, images, rids=rids, **kw)
            b = b.copy()
            b[0, 0] += 0.5
            return (b, s, c, v), wall
        monkeypatch.setattr(eng_mod.DetectionEngine, "_detect_batch", broken)
    else:
        real = eng_mod.DetectionEngine._interpolate

        def broken(self, *a, **kw):
            out = real(self, *a, **kw)
            for x in out:
                if x.interpolated and fault == "empty_fill":
                    x.valid = np.zeros_like(x.valid)
                elif x.interpolated:
                    x.boxes = x.boxes + np.float32(1.0)
            return out
        monkeypatch.setattr(eng_mod.DetectionEngine, "_interpolate", broken)
    res = _shed_run()
    assert not res["correct"], res["compared"]
    if fault == "empty_fill":
        assert res["compared"]["fill_empty_share"][0] == 1.0


def test_reference_tracker_control_rounds_to_bfloat16():
    x = np.float32([1.0, 1 + 2 ** -9, 1 + 3 * 2 ** -9, 3.14159, -2.5e-3])
    want = torch.from_numpy(x).bfloat16().float().numpy()
    assert np.array_equal(ref_trk.bf16_round(x), want)
    assert ref_trk.bf16_round(np.float32(3.14159)).shape == ()


def _llm_run(control=False):
    small = lambda m: dict(m, prompt_len=[8, 24], output_len=[3, 8],
                           set_size=6, sample_tokens=20)
    return harness.run_cell("grok1-decode", 78, 0.3, False, "cpu",
                            time.perf_counter(), control=control,
                            config_override=lambda c: _smoke_config(),
                            mix_override=small)


def test_llm_sound_run_is_correct_and_its_control_is_not():
    """At the smoke size the fp8 control reads far above the sound run
    (which is float32 there and reads 0); the cell's own limits hold at
    the cell's size (``test_control_fails_at_the_cells_size_on_the_card``)."""
    res = _llm_run(control=True)
    assert res["correct"], res["compared"]
    cmp = res["compared"]
    assert cmp["logit_gap"][0] == cmp["routing_gap"][0] == 0.0
    assert cmp["routing_miss_share"][0] == 0.0
    assert cmp["control.logit_gap"][0] > 0.05
    assert cmp["control.routing_gap"][0] > 0.05
    assert cmp["control.routing_miss_share"][0] > 0.0


@pytest.mark.parametrize("fault", ["unchanged_state", "altered_token",
                                   "wrong_experts"])
def test_llm_faults_are_not_correct(monkeypatch, fault):
    from repro_torch.models import moe
    from repro_torch.serving import engine as eng_mod
    if fault == "wrong_experts":
        real_route = moe.route

        def route(x_flat, router_w, m):
            w, idx, aux = real_route(x_flat, router_w, m)
            return w, (idx + 1) % m.n_experts, aux
        monkeypatch.setattr(moe, "route", route)
    elif fault == "unchanged_state":
        real_make = eng_mod.make_decode_step

        def make(cfg):
            step = real_make(cfg)

            def decode(params, batch):
                logits, _ = step(params, batch)
                return logits, batch["cache"]
            return decode
        monkeypatch.setattr(eng_mod, "make_decode_step", make)
    else:
        real = eng_mod.ServingEngine._generate

        def broken(self, req):
            out, wall = real(self, req)
            out = out.copy()
            out[len(out) // 2] = (out[len(out) // 2] + 1) % 512
            return out, wall
        monkeypatch.setattr(eng_mod.ServingEngine, "_generate", broken)
    res = _llm_run()
    assert not res["correct"], res["compared"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["nvr16-detect", "grok1-decode",
                                  "nvr16-shed", "grok1-prefill"])
def test_control_fails_at_the_cells_size_on_the_card(card, name):
    """The control (TF32 detections; a bfloat16 tracker; fp8 expert
    products) at the cell's own size, three seeds, a short window: each
    reads above a limit that each sound run reads under."""
    for seed in (1, 2, 3):
        res = harness.run_cell(name, seed, 5.0, False, card,
                               time.perf_counter(), control=True)
        assert res["correct"], res["compared"]
        cmp = res["compared"]
        assert any(cmp[k][0] > cmp[k[len("control."):]][1]
                   for k in cmp if k.startswith("control."))
