"""CPU tests of the ``dsv3-decode`` cell's yardstick (``systems/mla_moe.py``,
``reference/mla_moe.py``, ``cost_mla.py`` and the readers
``mla_moe_mfu``, ``ep_moe_roofline``, ``route_enqueue_ms``): the sound
run and the control, the planted faults, the FLOP count against the
program's counter, the import rule, the readers on a CPU profile.  The
model is the port's ``small`` preset of deepseek-v3 (the cell's
configuration at small widths: 1 dense and 2 MoE layers, 16 experts in 4
groups, 8 of them held here), in float32; the chip is never looked for."""
import ast
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from bench import cost_mla, harness
from bench.reference import mla_moe as ref_mla
from bench.systems import mla_moe as sys_mla
from bench.trace import TraceReading

BENCH = Path(__file__).resolve().parent
CPU = torch.device("cpu")
SEED = 2 ** 31 + 78


def _small_config():
    _, _, c, _ = harness.cell_of("dsv3-decode")
    return dict(c, port_preset="small", hidden_size=64,
                intermediate_size=128, moe_intermediate_size=32,
                num_attention_heads=4, num_key_value_heads=4,
                q_lora_rank=32, kv_lora_rank=32, qk_nope_head_dim=16,
                qk_rope_head_dim=16, v_head_dim=16, n_routed_experts=8,
                published_n_routed_experts=16,
                expert_parallel={"cards": 2, "rank": 1, "first_expert": 8},
                num_experts_per_tok=4, n_group=4, topk_group=2,
                vocab_size=256, num_hidden_layers=3,
                first_k_dense_replace=1, torch_dtype="float32")


def _small_mix(m):
    """Outputs of 12-24 tokens: even a window of one request (a loaded
    CPU) gives the check enough served tokens to catch every fault."""
    return dict(m, prompt_len=[8, 24], output_len=[12, 24], set_size=6,
                sample_tokens=40)


def _run(control=False, seconds=0.5):
    return harness.run_cell("dsv3-decode", SEED, seconds, False, "cpu",
                            time.perf_counter(), control=control,
                            config_override=lambda c: _small_config(),
                            mix_override=_small_mix)


# --------------------------------------------------- sound run and faults
def test_sound_run_is_correct_and_its_control_is_not():
    """At the small size the sound run (float32) reads 0 on every
    number; the fp8 control reads above 0 on each and above a limit of
    the cell (the cell's own size: ``test_control_fails_at_the_cells_size_
    on_the_card``)."""
    res = _run(control=True)
    assert res["correct"], res["compared"]
    cmp = res["compared"]
    assert cmp["logit_gap"][0] == cmp["routing_gap"][0] == 0.0
    assert cmp["routing_miss_share"][0] == 0.0
    names = ("logit_gap", "routing_gap", "routing_miss_share")
    assert all(cmp[f"control.{k}"][0] > 0 for k in names)
    assert any(cmp[f"control.{k}"][0] > cmp[k][1] for k in names)


def _unchosen_groups(route):
    """``route`` with every chosen expert moved into a group the router
    did not choose, at the same place inside its group."""
    def moved(x_flat, router_w, m, bias=None):
        w, idx, aux = route(x_flat, router_w, m, bias=bias)
        per = m.n_experts // m.n_group
        out = idx.clone()
        for t, row in enumerate(idx.tolist()):
            chosen = sorted({e // per for e in row})
            free = [g for g in range(m.n_group) if g not in chosen]
            to = dict(zip(chosen, free))
            out[t] = torch.tensor([to[e // per] * per + e % per
                                   for e in row])
        return w, out, aux
    return moved


@pytest.mark.parametrize("fault", ["unchanged_latent", "altered_token",
                                   "no_mscale", "no_routed_scaling",
                                   "unchosen_groups"])
def test_faults_are_not_correct(monkeypatch, fault):
    from repro_torch.models import attention, moe
    from repro_torch.serving import engine as eng_mod
    if fault == "unchanged_latent":
        monkeypatch.setattr(attention, "_write_latent",
                            lambda cache, ckv, kpe, slot: {
                                k: v.clone() for k, v in cache.items()})
    elif fault == "altered_token":
        real = eng_mod.ServingEngine._generate

        def broken(self, req):
            out, wall = real(self, req)
            out = out.copy()
            out[len(out) // 2] = (out[len(out) // 2] + 1) % 256
            return out, wall
        monkeypatch.setattr(eng_mod.ServingEngine, "_generate", broken)
    elif fault == "no_mscale":
        monkeypatch.setattr(attention, "mla_softmax_scale", lambda cfg: (
            cfg.mla.qk_nope_dim + cfg.mla.qk_rope_dim) ** -0.5)
    elif fault == "no_routed_scaling":
        def unscaled(scores, idx, m):
            w = scores.gather(-1, idx)
            return w / w.sum(-1, keepdim=True)
        monkeypatch.setattr(moe, "chosen_weights", unscaled)
    else:
        monkeypatch.setattr(moe, "route", _unchosen_groups(moe.route))
    res = _run()
    assert not res["correct"], res["compared"]


def test_the_unchosen_group_fault_leaves_the_chosen_groups():
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    m = get_config("deepseek-v3-671b", preset="small").moe
    g = torch.Generator().manual_seed(1)
    x, w = torch.randn((5, 8), generator=g), torch.randn((8, 16), generator=g)
    b = torch.zeros(16)
    _, sound, _ = moe.route(x, w, m, bias=b)
    _, moved, _ = _unchosen_groups(moe.route)(x, w, m, bias=b)
    for a, c in zip(sound.tolist(), moved.tolist()):
        assert not {e // 4 for e in a} & {e // 4 for e in c}


# ---------------------------------------------------------------- counts
def test_flops_match_the_counter_with_the_programs_extra_work(monkeypatch):
    """The program's counted prefill = the needed FLOPs (its held pairs
    as kept) + the capacity slots beyond the kept pairs + the masked
    half of the scores + the logits of every prompt position but the
    last."""
    from repro_torch.cost import step_cost
    from repro_torch.models import moe
    from repro_torch.runtime import make_prefill_step
    c = _small_config()
    cfg = sys_mla.model_config(c)
    params = sys_mla.make_params(cfg, c, 1, CPU)
    calls, real = [], moe.route

    def route(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[1])
        return out
    monkeypatch.setattr(moe, "route", route)
    T = 24
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 256, T))
    got = step_cost(make_prefill_step(cfg), params, {"tokens": toks[None]})
    kept = [sys_mla.kept(sys_mla.held_counts(i, c), T, c) for i in calls]
    assert len(kept) == 2 and sum(kept) > 0
    need = cost_mla.request_flops(c, T, 1, sum(kept))
    d, f, H = c["hidden_size"], c["moe_intermediate_size"], \
        c["num_attention_heads"]
    C = ref_mla.capacity(T, 4, 16, c["capacity_factor"])
    slots = sum((c["n_routed_experts"] * C - k) * 2 * 3 * d * f
                for k in kept)
    scores = 2 * H * (16 + 16 + 16) * (T * T - T * (T + 1) // 2)
    logits = (T - 1) * 2 * d * c["vocab_size"]
    assert got["flops"] == need + slots + 3 * scores + logits


def test_moe_least_time_is_bytes_bound_in_decode():
    _, _, c, _ = harness.cell_of("dsv3-decode")
    e = 3 * 7168 * 2048
    one = (2 * e * 2 + 4 * (7168 * 256 + 256) + 4 * 7168) \
        / cost_mla.PEAKS["hbm_bytes_per_s"]
    assert cost_mla.moe_least_time(c, 1, 1, 1) == pytest.approx(one)
    assert cost_mla.expert_params(c) == e
    assert cost_mla.mla_params(c) == 187_105_280


# --------------------------------------------------------------- imports
def test_the_reference_imports_nothing_of_the_program():
    """``reference/mla_moe.py`` is among the files the import rule reads
    (``test_bench_imports_neither_jax_nor_the_jax_package``) and imports
    torch, math and its sibling alone."""
    path = BENCH / "reference" / "mla_moe.py"
    assert path in set(BENCH.rglob("*.py"))
    mods = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add("." * node.level + (node.module or ""))
    assert mods == {"__future__", "math", "torch", ".llm"}


# --------------------------------------------------------------- readers
class _Event:
    """A profiler event as ``TraceReading`` reads one."""

    def __init__(self, t0, t1, name, cuda, cid=0, tid=0):
        self._a, self._b, self._n = t0, t1, name
        self._cuda, self._cid, self._tid = cuda, cid, tid

    def name(self):
        return self._n

    def device_type(self):
        return (torch.autograd.DeviceType.CUDA if self._cuda
                else torch.autograd.DeviceType.CPU)

    def start_ns(self):
        return self._a

    def duration_ns(self):
        return self._b - self._a

    def correlation_id(self):
        return self._cid

    def start_thread_id(self):
        return self._tid


@pytest.fixture(scope="module")
def served():
    """A small serve of the cell's system under a CPU profiler, inside
    the harness's window range, with its routing record."""
    from repro_torch.models import moe
    from repro_torch.serving import Request, ServingEngine
    c = _small_config()
    cfg = sys_mla.model_config(c)
    eng = ServingEngine(cfg, sys_mla.make_params(cfg, c, 1, CPU),
                        cache_len=32, device="cpu")
    eng.warmup(6)
    reqs = [Request(i, np.arange(6, dtype=np.int32) + i, 4)
            for i in range(3)]
    calls, real = [], moe.route

    def route(*a, **kw):
        out = real(*a, **kw)
        calls.append(out[1])
        return out
    moe.route = route
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            with record_function("bench.window"):
                eng.serve(reqs)
    finally:
        moe.route = real
    out = {"moe_calls": [(i.shape[0], sys_mla.held_counts(i, c))
                         for i in calls],
           "requests": [(6, 4, 1)] * 3}
    return (SimpleNamespace(config=c, mix={}),
            list(prof.profiler.kineto_results.events()), out)


def _reading(events, extra=()):
    w = next(e for e in events if e.name() == "bench.window")
    a, b = w.start_ns(), w.start_ns() + w.duration_ns()
    edges = [_Event(a, a + 1, "kernel", True, -1),
             _Event(b - 1, b, "kernel", True, -2)]
    return TraceReading(list(events) + edges + list(extra))


NAMES = ("mla_moe_mfu.decode", "ep_moe_roofline.decode",
         "route_enqueue_ms.dsv3", "decode_device_ms.dsv3",
         "device_idle_share.dsv3")


def test_readers_read_the_programs_ranges_and_the_routing_record(served):
    ctx, events, out = served
    moes = [e for e in events if e.name() == "repro.moe"]
    routes = [e for e in events if e.name() == "repro.moe.route"]
    assert len(moes) == len(routes) == len(out["moe_calls"]) == 2 * 3 * 5
    decodes = [(e.start_ns(), e.start_ns() + e.duration_ns())
               for e in events if e.name() == "repro.llm.decode"]
    # a stand-in launch inside a decode step's MoE layer, its 2 us kernel
    m = next(e for e in moes if any(a <= e.start_ns() <= b
                                    for a, b in decodes))
    launch = _Event(m.start_ns() + 1, m.start_ns() + 2, "cudaLaunchKernel",
                    False, cid=77, tid=m.start_thread_id())
    w = next(e for e in events if e.name() == "bench.window")
    kernel = _Event(w.start_ns() + 10, w.start_ns() + 2010, "gemm", True,
                    cid=77)
    t = _reading(events, [launch, kernel])
    got = {n: harness.load_reader(n)(ctx, dict(out, trace=t))
           for n in NAMES}
    assert all(isinstance(v, float) and v > 0 for v in got.values()), got
    assert got["route_enqueue_ms.dsv3"] == pytest.approx(
        sum(e.duration_ns() for e in routes) / len(routes) / 1e6)
    least = sum(cost_mla.moe_least_time(
        ctx.config, T, sys_mla.kept(n, T, ctx.config), sum(x > 0 for x in n))
        for T, n in out["moe_calls"])
    assert got["ep_moe_roofline.decode"] == pytest.approx(
        100 * least / 2e-6)
    flops = 3 * cost_mla.request_flops(ctx.config, 6, 4, 1)
    assert got["decode_device_ms.dsv3"] == pytest.approx(
        2e-3 / len(decodes))
    assert got["mla_moe_mfu.decode"] == pytest.approx(
        100 * flops / (t.window_s * cost_mla.PEAKS["bf16_flops_per_s"]))


def test_readers_read_nothing_where_the_program_has_no_ranges(served):
    """The parent's program has no ``repro.moe`` ranges: the two readers
    of them return None and none raises."""
    ctx, events, out = served
    t = _reading([e for e in events if not e.name().startswith("repro.")])
    for n in ("ep_moe_roofline.decode", "route_enqueue_ms.dsv3",
              "decode_device_ms.dsv3"):
        assert harness.load_reader(n)(ctx, dict(out, trace=t)) is None


# ------------------------------------------------------------------ card
@pytest.mark.card
def test_control_fails_at_the_cells_size_on_the_card(card):
    """The fp8 control at the cell's own size, three seeds, a short
    window: each reads above a limit that each sound run reads under."""
    for seed in (1, 2, 3):
        res = harness.run_cell("dsv3-decode", seed, 5.0, False, card,
                               time.perf_counter(), control=True)
        assert res["correct"], res["compared"]
        cmp = res["compared"]
        assert any(cmp[k][0] > cmp[k[len("control."):]][1]
                   for k in cmp if k.startswith("control."))
