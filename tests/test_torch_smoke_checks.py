"""``chip_smoke.hold_to_plain``, the check that holds the attention and
scan kernels to their plain versions on the card, exercised on the CPU
with stand-ins for the kernels.

The plain version itself must pass, in float32 and in bfloat16.  Faulty
stand-ins must fail:

* decode attention that rounds the softmax probabilities to bfloat16
  before PV in its bfloat16 instance only (within the reference's bf16
  oracle tolerance 2e-2 of the plain version, so only the bit check
  against the float32 instance catches it), and one that drops the last
  eighth of the cache (caught by the float32 tolerance);
* the shortcuts the tensor-core flash kernel must not take: its bf16
  instance rounding P to bf16 before P.V (the usual FA2 step), or
  rounding q * scale to bf16; its float32 instance keeping only the hi
  bf16 piece of each operand;
* split decode whose merge order follows the instance's type (the
  kernel's order must follow the shape alone)."""
import importlib.util
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.decode_attention import decode_attention_torch
from repro_torch.kernels.flash_attention import flash_attention_torch
from repro_torch.kernels.rwkv_scan import rwkv_scan_torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
smoke = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(smoke)


def _decode_inputs(dtype, B=1, H=8, KV=2, S=4096, D=64):
    g = torch.Generator().manual_seed(0)
    return tuple(torch.randn(s, generator=g).to(dtype)
                 for s in ((B, H, D), (B, S, KV, D), (B, S, KV, D)))


def _rounds_p_in_bf16(q, k, v):
    """Decode attention that rounds p to bfloat16 before PV when its
    inputs are bfloat16, as a faulty kernel instance might."""
    B, H, D = q.shape
    KV = k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    p = torch.softmax(torch.einsum("bkgd,bskd->bkgs", qg, k.float()), -1)
    if q.dtype == torch.bfloat16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bkgs,bskd->bkgd", p, v.float())
    return out.reshape(B, H, D).to(q.dtype)


def _drops_tail(q, k, v):
    """Decode attention over the first seven eighths of the cache."""
    n = k.shape[1] * 7 // 8
    return decode_attention_torch(q, k[:, :n], v[:, :n])


def _flash_inputs(dtype, B=1, H=2, T=256, S=256, D=128, seed=3):
    """Inputs at D = 128, whose scale 128 ** -0.5 is not a power of two
    (at D = 64 rounding q * scale to bf16 would be exact)."""
    g = torch.Generator().manual_seed(seed)
    return tuple(torch.randn(s, generator=g).to(dtype)
                 for s in ((B, H, T, D), (B, H, S, D), (B, H, S, D)))


def _flash_with(q, k, v, round_p=False, round_qs=False, hi_only=False):
    """Causal flash attention in float32 with one of the shortcuts, taken
    by the bf16 instance (``round_p``, ``round_qs``) or by the float32
    instance (``hi_only``) only."""
    bf16 = q.dtype == torch.bfloat16
    B, H, T, D = q.shape
    S = k.shape[2]
    x = [t.float() for t in (q, k, v)]
    if hi_only and not bf16:
        x = [t.to(torch.bfloat16).float() for t in x]
    qs = x[0] * D ** -0.5
    if round_qs and bf16:
        qs = qs.to(torch.bfloat16).float()
    s = torch.einsum("bhtd,bhsd->bhts", qs, x[1])
    seen = torch.arange(S)[None, :] <= torch.arange(T)[:, None] + (S - T)
    p = torch.exp(torch.where(seen, s, -1e30) - torch.where(
        seen, s, -1e30).amax(-1, keepdim=True)) * seen
    l = p.sum(-1, keepdim=True)
    if round_p and bf16:
        p = p.to(torch.bfloat16).float()
    out = torch.einsum("bhts,bhsd->bhtd", p, x[2]) / l
    return out.to(q.dtype)


def _split_decode(q, k, v, n_split=64):
    """Split decode attention (per-split max, sum and PV in float32),
    merged in the order 0, 1, ... in the float32 instance and in reverse
    in the bf16 one."""
    B, H, D = q.shape
    S, KV = k.shape[1], k.shape[2]
    qg = q.float().reshape(B, KV, H // KV, D) * D ** -0.5
    s = torch.einsum("bkgd,bskd->bkgs", qg, k.float())
    s = s.reshape(B, KV, H // KV, n_split, S // n_split)
    m = s.amax(-1, keepdim=True)
    p = torch.exp(s - m)
    vs = v.float().reshape(B, n_split, S // n_split, KV, D)
    acc = torch.einsum("bkgnj,bnjkd->bkgnd", p, vs)
    mm = m.amax(-2, keepdim=True)
    c = torch.exp(m - mm)
    order = range(n_split)
    if q.dtype == torch.bfloat16:
        order = reversed(order)
    tot, den = 0.0, 0.0
    for i in order:
        tot = tot + acc[:, :, :, i] * c[:, :, :, i]
        den = den + p[:, :, :, i].sum(-1, keepdim=True) * c[:, :, :, i]
    return (tot / den).reshape(B, H, D).to(q.dtype)


def _hold(got, x, kernel, plain, tols=(smoke.F32_TOL,)):
    got = (got,) if torch.is_tensor(got) else got
    return smoke.hold_to_plain("test", "case", got, x, kernel, plain, tols)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_versions_pass(dtype):
    g = torch.Generator().manual_seed(1)
    q, k, v = (torch.randn((1, 2, 128, 32), generator=g).to(dtype)
               for _ in range(3))
    flash = lambda *a: flash_attention_torch(*a, causal=True)  # noqa: E731
    assert _hold(flash(q, k, v), (q, k, v), flash, flash)[2]
    x = _decode_inputs(dtype)
    assert _hold(decode_attention_torch(*x), x, decode_attention_torch,
                 decode_attention_torch)[2]
    r, kk, vv = (torch.randn((1, 2, 32, 16), generator=g).to(dtype)
                 for _ in range(3))
    w = (torch.sigmoid(torch.randn((1, 2, 32, 16), generator=g)) * 0.5
         + 0.45).to(dtype)
    x = (r, kk, vv, w, torch.randn((2, 16), generator=g),
         torch.randn((1, 2, 16, 16), generator=g) * 0.1)
    err, _, ok = _hold(rwkv_scan_torch(*x), x, rwkv_scan_torch,
                    rwkv_scan_torch, (smoke.F32_TOL, 5 * smoke.F32_TOL))
    assert ok and err == 0.0


def test_bf16_rounding_inside_the_kernel_fails():
    x = _decode_inputs(torch.bfloat16)
    got = _rounds_p_in_bf16(*x)
    want = decode_attention_torch(*x)
    # the reference's bf16 oracle tolerance would let it through
    assert torch.allclose(got.float(), want.float(), rtol=2e-2, atol=2e-2)
    assert not _hold(got, x, _rounds_p_in_bf16, decode_attention_torch)[2]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_dropped_cache_rows_fail(dtype):
    x = _decode_inputs(dtype)
    assert not _hold(_drops_tail(*x), x, _drops_tail,
                     decode_attention_torch)[2]


@pytest.mark.parametrize("shortcut", ["round_p", "round_qs"])
def test_flash_bf16_shortcuts_fail(shortcut):
    """Rounding P (the FA2 step) or q * scale to bf16 in the bf16
    instance: inside the reference's bf16 oracle tolerance, refused by
    the bit check against the float32 instance."""
    x = _flash_inputs(torch.bfloat16)
    kernel = lambda *a: _flash_with(*a, **{shortcut: True})  # noqa: E731
    plain = lambda *a: flash_attention_torch(*a, causal=True)  # noqa: E731
    got = kernel(*x)
    assert torch.allclose(got.float(), plain(*x).float(), rtol=2e-2,
                          atol=2e-2)
    assert not _hold(got, x, kernel, plain)[2]
    assert _hold(_flash_with(*x), x, _flash_with, plain)[2]


def test_flash_f32_hi_piece_only_fails():
    """A float32 instance that keeps only the hi bf16 piece of Q, K and
    V: its bf16 results pass the bit check (widened bf16 inputs are their
    own hi piece), its float32 results fail the float32 tolerance."""
    kernel = lambda *a: _flash_with(*a, hi_only=True)  # noqa: E731
    plain = lambda *a: flash_attention_torch(*a, causal=True)  # noqa: E731
    x = _flash_inputs(torch.float32)
    assert not _hold(kernel(*x), x, kernel, plain)[2]
    xb = _flash_inputs(torch.bfloat16)
    assert _hold(kernel(*xb), xb, kernel, plain)[2]


def test_decode_merge_order_by_type_fails():
    """Splits merged in an order that follows the instance's type: within
    the float32 tolerance, refused by the bit check."""
    x = _decode_inputs(torch.bfloat16, B=16, H=32, KV=8, S=1024, D=128)
    got = _split_decode(*x)
    assert _hold(_split_decode(*(t.float() for t in x)),
                 tuple(t.float() for t in x), _split_decode,
                 decode_attention_torch)[2]
    assert not _hold(got, x, _split_decode, decode_attention_torch)[2]


PTXAS_LOG = """\
ptxas info    : Compiling entry function '_ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea712flash_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_iiifiiPS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN51_GLOBAL__N__e7510225_18_flash_attention_cu_23f0aea712flash_kernelI13__nv_bfloat16Li128EEEvPKT_S4_S4_iiifiiPS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 128 registers, used 1 barriers
ptxas info    : Function properties for _ZN52_GLOBAL__N__408c5d7c_19_decode_attention_cu_3848999b19decode_split_kernelIfLi8ELi16EEEvPKT_S3_S3_iiiiifiiiPfPiPS1_
    8 bytes stack frame, 12 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 221 registers, used 1 barriers, 16 bytes smem
ptxas info    : Function properties for _ZN38_GLOBAL__N__af08db51_6_nms_cu_182c0d5b10nms_kernelEPK6float4PKfPKiiifiPiS7_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 32 registers, used 1 barriers, 16 bytes smem
"""


def test_ptxas_summary_names_each_instance():
    """The smoke's build lines: one per kernel instance, with its
    template arguments, registers, static shared memory and spills."""
    assert smoke.ptxas_summary(PTXAS_LOG) == [
        "flash_kernel<bf16, 128>: 128 registers, 0 bytes static smem, "
        "spills 0/0 bytes",
        "decode_split_kernel<f32, 8, 16>: 221 registers, 16 bytes static "
        "smem, spills 12/4 bytes",
        "nms_kernel: 32 registers, 16 bytes static smem, spills 0/0 bytes"]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rwkv_bound_counts_float32_operations_in_either_type(dtype):
    """The scan's recurrence is float32 arithmetic whatever its inputs'
    type, so its operations bound is 7 B H T hs^2 at the float32 rate
    for bf16 too: 0.1402 ms at rwkv6-3b (B=4, H=40, T=2048, hs=64), not
    the 0.0642 ms bytes bound the bf16 tensor-core rate would leave."""
    bound, by = smoke.rwkv_bound_ms(4, 40, 2048, 64, dtype)
    assert by == "operations"
    assert bound == pytest.approx(7 * 4 * 40 * 2048 * 64 ** 2 /
                                  smoke.FP32_OPS_PER_S * 1e3)
    assert round(bound, 4) == 0.1402


@pytest.fixture(scope="module")
def qwen3_smoke_f32():
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config("qwen3-4b", preset="smoke").replace(
        dtype="float32", param_dtype="float32")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size - 1, 16)
    return cfg, params, prompt


@pytest.mark.parametrize("fault", [None, *smoke.DECODE_FAULTS])
def test_decode_against_prefill_catches_planted_faults(qwen3_smoke_f32,
                                                       fault):
    """The smoke's decode-against-prefill reading on the qwen3-4b smoke
    preset in float32 on the CPU: the sound decode within
    ``LLM_F32_TOL`` with the greedy tokens equal, each of
    ``DECODE_FAULTS`` planted (rope off by one, the token's K/V not
    written, written one slot on) above it, and ``models.attention``
    sound again afterwards."""
    from repro_torch.models import attention
    from repro_torch.models.rope import apply_rope
    cfg, params, prompt = qwen3_smoke_f32
    sound = attention._write_ring
    rows = smoke.decode_gaps(cfg, params, prompt, smoke.LLM_NEW, fault)
    worst = max(r[1] for r in rows)
    if fault is None:
        assert worst <= smoke.LLM_F32_TOL
        assert all(r[3] for r in rows)
    else:
        assert worst > smoke.LLM_F32_TOL
    assert attention.apply_rope is apply_rope
    assert attention._write_ring is sound


FAMILIES = ("rwkv6-3b", "jamba-v0.1-52b", "deepseek-v3-671b", "grok-1-314b")


@pytest.fixture(scope="module")
def family_smoke_f32():
    """Each family's smoke preset (float32) with the port's seed-0
    weights and a 16-token prompt, built once a module."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    built = {}

    def get(arch):
        if arch not in built:
            cfg = get_config(arch, preset="smoke")
            params = init_model(cfg, torch.Generator().manual_seed(0),
                                device="cpu")
            prompt = np.random.default_rng(0).integers(
                0, cfg.vocab_size - 1, 16)
            built[arch] = cfg, params, prompt
        return built[arch]
    return get


@pytest.mark.parametrize("arch,fault", [
    (a, f) for a in FAMILIES for f in (None, *smoke.FAMILY_FAULTS[a])])
def test_family_decode_against_prefill_catches_planted_faults(
        family_smoke_f32, arch, fault):
    """chip_smoke's decode-against-prefill reading on each family's smoke
    preset in float32 on the CPU, capacity lifted to E / k as the smoke
    lifts it: the sound decode within ``LLM_F32_TOL`` with the greedy
    tokens equal (and, with MoE layers, the prefill's own router choosing
    the new token's experts as the decode did at every step); each of the
    family's ``FAMILY_FAULTS`` (the latent slot not written or one on, the
    Mamba state or conv window not carried, the RWKV state or token shift
    not carried, GQA's three) above it; every model module sound again
    afterwards."""
    from repro_torch.models import attention, mamba, moe, rwkv
    sound = {(m, n): getattr(m, n) for m, n, _ in smoke.FAULTS.values()}
    route = moe.route
    cfg, params, prompt = family_smoke_f32(arch)
    rows = smoke.decode_gaps(smoke.lift_capacity(cfg), params, prompt,
                             smoke.LLM_NEW, fault)
    worst = max(r[1] for r in rows)
    if fault is None:
        assert worst <= smoke.LLM_F32_TOL
        assert all(r[3] for r in rows)
        assert all(r[5] is None or r[5][0] for r in rows)
    else:
        assert worst > smoke.LLM_F32_TOL
    assert all(getattr(m, n) is f for (m, n), f in sound.items())
    assert moe.route is route and {attention, mamba, rwkv} == {
        m for m, _, _ in smoke.FAULTS.values()}


@pytest.mark.parametrize("variant", list(smoke.VARIANTS))
def test_decode_variants_are_sound_in_float32(family_smoke_f32, variant):
    """Each of chip_smoke's ``VARIANTS`` (a decode step computed another
    way, to find where a bf16 gap comes from) is the same arithmetic in
    float32: on jamba's smoke preset decode against prefill stays within
    ``LLM_F32_TOL`` with the greedy tokens equal, and the sound step is
    back afterwards."""
    from repro_torch.models import mamba
    sound = mamba._decode_step
    cfg, params, prompt = family_smoke_f32("jamba-v0.1-52b")
    rows = smoke.decode_gaps(smoke.lift_capacity(cfg), params, prompt,
                             smoke.LLM_NEW, variant)
    assert max(r[1] for r in rows) <= smoke.LLM_F32_TOL
    assert all(r[3] for r in rows)
    assert mamba._decode_step is sound


@pytest.mark.parametrize("arch", FAMILIES)
def test_layer_gaps_read_each_layer_in_order(family_smoke_f32, arch):
    """chip_smoke's ``layer_gaps`` gives one row a layer, in the model's
    order with its mixer and ffn, each layer's decode output within
    ``LLM_F32_TOL`` of the fresh prefill's in float32; the rope fault,
    where the family has it, shows at a layer; ``apply_layer`` is the
    sound one afterwards."""
    from repro_torch.models import transformer
    sound = transformer.apply_layer
    cfg, params, prompt = family_smoke_f32(arch)
    cfg = smoke.lift_capacity(cfg)
    gaps = smoke.layer_gaps(cfg, params, prompt)
    assert [(g[0], g[1]) for g in gaps] == [
        (spec.mixer, spec.ffn) for st in cfg.stages
        for spec in list(st.pattern) * st.repeats]
    assert all(0 <= e <= smoke.LLM_F32_TOL < h for _, _, e, h in gaps)
    rope = "rope at decode_pos - 1"       # a carry fault shows at step 1
    if rope in smoke.FAMILY_FAULTS[arch]:
        assert max(e for _, _, e, _ in smoke.layer_gaps(
            cfg, params, prompt, rope)) > smoke.LLM_F32_TOL
    assert transformer.apply_layer is sound


def test_moe_capacity_lift_is_why_decode_equals_prefill(family_smoke_f32):
    """At grok-1's published capacity factor (1.25) a prompt of one token
    repeated sends every token to the same experts and overflows them:
    the prefill drops (token, expert) pairs, the last tokens first, and a
    one-token decode (C = 4, never dropping) then differs from the fresh
    prefill beyond ``LLM_F32_TOL``.  With the factor lifted to E / k
    (C >= T) nothing drops and decode equals prefill within it."""
    import numpy as np

    from repro_torch.runtime import make_prefill_step
    cfg, params, _ = family_smoke_f32("grok-1-314b")
    assert cfg.moe.capacity_factor == 1.25
    prompt = np.full(16, 7)
    with smoke.moe_log() as log:
        make_prefill_step(cfg)(params, {"tokens": torch.as_tensor(
            prompt)[None]})
    assert sum(d for _, d in log["drops"]) > 0
    published = smoke.decode_gaps(cfg, params, prompt, smoke.LLM_NEW)
    assert max(r[1] for r in published) > smoke.LLM_F32_TOL
    lifted = smoke.lift_capacity(cfg)
    with smoke.moe_log() as log:
        make_prefill_step(lifted)(params, {"tokens": torch.as_tensor(
            prompt)[None]})
    assert sum(d for _, d in log["drops"]) == 0
    rows = smoke.decode_gaps(lifted, params, prompt, smoke.LLM_NEW)
    assert max(r[1] for r in rows) <= smoke.LLM_F32_TOL


@pytest.mark.parametrize("arch", ["grok-1-314b", "deepseek-v3-671b"])
def test_eager_serve_gives_the_engines_tokens_and_its_decode_dispatches(
        family_smoke_f32, monkeypatch, arch):
    """chip_smoke's ``eager_serve`` decodes the served requests as
    ``ServingEngine._generate`` does: the same tokens by rid, and under
    ``moe_log`` one one-token dispatch an MoE layer a decode step, which
    is what ``phase_family``'s decode drop check counts (the served
    decodes, replayed from graphs on a card, log none)."""
    import numpy as np

    from repro_torch.serving import Request, ServingEngine
    monkeypatch.setattr(smoke, "DEV", "cpu")
    cfg, params, _ = family_smoke_f32(arch)
    rng = np.random.default_rng(0)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size - 1, P)
                    .astype(np.int32), 5, float(i))
            for i, P in enumerate((3, 9))]
    served = ServingEngine(cfg, params, n_replicas=1,
                           cache_len=smoke.LLM_CACHE_LEN,
                           device="cpu").serve(reqs)["responses"]
    with smoke.moe_log() as log:
        eager = smoke.eager_serve(cfg, params, reqs)
    assert {r.rid: r.tokens.tolist() for r in served} == eager
    n_moe = sum(s.ffn == "moe" for s in cfg.layer_specs())
    assert [T for T, _ in log["drops"] if T == 1] == [1] * (2 * 5 * n_moe)
    assert sum(d for T, d in log["drops"] if T == 1) == 0


def test_forced_routing_routes_as_told_and_restores():
    """``forced_routing`` makes ``models.moe.route`` return the experts it
    is given, weighted by the router's own normalized scores at them, and
    puts the sound ``route`` back."""
    from repro_torch.models import moe
    from repro_torch.models.config import MoEConfig
    m = MoEConfig(n_experts=4, top_k=2, d_ff=8)
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((5, 8), generator=g), torch.randn((8, 4), generator=g)
    forced = torch.tensor([[3, 0]] * 5)
    sound = moe.route
    with smoke.forced_routing([forced]):
        wt, idx, _ = moe.route(x, w, m)
    assert moe.route is sound and torch.equal(idx, forced)
    p = torch.softmax(x @ w, -1).gather(-1, forced)
    assert torch.allclose(wt, p / p.sum(-1, keepdim=True))


def test_forced_routing_weighs_as_the_published_router():
    """Under DeepSeek-V3's published router (groups, a correction bias),
    ``forced_routing`` weighs the given experts by the sigmoid scores at
    them, normalized and scaled by ``routed_scaling_factor``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    m = get_config("deepseek-v3-671b", preset="small").moe
    g = torch.Generator().manual_seed(0)
    x, w = torch.randn((5, 8), generator=g), torch.randn((8, 16), generator=g)
    forced = torch.tensor([[15, 0, 3, 7]] * 5)
    with smoke.forced_routing([forced]):
        wt, idx, _ = moe.route(x, w, m, bias=torch.full((16,), 0.5))
    assert torch.equal(idx, forced)
    p = torch.sigmoid(x @ w).gather(-1, forced)
    assert torch.allclose(wt, 2.5 * p / p.sum(-1, keepdim=True))


def test_routing_report_compares_the_chosen_experts_as_sets():
    """The new token's experts agree where the fresh prefill chose the
    same set, in whatever order ``top_k`` listed it; one expert changed
    is a difference, and the report says how many are in common."""
    served = [(torch.tensor([[0, 1, 2, 3], [4, 5, 6, 7]]), None)]
    reordered = [(torch.tensor([[3, 2, 1, 0], [7, 4, 6, 5]]), torch.ones(2))]
    one = [(torch.tensor([[0, 1, 2, 3], [4, 5, 6, 9]]), torch.ones(2))]
    assert smoke.routing_report(served, reordered) == (True, 0, [
        (True, 1.0, 4)])
    agree, differ, per_layer = smoke.routing_report(served, one)
    assert not agree and differ == 1 and per_layer == [(False, 1.0, 3)]


def test_routing_check_catches_the_router_fault():
    """Decode against prefill on the small DeepSeek-V3 preset (the
    published router, float32): the prefill's own router chooses the new
    token's experts as the decode did at every step, and with
    ``ROUTER_FAULTS``' group limit dropped in the decode at no more than
    half of them, as ``decode_against_prefill`` requires."""
    import numpy as np

    from repro_torch.configs import get_config
    from repro_torch.models import init_model
    cfg = get_config("deepseek-v3-671b", preset="small")
    params = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    prompt = np.random.default_rng(0).integers(0, cfg.vocab_size - 1, 16)
    lifted = smoke.lift_capacity(cfg)
    sound = smoke.decode_gaps(lifted, params, prompt, smoke.LLM_NEW)
    assert all(r[5][0] for r in sound)
    for fault in smoke.FAMILY_ROUTER_FAULTS["deepseek-v3-671b"]:
        rows = smoke.decode_gaps(lifted, params, prompt, smoke.LLM_NEW,
                                 fault)
        assert 2 * sum(r[5][0] for r in rows) <= len(rows)
