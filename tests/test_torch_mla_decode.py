"""MLA's weight-absorbed decode attention (``kernels.mla_decode``,
``csrc/mla_decode.cu``) and the rule that sends
``models.attention.apply_mla``'s decode to it.

On the CPU: the plain version equals the layer's former einsum branch bit
for bit (float32 and bf16, the ring filling, wrapping and windowed, the
position an int or a 0-d tensor), and the port's absorbed decode still
agrees with the JAX package's within the family tests' tolerance;
``apply_mla`` hands the kernel's dispatch exactly bf16 CUDA tensors with
no gradient to record, with the layer's own arguments, and keeps its
output; CPU and meta tensors never reach the wrapper; the wrapper
refuses wrong types (float32 among them), shapes, widths and layouts
before any launch,
sizes its splits and scratch from the shape alone and counts three
launches a call; ``ops.CountedGraph`` adds them at each replay; and an
emulation of the kernel's plan (the filled slots it finds from the
position, its splits, its online softmax and the three bf16 pieces of P)
covers exactly the mask's slots and gives the plain version's result.

Tests marked ``card`` need a CUDA device and skip without one
(``python -m pytest -m card tests/test_torch_mla_decode.py`` on a
machine with an H100): the kernel against the plain version at
DeepSeek-V3's widths (H 128, r 512, rope 64, L 4,608) with 1, 1,000,
2,350 and 4,608 filled slots, a wrapped ring and a window, and at the
smoke presets' widths with one and two batch rows; NaN in every slot
outside the mask changing nothing; two calls bit-equal and a graph
replay after a new ``decode_pos`` equal to the eager call; launches
counted; and a served bf16 decode through the kernel (a float32 one
through the plain version)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.kernels import mla_decode as km
from repro_torch.models import attention
from repro_torch.models.config import LayerSpec

#: card against plain, bf16 out: every element within two bf16 ulps of
#: its own value plus 1/256 of the output's largest magnitude.  The two
#: add each float32 sum in another order (q_abs, the scores, the context
#: and the projection), so q_abs or the output may round to the
#: neighbouring bf16
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -8
#: float32 out: the same sums in another order
F32_RTOL, F32_ATOL_SHARE = 1e-5, 1e-5
#: DeepSeek-V3's MLA widths and dsv3-decode's ring
DSV3 = dict(H=128, R=512, P=64, N=128, V=128, L=4608)
DSV3_SCALE = 192 ** -0.5 * (0.1 * np.log(40.0) + 1) ** 2


def _inputs(dtype, B=1, H=4, R=64, P=16, N=32, V=32, L=24, seed=0,
            device="cpu"):
    """q_nope as the layer slices it (a view of q), a contiguous q_pe,
    a ring and the absorbed weights of N(0, 1/r) entries."""
    g = torch.Generator(device=device).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=device) * scale).to(
            dtype)

    q = rnd(B, 1, H, N + P)
    return (q[..., :N], q[..., N:].contiguous(), rnd(B, L, R), rnd(B, L, P),
            rnd(R, H * N, scale=R ** -0.5).reshape(R, H, N),
            rnd(R, H * V, scale=R ** -0.5).reshape(R, H, V))


def _former_branch(q_nope, q_pe, cckv, ckpe, wk_b, wv_b, positions,
                   decode_pos, causal, window, scale, out_dtype):
    """``apply_mla``'s decode branch as it stood before the kernel, from
    the ring on."""
    B, L = cckv.shape[0], cckv.shape[1]
    q_abs = torch.einsum("bthn,rhn->bthr", q_nope, wk_b)
    s = torch.einsum("bthr,bsr->bhts", q_abs.float(), cckv.float())
    s = s + torch.einsum("bthp,bsp->bhts", q_pe.float(), ckpe.float())
    s = s * scale
    k_pos, valid = attention._ring_positions(L, decode_pos + 1, "cpu")
    k_pos = k_pos[None].expand(B, L)
    valid = valid[None].expand(B, L)
    mask = attention.make_mask(positions, k_pos, causal, window, valid)
    s = torch.where(mask, s, attention.NEG_INF)
    prob = torch.softmax(s, dim=-1)
    ctx = torch.einsum("bhts,bsr->bthr", prob, cckv.float())
    return torch.einsum("bthr,rhv->bthv", ctx, wv_b.float()).to(out_dtype)


#: (ring slots, decode_pos, window): filling, full, wrapped, windowed
RINGS = [(24, 0, None), (24, 9, None), (24, 23, None), (24, 61, None),
         (24, 30, 7), (7, 100, 7), (24, 5, 16)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("L,pos,window", RINGS)
@pytest.mark.parametrize("as_tensor", [False, True])
def test_the_plain_version_is_the_former_branch_bit_for_bit(
        dtype, L, pos, window, as_tensor):
    args = _inputs(dtype, B=2, L=L)
    p = torch.tensor(pos) if as_tensor else pos
    positions = torch.full((2, 1), pos, dtype=torch.int64)
    for causal in (True, False):
        want = _former_branch(*args, positions, p, causal, window, 0.3,
                              dtype)
        got = km.mla_decode_torch(*args, p, scale=0.3, window=window)
        assert got.dtype == dtype and torch.equal(got, want)


@pytest.mark.parametrize("window", [None, 3])
def test_the_absorbed_decode_agrees_with_the_reference(window):
    """The port's ``apply_mla`` decode (the plain version on the CPU)
    against the JAX package's absorbed decode: a 6-token prefill into an
    8-slot latent ring (3 with the window), then 5 decode steps that wrap
    it; outputs within the family tests' 1e-5 (float32, the reference's
    weights, the smoke preset)."""
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.configs import get_config as jget
    from repro.models import attention as jattn
    from repro.models.config import LayerSpec as JSpec

    jcfg, tcfg = (jget("deepseek-v3-671b", preset="smoke"),
                  get_config("deepseek-v3-671b", preset="smoke"))
    p = jax.tree.map(np.array, jattn.init_mla(jax.random.PRNGKey(5), jcfg))
    tp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), p)
    jspec, tspec = JSpec("attn", "dense", window), LayerSpec("attn", "dense",
                                                             window)
    B, T, steps = 2, 6, 5
    x = (0.25 * np.random.default_rng(6).standard_normal(
        (B, T + steps, jcfg.d_model))).astype(np.float32)
    pos = np.broadcast_to(np.arange(T, dtype=np.int32), (B, T))
    jc = jattn.init_mla_cache(jcfg, jspec, B, 8, jnp.float32)
    tc = attention.init_mla_cache(tcfg, tspec, B, 8, torch.float32, "cpu")
    _, jc = jattn.apply_mla(p, jcfg, jspec, jnp.asarray(x[:, :T]),
                            jnp.asarray(pos), mode="prefill", cache=jc)
    _, tc = attention.apply_mla(tp, tcfg, tspec, torch.from_numpy(x[:, :T]),
                                torch.from_numpy(pos.copy()).long(),
                                mode="prefill", cache=tc)
    for s in range(steps):
        p1 = np.full((B, 1), T + s, np.int32)
        xs = x[:, T + s:T + s + 1]
        jy, jc = jattn.apply_mla(p, jcfg, jspec, jnp.asarray(xs),
                                 jnp.asarray(p1), mode="decode", cache=jc,
                                 decode_pos=jnp.asarray(T + s, jnp.int32))
        ty, tc = attention.apply_mla(tp, tcfg, tspec, torch.from_numpy(xs),
                                     torch.from_numpy(p1).long(),
                                     mode="decode", cache=tc,
                                     decode_pos=T + s)
        np.testing.assert_allclose(ty.numpy(), np.array(jy), rtol=0,
                                   atol=1e-5)


# ------------------------------------------------------------------ rule
def _stand_in(device, requires_grad=False, dtype=torch.bfloat16):
    return SimpleNamespace(is_cuda=device == "cuda", dtype=dtype,
                           requires_grad=requires_grad)


@pytest.mark.parametrize("device,grad_mode,w_grad,dtype,takes", [
    ("cuda", False, False, torch.bfloat16, True),   # serving on a card
    ("cuda", True, False, torch.bfloat16, True),    # grad mode, no record
    ("cuda", False, True, torch.bfloat16, True),    # no_grad, trained leaves
    ("cuda", True, True, torch.bfloat16, False),    # a gradient to record
    ("cuda", False, False, torch.float32, False),   # float32: the plain one
    ("cpu", False, False, torch.bfloat16, False),   # the CPU: the plain one
    ("meta", False, False, torch.bfloat16, False)])  # the cost model
def test_the_kernel_is_taken_for_cuda_tensors_without_grad(
        device, grad_mode, w_grad, dtype, takes):
    tensors = ([_stand_in(device, dtype=dtype)] * 4
               + [_stand_in(device, w_grad, dtype)] * 2)
    with torch.set_grad_enabled(grad_mode):
        assert attention._on_card(*tensors) is takes


def _layer(dtype=torch.float32, window=None):
    cfg = get_config("deepseek-v3-671b", preset="smoke").replace(
        dtype="float32" if dtype == torch.float32 else "bfloat16")
    g = torch.Generator().manual_seed(2)
    p = attention.init_mla(g, cfg.replace(
        param_dtype="float32" if dtype == torch.float32 else "bfloat16"))
    spec = LayerSpec("attn", "dense", window)
    x = torch.randn((2, 9, cfg.d_model), generator=g).to(dtype)
    cache = attention.init_mla_cache(cfg, spec, 2, 8, dtype, "cpu")
    _, cache = attention.apply_mla(p, cfg, spec, x[:, :6],
                                   torch.arange(6)[None].expand(2, 6),
                                   mode="prefill", cache=cache)
    return cfg, spec, p, x, cache


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window,as_tensor", [(None, False), (5, True)])
def test_apply_mla_hands_the_kernel_the_layers_arguments(
        monkeypatch, dtype, window, as_tensor):
    """With the rule patched to say "kernel", the decode calls
    ``ops.mla_decode`` once with the layer's query parts, the written
    ring, the absorbed weights as (r, H, nope) and (r, H, v) views, the
    position, the window and the softmax scale; its answer is the
    layer's.  The real rule on CPU tensors calls the plain version."""
    cfg, spec, p, x, cache = _layer(dtype, window)
    m, H = cfg.mla, cfg.n_heads
    pos = torch.tensor(6) if as_tensor else 6
    positions = torch.full((2, 1), 6)
    want, want_cache = attention.apply_mla(p, cfg, spec, x[:, 6:7],
                                           positions, mode="decode",
                                           cache=cache, decode_pos=pos)
    calls = []

    def record(*args, scale, window):
        calls.append((args, scale, window))
        return km.mla_decode_torch(*args, scale=scale, window=window)

    monkeypatch.setattr(attention, "_on_card", lambda *t: True)
    monkeypatch.setattr(ops, "mla_decode", record)
    got, got_cache = attention.apply_mla(p, cfg, spec, x[:, 6:7], positions,
                                         mode="decode", cache=cache,
                                         decode_pos=pos)
    assert torch.equal(got, want)
    assert all(torch.equal(got_cache[k], want_cache[k]) for k in want_cache)
    (args, scale, win), = calls
    q_nope, q_pe, ckv, kpe, wk_b, wv_b, dpos = args
    assert q_nope.shape == (2, 1, H, m.qk_nope_dim)
    assert q_pe.shape == (2, 1, H, m.qk_rope_dim)
    assert torch.equal(ckv, got_cache["ckv"])
    assert torch.equal(kpe, got_cache["kpe"])
    assert wk_b.shape == (m.kv_lora_rank, H, m.qk_nope_dim)
    assert wk_b.data_ptr() == p["wk_b"].data_ptr()
    assert wv_b.shape == (m.kv_lora_rank, H, m.v_head_dim)
    assert wv_b.data_ptr() == p["wv_b"].data_ptr()
    assert dpos is pos and win == window
    assert scale == attention.mla_softmax_scale(cfg)
    monkeypatch.undo()
    seen = []
    monkeypatch.setattr(ops, "mla_decode", lambda *a, **k: seen.append(a))
    again, _ = attention.apply_mla(p, cfg, spec, x[:, 6:7], positions,
                                   mode="decode", cache=cache,
                                   decode_pos=pos)
    assert not seen and torch.equal(again, want)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(build, "function", no_build)
    before = ops.launches()
    args = _inputs(torch.float32)
    assert torch.equal(ops.mla_decode(*args, 9, scale=0.3),
                       km.mla_decode_torch(*args, 9, scale=0.3))
    assert ops.launches() == before


def test_meta_tensors_never_reach_the_wrapper(monkeypatch):
    """The cost model's decode on meta tensors: ``apply_mla`` takes the
    plain version, whose shapes it reads."""
    def refuse(*a, **k):
        raise AssertionError("a meta tensor reached the kernel's wrapper")

    monkeypatch.setattr(ops, "mla_decode_cuda", refuse)
    monkeypatch.setattr(ops, "mla_decode", refuse)
    cfg = get_config("deepseek-v3-671b", preset="smoke")
    p = {k: ({"scale": v["scale"].to("meta")} if isinstance(v, dict)
             else v.to("meta"))
         for k, v in attention.init_mla(torch.Generator(), cfg).items()}
    with torch.device("meta"):
        cache = attention.init_mla_cache(cfg, LayerSpec("attn", "dense"), 1,
                                         8, torch.float32, "meta")
        x = torch.empty((1, 1, cfg.d_model))
        y, c = attention.apply_mla(p, cfg, LayerSpec("attn", "dense"), x,
                                   torch.zeros((1, 1), dtype=torch.int64),
                                   mode="decode", cache=cache,
                                   decode_pos=torch.tensor(3))
    assert y.shape == (1, 1, cfg.d_model) and y.is_meta
    assert c["ckv"].shape == cache["ckv"].shape


# --------------------------------------------------------------- wrapper
def _stub_launch(monkeypatch, clusters=15):
    """The launcher stubbed (it records its arguments) and the device
    check passed on CPU tensors, so the wrapper runs to its launch; the
    card's fit (``clusters`` clusters at once, 132 SMs) set for each
    cluster size."""
    launched = []
    monkeypatch.setattr(build, "function", lambda *a, **k: (
        lambda *args: launched.append(args) or 0))
    monkeypatch.setattr(build, "cuda_device",
                        lambda what, *t: torch.device("cpu"))
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    monkeypatch.setattr(km, "_FITS", {})
    for R, P in ((64, 16), (32, 16), (48, 16), (544, 16), (64, 12)):
        for cs in (1, 2, 4, 8):
            km._FITS[(None, R, P, cs)] = (clusters, 132)
    return launched


def _swap(args, i, new):
    return args[:i] + (new,) + args[i + 1:]


def _widths(**kw):
    return _inputs(torch.bfloat16, **kw)


REFUSED = {
    "ring float32": lambda a: _swap(a, 2, a[2].float()),
    "all float32": lambda a: tuple(t.float() for t in a),
    "q_nope float16": lambda a: _swap(a, 0, a[0].half()),
    "kpe not (B, L, rope)": lambda a: _swap(a, 3, a[3][:, :-1]),
    "wv_b not (r, H, v)": lambda a: _swap(a, 5, a[5][:, :2]),
    "q_nope two tokens": lambda a: _swap(a, 0, a[0].expand(1, 2, 4, 32)),
    "ring not contiguous": lambda a: _swap(
        a, 2, a[2].transpose(1, 2).contiguous().transpose(1, 2)),
    "ring off 16 bytes": lambda a: _swap(
        a, 2, torch.empty(a[2].numel() + 1, dtype=a[2].dtype)[1:].view(
            a[2].shape)),
    "q_pe last stride 2": lambda a: _swap(
        a, 1, torch.empty(a[1].shape + (2,), dtype=a[1].dtype)[..., 0]),
    "r not a multiple of 32": lambda a: _widths(R=48),
    "r past 512": lambda a: _widths(R=544),
    "rope not a multiple of 8": lambda a: _widths(P=12, R=64),
    "v three vectors": lambda a: _widths(V=24),
    "nope half a vector": lambda a: _widths(N=4),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrapper_refuses_before_any_launch(monkeypatch, case):
    launched = _stub_launch(monkeypatch)
    before = ops.launches()
    with pytest.raises(ValueError):
        km.mla_decode_cuda(*REFUSED[case](_widths()), 5, scale=0.3)
    assert not launched and ops.launches() == before


@pytest.mark.parametrize("pos", [torch.tensor(5, dtype=torch.int32),
                                 torch.tensor([5]), -1])
def test_the_wrapper_refuses_a_position_it_cannot_read(monkeypatch, pos):
    launched = _stub_launch(monkeypatch)
    with pytest.raises(ValueError):
        km.mla_decode_cuda(*_widths(), pos, scale=0.3)
    assert not launched


@pytest.mark.parametrize("H,cs", [(128, 8), (64, 4), (48, 1), (32, 2),
                                  (4, 1), (256, 8), (96, 2)])
def test_the_cluster_is_the_most_head_tiles_that_divide_them(H, cs):
    assert km.cluster_size(H) == cs


@pytest.mark.parametrize("B,H,L,clusters,cs,S", [
    (1, 128, 4608, 15, 8, 15),      # an H100: 15 clusters of 8 fit at once
    (1, 128, 4608, 30, 4, 15),
    (1, 128, 4608, 66, 2, 16),
    (1, 4, 256, 132, 1, 8),         # at most one split a 32-slot chunk
    (2, 128, 4608, 15, 8, 7),
    (1, 128, 100, 15, 8, 4),
    (1, 16, 20, 132, 1, 1),
    (200, 16, 4608, 132, 1, 1),     # at least one
    (1, 4, 100000, 132, 1, 132),
    (1, 4, 100000, 400, 1, 256)])   # at most MAX_SPLITS
def test_splits_fill_one_wave_of_clusters(B, H, L, clusters, cs, S):
    """As many (batch row, head tile, split) blocks as the clusters that
    fit at once hold, from the shape alone."""
    assert km.splits(B, H, L, clusters, cs) == S


@pytest.mark.parametrize("as_tensor", [False, True])
def test_the_wrapper_sizes_its_scratch_and_counts_three_launches(
        monkeypatch, as_tensor):
    launched = _stub_launch(monkeypatch)
    args = _widths(B=2, H=20, L=300)
    pos = torch.tensor(77) if as_tensor else 77
    before = ops.launches()["mla_decode"]
    out = km.mla_decode_cuda(*args, pos, scale=0.25, window=50)
    (a,), S = launched, km.splits(2, 20, 300, 15, 2)    # two head tiles
    assert out.shape == (2, 1, 20, 32) and out.dtype == torch.bfloat16
    assert a[6] == (pos.data_ptr() if as_tensor else 0)
    assert a[7:11] == (20 * 48, 48, 20 * 16, 16)     # q_nope a view of q
    assert a[11] == (0 if as_tensor else 77)
    assert a[12:23] == (2, 20, 32, 64, 16, 32, 300, S, 50, 132, 2)
    assert a[23] == pytest.approx(0.25)
    assert ops.launches()["mla_decode"] == before + 3


def test_a_card_with_no_room_for_a_cluster_raises(monkeypatch):
    launched = _stub_launch(monkeypatch, clusters=0)
    with pytest.raises(RuntimeError, match="mla_decode_clusters"):
        km.mla_decode_cuda(*_widths(), 5, scale=0.3)
    assert not launched


def test_counted_graph_adds_the_captured_launches_at_each_replay(
        monkeypatch):
    """A decode graph captured over the wrapper: the capture's three are
    taken back and each replay adds them.  (The capture is stood in by
    an eager run of its body.)"""
    from contextlib import nullcontext

    class Graph:
        def replay(self):
            pass

    def counting(*args, scale, window=None):
        km.LAUNCHES += 3
        return km.mla_decode_torch(*args, scale=scale, window=window)

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: nullcontext())
    monkeypatch.setattr(torch.cuda, "device", lambda d: nullcontext())
    monkeypatch.setattr(ops, "mla_decode_cuda", counting)
    ops.reset_launches()
    args = _inputs(torch.float32)
    graph = ops.CountedGraph(lambda: counting(*args, 7, scale=0.3), "cpu")
    assert graph.captured == {"mla_decode": 3}
    assert ops.launches()["mla_decode"] == 0
    for n in (3, 6):
        graph.replay()
        assert ops.launches()["mla_decode"] == n


# ------------------------------------------------------- the kernel's plan
def _split3(p):
    """csrc/mla_decode.cu's three bf16 pieces of a float32 P."""
    p0 = p.to(torch.bfloat16).float()
    r = p - p0
    p1 = r.to(torch.bfloat16).float()
    return p0, p1, (r - p1).to(torch.bfloat16).float()


def _plan(L, pos, window, S):
    """The slots each split of the attend pass reads, in the kernel's
    integer arithmetic."""
    n = max(0, min(pos + 1, L, window or L))
    first = pos - n + 1
    return [[(first + k) % L for k in range(s * n // S, (s + 1) * n // S)]
            for s in range(S)]


@pytest.mark.parametrize("L,pos,window", RINGS + [(4608, 0, None),
                                                  (4608, 2349, None),
                                                  (4608, 4607, None),
                                                  (4608, 5841, None),
                                                  (4608, 3000, 700)])
@pytest.mark.parametrize("S", [1, 3, 16, 200])
def test_the_plan_reads_exactly_the_masks_slots_once(L, pos, window, S):
    k_pos, valid = attention._ring_positions(L, pos + 1)
    q = torch.tensor([[pos]])
    mask = attention.make_mask(q, k_pos[None], True, window, valid[None])
    plan = _plan(L, pos, window, S)
    slots = [j for split in plan for j in split]
    assert sorted(slots) == torch.nonzero(mask[0, 0, 0]).flatten().tolist()
    positions = [int(k_pos[j]) for j in slots]
    assert positions == sorted(positions)      # oldest first, split order


def test_p_in_three_bf16_pieces_is_exact():
    p = torch.rand(100000, dtype=torch.float32) ** 3
    p = torch.cat([p, torch.tensor([0.0, 1.0, 2.0 ** -100, 1 - 2.0 ** -24])])
    p0, p1, p2 = _split3(p)
    assert torch.equal((p0.double() + p1.double() + p2.double()),
                       p.double())


def _emulate(q_nope, q_pe, ckv, kpe, wk_b, wv_b, pos, scale, window, S):
    """The kernel's plan in float32 on the CPU: q_abs rounded to the
    inputs' type; each split's 64-slot steps with an online softmax and
    P V taken over P's three pieces; the splits weighed by exp(m - M)."""
    B, _, H, _ = q_nope.shape
    L = ckv.shape[1]
    q_abs = torch.einsum("bthn,rhn->bthr", q_nope.float(),
                         wk_b.float()).to(q_nope.dtype).float()[:, 0]
    qp = q_pe.float()[:, 0]
    out = []
    for b in range(B):
        parts = []
        for split in _plan(L, pos, window, S):
            if not split:
                continue
            m = torch.full((H,), -torch.inf)
            l, acc = torch.zeros(H), torch.zeros(H, ckv.shape[2])
            for t in range(0, len(split), 64):
                idx = torch.tensor(split[t:t + 64])
                k, v = ckv[b, idx].float(), kpe[b, idx].float()
                s = (q_abs[b] @ k.T + qp[b] @ v.T) * scale
                m_new = torch.maximum(m, s.amax(-1))
                p = torch.exp(s - m_new[:, None])
                corr = torch.exp(m - m_new)
                l = l * corr + p.sum(-1)
                acc = acc * corr[:, None] + sum(pc @ k for pc in _split3(p))
                m = m_new
            parts.append((m, l, acc))
        M = torch.stack([m for m, _, _ in parts]).amax(0)
        w = [torch.exp(m - M) for m, _, _ in parts]
        total = sum(wi * l for wi, (_, l, _) in zip(w, parts))
        ctx = sum(wi[:, None] * acc for wi, (_, _, acc) in zip(w, parts))
        ctx = ctx / total[:, None]
        out.append(torch.einsum("hr,rhv->hv", ctx, wv_b.float()))
    return torch.stack(out)[:, None].to(q_nope.dtype)


@pytest.mark.parametrize("L,pos,window", [(24, 9, None), (24, 61, None),
                                          (24, 30, 7), (200, 150, None)])
@pytest.mark.parametrize("S", [1, 4])
def test_the_plan_gives_the_plain_versions_result(L, pos, window, S):
    """float32: the emulation within the float32 order tolerance of the
    plain version (the ring's empty slots hold NaN, which the plan never
    reads)."""
    args = list(_inputs(torch.float32, B=2, L=L, seed=4))
    want = km.mla_decode_torch(*args, pos, scale=0.3, window=window)
    read = {j for split in _plan(L, pos, window, S) for j in split}
    for t in (2, 3):
        args[t] = args[t].clone()
        args[t][:, sorted(set(range(L)) - read)] = float("nan")
    got = _emulate(*args, pos, 0.3, window, S)
    top = float(want.abs().max())
    assert torch.allclose(got, want, rtol=F32_RTOL, atol=F32_ATOL_SHARE * top)


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda:0")


def _close(got, want, dtype):
    rtol, share = ((BF16_RTOL, BF16_ATOL_SHARE) if dtype == torch.bfloat16
                   else (F32_RTOL, F32_ATOL_SHARE))
    want = want.float()
    tol = rtol * want.abs() + share * float(want.abs().max())
    return bool(((got.float() - want).abs() <= tol).all())


#: (decode_pos, window) at dsv3-decode's ring of 4,608: 1, 1,000, 2,350
#: and 4,608 filled slots, a wrapped ring, a window
DSV3_CASES = [(0, None), (999, None), (2349, None), (4607, None),
              (4608 + 1233, None), (3000, 700)]


@pytest.mark.card
def test_the_kernel_matches_the_plain_version_at_deepseek_v3_widths(card):
    args = _inputs(torch.bfloat16, **DSV3, device=card)
    with torch.no_grad():
        for pos, window in DSV3_CASES:
            p = torch.tensor(pos, device=card)
            want = km.mla_decode_torch(*args, p, scale=DSV3_SCALE,
                                       window=window)
            got = ops.mla_decode(*args, p, scale=DSV3_SCALE, window=window)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == want.shape
            assert _close(got, want, torch.bfloat16), (pos, window)


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 2])
@pytest.mark.parametrize("widths", [dict(H=4, R=64, P=16, N=32, V=32),
                                    dict(H=4, R=32, P=16, N=16, V=16),
                                    dict(H=20, R=512, P=64, N=128, V=128)])
def test_the_kernel_matches_the_plain_version_at_other_widths(card, B,
                                                              widths):
    """The smoke and small presets' widths, and a head count that leaves
    a part-filled head tile, one and two batch rows."""
    args = _inputs(torch.bfloat16, B=B, L=256, seed=3, device=card,
                   **widths)
    with torch.no_grad():
        for pos, window in ((0, None), (40, None), (300, None), (300, 50)):
            want = km.mla_decode_torch(*args, pos, scale=0.3, window=window)
            got = ops.mla_decode(*args, pos, scale=0.3, window=window)
            torch.cuda.synchronize()
            assert _close(got, want, torch.bfloat16), (pos, window)


@pytest.mark.card
def test_nan_outside_the_mask_changes_nothing(card):
    args = list(_inputs(torch.bfloat16, **DSV3, device=card))
    with torch.no_grad():
        for pos, window in DSV3_CASES:
            p = torch.tensor(pos, device=card)
            clean = ops.mla_decode(*args, p, scale=DSV3_SCALE, window=window)
            k_pos, valid = attention._ring_positions(4608, pos + 1, card)
            keep = valid & ((pos - k_pos) < (window or 4608))
            dirty = list(args)
            for t in (2, 3):
                dirty[t] = args[t].clone()
                dirty[t][:, ~keep] = float("nan")
            got = ops.mla_decode(*dirty, p, scale=DSV3_SCALE, window=window)
            torch.cuda.synchronize()
            assert torch.equal(got, clean), (pos, window)


@pytest.mark.card
def test_two_calls_bit_equal_and_a_replay_after_a_new_position(card):
    args = _inputs(torch.bfloat16, **DSV3, device=card)
    pos = torch.tensor(1000, device=card)
    with torch.no_grad():
        first = ops.mla_decode(*args, pos, scale=DSV3_SCALE)
        again = ops.mla_decode(*args, pos, scale=DSV3_SCALE)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        graph = ops.CountedGraph(
            lambda: ops.mla_decode(*args, pos, scale=DSV3_SCALE), card)
        for p in (10, 2349, 4607, 9000):
            pos.fill_(p)
            out = graph.replay()
            want = ops.mla_decode(*args, p, scale=DSV3_SCALE)
            torch.cuda.synchronize()
            assert torch.equal(out, want), p


@pytest.mark.card
def test_launches_are_counted_eagerly_and_at_each_replay(card):
    args = _inputs(torch.bfloat16, device=card)
    pos = torch.tensor(5, device=card)
    with torch.no_grad():
        ops.mla_decode(*args, pos, scale=0.3)         # loads the module
        ops.reset_launches()
        ops.mla_decode(*args, pos, scale=0.3)
        assert ops.launches()["mla_decode"] == 3
        graph = ops.CountedGraph(lambda: ops.mla_decode(*args, pos,
                                                        scale=0.3), card)
        assert graph.captured == {"mla_decode": 3}
        graph.replay()
        graph.replay()
        torch.cuda.synchronize()
    assert ops.launches() == dict({k: 0 for k in ops.launches()},
                                  mla_decode=9)


@pytest.mark.card
def test_a_served_decode_goes_through_the_kernel(card):
    """DeepSeek-V3's smoke preset in bf16 through ``ServingEngine`` on the
    card: every decode step's MLA layers launch the kernel (counted at
    the graphs' replays: three a layer and step), and the tokens equal
    those of the eager prefill and decode steps (the kernel launched
    outside a graph, the position an int).  The same serve in float32
    takes the plain version and launches none."""
    from repro_torch.models import init_model
    from repro_torch.runtime.steps import make_decode_step, make_prefill_step
    from repro_torch.serving import Request, ServingEngine
    steps, cache_len = 6, 64
    reqs = [Request(i, np.arange(1, 17, dtype=np.int32) * (i + 3) % 500,
                    steps) for i in range(2)]

    def serve(cfg):
        params = init_model(cfg, torch.Generator(device=card).manual_seed(0),
                            device=card)
        eng = ServingEngine(cfg, params=params, n_replicas=1,
                            cache_len=cache_len, device=card)
        eng.warmup(16)
        torch.cuda.synchronize()
        ops.reset_launches()
        out = eng.serve(reqs)["responses"]
        torch.cuda.synchronize()
        return params, {r.rid: r.tokens.tolist() for r in out}, ops.launches()

    smoke = get_config("deepseek-v3-671b", preset="smoke")
    cfg = smoke.replace(dtype="bfloat16", param_dtype="bfloat16")
    params, served, launches = serve(cfg)
    layers = len(cfg.layer_specs())
    assert launches["mla_decode"] == 3 * layers * steps * len(reqs)
    prefill = make_prefill_step(cfg, cache_len=cache_len)
    decode = make_decode_step(cfg)
    with torch.no_grad():
        for r in reqs:
            toks = torch.as_tensor(np.asarray(r.tokens, np.int64),
                                   device=card)[None]
            logits, cache = prefill(params, {"tokens": toks})
            nxt, got = torch.argmax(logits, -1)[:, None], []
            for i in range(steps):
                got.append(int(nxt[0, 0]))
                logits, cache = decode(params, {
                    "tokens": nxt, "cache": cache,
                    "decode_pos": toks.shape[1] + i})
                nxt = torch.argmax(logits, -1)[:, None]
            assert got == served[r.rid], r.rid
    assert serve(smoke)[2]["mla_decode"] == 0
