"""The routed-experts kernel of decode-shaped MoE layers
(``kernels.routed_experts``, ``csrc/routed_experts.cu``) and the rule
that sends ``models.moe._moe_routed`` to it.

On the CPU: ``moe._expert_ffn`` takes the kernel exactly for CUDA
tensors at C <= ``MAX_SLOTS`` with no gradient to record;
``_moe_routed`` then hands the kernel's dispatch its dispatch slots and
combine weights, and the result is the same; the plain version equals
the three batched products the layer took before the kernel, bit for
bit, on the slots the served path builds (empty slots, untouched
experts, a held share of DeepSeek-V3's experts); the
wrapper refuses a wrong dtype, shape or a non-contiguous stack before
any launch, launches nothing for no expert, and sizes its grid and
scratch as the kernel reads them; ``runtime.steps.MoEGraph`` adds the
launches it captured at each replay; an emulation of the kernel's
stream-K split covers every row chunk of every tile once, and each cut
tile's finisher reads back exactly the partials its contributors
wrote.

Tests marked ``card`` need a CUDA device and skip without one
(``python -m pytest -m card tests/test_torch_routed_experts.py`` on a
machine with an H100): the kernel against the plain version at grok-1's and
DeepSeek-V3's decode shapes with 0, 1 and 2 touched experts, two calls
bit-equal, NaN weights in every untouched expert changing nothing, and
a CUDA graph of the call replayed with new routing equal to the eager
call."""
import dataclasses
from types import SimpleNamespace

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.kernels import build, ops
from repro_torch.kernels import routed_experts as kr
from repro_torch.models import moe

#: every element within two bf16 ulps of its own value plus 1/256 of the
#: output's largest magnitude: the kernel and torch.bmm add each float32
#: dot product in other orders, so a gate or up value near a rounding
#: boundary may round to the neighbouring bf16, and y rounds once more
BF16_RTOL, BF16_ATOL_SHARE = 2.0 ** -7, 2.0 ** -8


# ------------------------------------------------------------------ rule
def _stand_in(device, C, requires_grad=False):
    return SimpleNamespace(device=torch.device(device),
                           is_cuda=device == "cuda", shape=(8, C, 64),
                           requires_grad=requires_grad)


def _stacks(requires_grad=False):
    return {k: SimpleNamespace(requires_grad=requires_grad)
            for k in ("w_gate", "w_up", "w_down")}


def _path(monkeypatch, x_disp, we):
    """The implementation ``moe._expert_ffn`` reaches for ``x_disp``:
    the kernel's wrapper, or the plain version."""
    monkeypatch.setattr(ops, "routed_expert_ffn_cuda", lambda *a: "kernel")
    monkeypatch.setattr(ops, "routed_expert_ffn_torch", lambda *a: "plain")
    monkeypatch.setattr(kr, "routed_expert_ffn_torch", lambda *a: "plain")
    return moe._expert_ffn(we, x_disp, None)


@pytest.mark.parametrize("device,C,grad_mode,w_grad,takes", [
    ("cuda", 4, False, False, True),          # decode on a card
    ("cuda", 1, False, False, True),
    ("cuda", kr.MAX_SLOTS, False, False, True),
    ("cuda", kr.MAX_SLOTS + 1, False, False, False),
    ("cuda", 2048, False, False, False),      # prefill
    ("cpu", 4, False, False, False),          # the CPU: torch.bmm
    ("meta", 4, False, False, False),         # the cost model: torch.bmm
    ("cuda", 4, True, True, False),           # training
    ("cuda", 4, True, False, True),           # grad mode, nothing to record
    ("cuda", 4, False, True, True)])          # no_grad over trained leaves
def test_the_kernel_path_is_taken_for_cuda_decode_shapes_without_grad(
        monkeypatch, device, C, grad_mode, w_grad, takes):
    with torch.set_grad_enabled(grad_mode):
        path = _path(monkeypatch, _stand_in(device, C), _stacks(w_grad))
    assert (path == "kernel") is takes


def test_an_input_that_records_a_gradient_keeps_bmm(monkeypatch):
    with torch.enable_grad():
        assert _path(monkeypatch, _stand_in("cuda", 4, True),
                     _stacks()) == "plain"


def _cfg(arch, dtype, **moe_changes):
    preset = "small" if arch == "deepseek-v3-671b" else "smoke"
    cfg = get_config(arch, preset=preset)
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, **moe_changes))
    if dtype == "bfloat16":
        cfg = cfg.replace(dtype="bfloat16", param_dtype="bfloat16")
    return cfg


#: grok-1's wide experts, all held; DeepSeek-V3's narrow ones, 4 of 16
#: held (``expert_first`` 4, ``n_held`` 4: the overflow slot takes the
#: pairs held elsewhere)
CASES = [("grok-1-314b", {}), ("deepseek-v3-671b",
                               {"expert_first": 4, "n_held": 4})]


def _served_slots(cfg, x, monkeypatch):
    """``moe.apply_moe`` on ``x`` with the rule patched to take the
    kernel's dispatch, which records its arguments and answers with the
    plain version; returns the layer's output and the calls."""
    calls = []

    def record(x_disp, slot_w, w_gate, w_up, w_down):
        calls.append((x_disp, slot_w, w_gate, w_up, w_down))
        return kr.routed_expert_ffn_torch(x_disp, slot_w, w_gate, w_up,
                                          w_down)

    monkeypatch.setattr(moe, "_decode_shaped", lambda x_disp, we: True)
    monkeypatch.setattr(moe.ops, "routed_expert_ffn", record)
    out, _ = moe.apply_moe(_params(cfg), cfg, x)
    monkeypatch.undo()
    return out, calls


def _params(cfg):
    g = torch.Generator().manual_seed(3)
    return moe.init_moe(g, cfg)


def _tokens(cfg, B, S, seed=5):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((B, S, cfg.d_model), generator=g).to(
        getattr(torch, cfg.dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,share", CASES)
@pytest.mark.parametrize("B,S", [(1, 1), (2, 1), (1, 5)])
def test_moe_routed_hands_the_kernel_its_slots_and_keeps_its_result(
        monkeypatch, arch, share, dtype, B, S):
    """With the rule patched to say "kernel", the layer calls
    ``ops.routed_expert_ffn`` once a token pool with that pool's (E, C,
    d) slots and (E * C,) weights and the held stacks, and its output
    equals the unpatched layer's bit for bit.  The real rule on CPU
    tensors takes the plain version."""
    cfg = _cfg(arch, dtype, **share)
    x = _tokens(cfg, B, S)
    want, _ = moe.apply_moe(_params(cfg), cfg, x)
    got, calls = _served_slots(cfg, x, monkeypatch)
    assert torch.equal(got, want)
    pools = B if cfg.moe.dispatch == "batched" else 1
    E, C = moe.held_count(cfg.moe), moe.capacity(B * S // pools, cfg.moe)
    assert len(calls) == pools
    for x_disp, slot_w, *stacks in calls:
        assert x_disp.shape == (E, C, cfg.d_model)
        assert slot_w.shape == (E * C,) and slot_w.dtype == torch.float32
        assert [w.shape[0] for w in stacks] == [E] * 3
    seen = []
    monkeypatch.setattr(moe.ops, "routed_expert_ffn",
                        lambda *a: seen.append(a))
    again, _ = moe.apply_moe(_params(cfg), cfg, x)
    assert not seen and torch.equal(again, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch,share", CASES)
def test_the_plain_version_is_expert_ffn_bit_for_bit(monkeypatch, arch,
                                                     share, dtype):
    """On the slots the served path builds, with empty slots and
    untouched experts among them, the plain version equals the three
    batched products the layer took before the kernel (``bmm_ffn``), bit
    for bit: CPU results are unchanged."""
    def bmm_ffn(we, x_disp):
        gate = torch.nn.functional.silu(torch.bmm(x_disp, we["w_gate"]))
        up = torch.bmm(x_disp, we["w_up"])
        return torch.bmm(gate * up, we["w_down"])

    cfg = _cfg(arch, dtype, **share)
    _, calls = _served_slots(cfg, _tokens(cfg, 2, 1), monkeypatch)
    _, more = _served_slots(cfg, _tokens(cfg, 1, 5, seed=8), monkeypatch)
    empty = untouched = 0
    for x_disp, slot_w, w_gate, w_up, w_down in calls + more:
        E, C, _ = x_disp.shape
        occupied = (slot_w > 0).reshape(E, C)
        empty += int((~occupied).sum())
        untouched += int((~occupied.any(1)).sum())
        we = {"w_gate": w_gate, "w_up": w_up, "w_down": w_down}
        assert torch.equal(
            kr.routed_expert_ffn_torch(x_disp, slot_w, w_gate, w_up, w_down),
            bmm_ffn(we, x_disp))
    assert empty and untouched


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    def no_build(*a, **k):
        raise AssertionError("a CPU tensor reached the kernel loader")

    monkeypatch.setattr(build, "function", no_build)
    before = ops.launches()
    args = _args()
    assert torch.equal(ops.routed_expert_ffn(*args),
                       kr.routed_expert_ffn_torch(*args))
    assert ops.launches() == before


class _Graph:
    """A stand-in for ``torch.cuda.CUDAGraph``: a replay runs nothing."""

    def replay(self):
        pass


class _NoDevice:
    """A stand-in for ``torch.cuda.device`` on a CPU tensor's device:
    entering it changes nothing."""

    def __init__(self, device):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def test_moe_graph_counts_its_captured_launches_at_each_replay(monkeypatch):
    """``MoEGraph``: the eager call counts the wrapper's two launches;
    the capture's own count is taken back (nothing ran) and kept; each
    replay adds it.  The capture is stood in by an eager run of its body
    and the kernel's dispatch by one that counts as the wrapper does."""
    from contextlib import nullcontext
    from repro_torch.runtime.steps import MoEGraph

    def counting(*args):
        kr.LAUNCHES += 2
        return kr.routed_expert_ffn_torch(*args)

    cfg = _cfg("grok-1-314b", "float32")
    p, x = _params(cfg), _tokens(cfg, 1, 1)
    monkeypatch.setattr(moe, "_decode_shaped", lambda x_disp, we: True)
    monkeypatch.setattr(moe.ops, "routed_expert_ffn", counting)
    monkeypatch.setattr(torch.cuda, "CUDAGraph", _Graph)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda graph, pool=None: nullcontext())
    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    w, idx, _ = moe.route(x[0], p["router"]["w"], cfg.moe)
    experts = MoEGraph()
    ops.reset_launches()
    want = experts(p, cfg, x, [(w, idx)])
    assert ops.launches()["routed_experts"] == 2
    out = experts.capture(p, cfg, x, None)
    assert experts.graph.captured == {"routed_experts": 2}
    assert ops.launches()["routed_experts"] == 2 and torch.equal(out, want)
    for n in (4, 6):
        experts(p, cfg, x, [(w, idx)])
        assert ops.launches()["routed_experts"] == n
    assert set(ops.launches().values()) - {0} == {6}


# --------------------------------------------------------------- wrapper
def _args(E=4, C=4, d=32, f=64, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(1)
    rnd = lambda *s: torch.randn(s, generator=g).to(dtype)  # noqa: E731
    slot_w = torch.zeros(E * C)
    slot_w[[0, 5]] = 0.5
    return (rnd(E, C, d), slot_w, rnd(E, d, f), rnd(E, d, f), rnd(E, f, d))


def _stub_launch(monkeypatch):
    """The launcher stubbed (it records its arguments) and the device
    check passed on CPU tensors, so the wrapper runs to its launch."""
    launched = []
    monkeypatch.setattr(build, "function", lambda *a, **k: (
        lambda *args: launched.append(args) or 0))
    monkeypatch.setattr(build, "cuda_device",
                        lambda what, *t: torch.device("cpu"))
    monkeypatch.setattr(build, "stream", lambda dev: 0)
    monkeypatch.setitem(kr._sms, None, 132)
    return launched


def _swap(args, i, new):
    return args[:i] + (new,) + args[i + 1:]


REFUSED = {
    "up stack float32": lambda a: _swap(a, 3, a[3].float()),
    "x float16": lambda a: _swap(a, 0, a[0].half()),
    "slot_w float64": lambda a: _swap(a, 1, a[1].double()),
    "down stack not (E, f, d)": lambda a: _swap(a, 4, a[4][:, :32]),
    "slot_w not E * C": lambda a: _swap(a, 1, a[1][:-1]),
    "x not 3-d": lambda a: _swap(a, 0, a[0][0]),
    "gate stack not contiguous": lambda a: _swap(
        a, 2, a[2].transpose(1, 2).contiguous().transpose(1, 2)),
    "gate stack off 16 bytes": lambda a: _swap(
        a, 2, torch.empty(a[2].numel() + 1, dtype=a[2].dtype)[1:].view(
            a[2].shape)),
    "C past MAX_SLOTS": lambda a: _args(C=kr.MAX_SLOTS + 1),
    "d not a multiple of 8": lambda a: _args(d=36),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_the_wrapper_refuses_before_any_launch(monkeypatch, case):
    launched = _stub_launch(monkeypatch)
    before = ops.launches()
    with pytest.raises(ValueError):
        kr.routed_expert_ffn_cuda(*REFUSED[case](_args()))
    assert not launched and ops.launches() == before


def test_no_expert_launches_nothing(monkeypatch):
    launched = _stub_launch(monkeypatch)
    before = ops.launches()
    y = kr.routed_expert_ffn_cuda(*(a[:0] for a in _args()))
    assert y.shape == (0, 4, 32) and not launched
    assert ops.launches() == before


@pytest.mark.parametrize("dtype,C,tw", [(torch.bfloat16, 4, 256),
                                        (torch.bfloat16, 3, 256),
                                        (torch.bfloat16, 2, 256),
                                        (torch.float32, 4, 128),
                                        (torch.float32, 2, 128)])
def test_the_wrapper_sizes_grid_and_scratch_as_the_kernel_reads_them(
        monkeypatch, dtype, C, tw):
    """One block an SM; part: grid x 2 slots x 2 matrices x C x TW
    floats; tickets: E x (the gate/up tiles + the down tiles), zeroed;
    two launches counted."""
    launched = _stub_launch(monkeypatch)
    E, d, f = 3, 40, 520
    before = ops.launches()["routed_experts"]
    y = kr.routed_expert_ffn_cuda(*_args(E=E, C=C, d=d, f=f, dtype=dtype))
    assert kr.tile_cols(dtype) == tw
    (args,) = launched
    assert args[5:11] == (E, C, d, f, kr._DTYPES[dtype], 132)
    assert args[12] == 132 * 4 * C * tw
    assert args[14] == E * (-(-f // tw) + -(-d // tw))
    assert y.shape == (E, C, d) and y.dtype == dtype
    assert ops.launches()["routed_experts"] == before + 2


# -------------------------------------------------------------- stream-K
MIN_ROWS = 512       # csrc/routed_experts.cu's kMinRows


def _stream_k(n_active, n_tiles, ipt, rows, grid):
    """csrc/routed_experts.cu's split of a launch's n_active x n_tiles x
    ipt chunks of ``rows`` rows over at most ``grid`` blocks, in its own
    integer arithmetic: each block's segments, and for each cut tile the
    partials its contributors write (block, slot) and those its finisher
    reads."""
    total = n_active * n_tiles * ipt
    G = min(grid, max(1, total * rows // MIN_ROWS))
    start = lambda b: b * total // G                   # noqa: E731
    block_of = lambda i: ((i + 1) * G - 1) // total    # noqa: E731
    covered, written, whole = [], {}, []
    for b in range(G if total else 0):
        lo, hi = start(b), start(b + 1)
        assert hi > lo                                 # no empty block
        it = lo
        while it < hi:
            tile = it // ipt
            tb, te = tile * ipt, tile * ipt + ipt
            se = min(hi, te)
            covered += [(tile, i - tb) for i in range(it, se)]
            if it == tb and se == te:
                whole.append(tile)
            else:
                written.setdefault(tile, []).append(
                    (b, 0 if lo >= tb else 1))
            it = se
    read = {}
    for tile in written:
        tb = tile * ipt
        bf, bl = block_of(tb), block_of(tb + ipt - 1)
        read[tile] = [(bb, 0 if start(bb) >= tb else 1)
                      for bb in range(bf, bl + 1)]
    return covered, written, read, whole, total


@pytest.mark.parametrize("n_active", [0, 1, 2, 3, 8])
@pytest.mark.parametrize("n_tiles,ipt,rows", [
    (128, 96, 64),      # grok-1 gate/up: f = 32768 / 256, d = 6144 / 64
    (24, 512, 64),      # grok-1 down: d = 6144 / 256, f = 32768 / 64
    (8, 112, 64),       # DeepSeek-V3 gate/up: f = 2048 / 256, d = 7168 / 64
    (28, 32, 64),       # DeepSeek-V3 down
    (4, 8, 64), (2, 8, 64), (1, 1, 64), (3, 7, 64)])
def test_stream_k_covers_each_chunk_once_and_finishes_each_cut_tile(
        n_active, n_tiles, ipt, rows):
    covered, written, read, whole, total = _stream_k(n_active, n_tiles,
                                                     ipt, rows, 264)
    assert sorted(covered) == [(t, i) for t in range(n_active * n_tiles)
                               for i in range(ipt)]
    assert set(written) | set(whole) == set(range(n_active * n_tiles))
    assert not set(written) & set(whole)
    for tile, ws in written.items():
        assert len(ws) >= 2 and read[tile] == ws      # the ticket count too
    slots = [w for ws in written.values() for w in ws]
    assert len(slots) == len(set(slots))              # no partial overwritten


# ------------------------------------------------------------------ card
@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel runs only on the card")
    return torch.device("cuda:0")


def _problem(card, E, C, d, f, touched, seed=0, slots=(0, 1)):
    """bf16 stacks of N(0, 1/fan-in) weights, and dispatch slots in which
    each expert of ``touched`` holds a token in ``slots`` (the others
    empty, their rows zero)."""
    g = torch.Generator(device=card).manual_seed(seed)

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=card) * scale).to(
            torch.bfloat16)

    stacks = (rnd(E, d, f, scale=d ** -0.5), rnd(E, d, f, scale=d ** -0.5),
              rnd(E, f, d, scale=f ** -0.5))
    slot_w = torch.zeros(E * C, device=card)
    for e in touched:
        for c in slots:
            slot_w[e * C + c] = 0.25 + 0.5 * c
    x = rnd(E, C, d) * (slot_w.reshape(E, C, 1) > 0).to(torch.bfloat16)
    return x, slot_w, stacks


def _close(got, want):
    tol = BF16_RTOL * want.float().abs() + BF16_ATOL_SHARE * float(
        want.float().abs().max())
    return bool(((got.float() - want.float()).abs() <= tol).all())


SHAPES = {"grok-1": (8, 4, 6144, 32768), "deepseek-v3": (8, 4, 7168, 2048)}


@pytest.mark.card
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_the_kernel_matches_expert_ffn_at_decode_shapes_on_the_card(
        card, shape):
    """0, 1 and 2 touched experts: within the bf16 tolerance of the
    plain version (zero where it is zero: every empty slot and idle
    expert), two calls bit-equal; then every untouched expert's weights
    set to NaN: the output stays finite and bit-equal."""
    E, C, d, f = SHAPES[shape]
    for touched in ((), (5,), (2, 7)):
        x, slot_w, stacks = _problem(card, E, C, d, f, touched)
        with torch.no_grad():
            want = kr.routed_expert_ffn_torch(x, slot_w, *stacks)
            got = ops.routed_expert_ffn(x, slot_w, *stacks)
            again = ops.routed_expert_ffn(x, slot_w, *stacks)
            torch.cuda.synchronize()
            assert got.dtype == torch.bfloat16 and got.shape == (E, C, d)
            assert _close(got, want), (shape, touched)
            empty = (slot_w.reshape(E, C) <= 0)
            assert not got[empty].any() and not want[empty].any()
            assert torch.equal(got, again)
            for e in set(range(E)) - set(touched):
                for w in stacks:
                    w[e].fill_(float("nan"))
            nan = ops.routed_expert_ffn(x, slot_w, *stacks)
            torch.cuda.synchronize()
        assert torch.isfinite(nan.float()).all() and torch.equal(nan, got)
        del x, slot_w, stacks, want, got, again, nan
        torch.cuda.empty_cache()


@pytest.mark.card
def test_a_graph_of_the_call_replays_new_routing_as_the_eager_call(card):
    """Captured with two touched experts and replayed after new slots
    (other experts, other rows, another count of them) are copied into
    its inputs, the graph gives the eager call's bits."""
    E, C, d, f = 8, 4, 1024, 2048
    x, slot_w, stacks = _problem(card, E, C, d, f, (1, 6))
    with torch.no_grad():
        ops.routed_expert_ffn(x, slot_w, *stacks)      # loads the module
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = ops.routed_expert_ffn(x, slot_w, *stacks)
        for touched, slots in (((0, 3, 4), (0, 2)), ((7,), (3,)), ((), ())):
            nx, nw, _ = _problem(card, E, C, d, f, touched, seed=9,
                                 slots=slots)
            x.copy_(nx)
            slot_w.copy_(nw)
            graph.replay()
            want = ops.routed_expert_ffn(x, slot_w, *stacks)
            torch.cuda.synchronize()
            assert torch.equal(out, want), touched
