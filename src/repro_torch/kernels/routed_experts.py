"""The routed experts of a decode-shaped MoE layer: the plain PyTorch
version and the wrapper of the hand-written CUDA kernel
(``csrc/routed_experts.cu``).

Both compute an MoE layer's expert products over its dispatch slots,
x_disp (E, C, d) -> y (E, C, d), for each expert e::

    y[e] = (silu(x_disp[e] @ w_gate[e]) * (x_disp[e] @ w_up[e])) @ w_down[e]

with w_gate, w_up (E, d, f) and w_down (E, f, d).  ``slot_w`` (E * C,
float32) holds each slot's combine weight, as ``models.moe``'s dispatch
writes it: a slot whose weight is not > 0 holds no token, and its row
of x_disp is zero.  The plain version takes three batched products over
every expert and slot and reads ``slot_w`` not at all.  The CUDA kernel
reads the weights of only the experts with an occupied slot, and writes
exact zeros for the rows of every empty slot and idle expert: where the
weights are finite the two agree but for the order of float32 sums
inside each dot product.  It takes up to ``MAX_SLOTS`` slots an expert.
The plain version is the one implementation of the batched products:
``models.moe._expert_ffn`` calls it wherever the kernel is not taken.

The JAX package has no kernel here (it leaves the expert products to
XLA), so this one replaces none.  ``LAUNCHES`` counts the CUDA wrapper's
kernel launches: two a call, the gate-and-up pass and the down product.
"""
from __future__ import annotations

import ctypes

import torch

from ..device import ieee_float32
from . import build

LAUNCHES = 0     # kernel launches made by routed_expert_ffn_cuda
# Decode's slots an expert: ``models.moe.capacity`` gives at least 4, and
# exactly 4 to a one-token pool.  The kernel is built for that shape
# alone.  Past it, a prefill of 16 or more tokens touches every expert of
# grok-1, and torch.bmm reads all of them at ~0.95 of the HBM rate
# against the kernel's ~0.85 (PERF.md, kernel table row 9).
MAX_SLOTS = 4
MAX_EXPERTS = 1024
BLOCKS_PER_SM = 1            # the kernel's persistent grid
_sms = {}                    # device index -> its SM count


def tile_cols(dtype):
    """Output columns of one of the kernel's tiles: a warp's 32 lanes of
    VEC adjacent columns, 16 bytes of weights a lane."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    return 32 * (16 // itemsize)


def _check_shapes(x_disp, slot_w, w_gate, w_up, w_down):
    if x_disp.dim() != 3:
        raise ValueError(f"routed_expert_ffn: x_disp {tuple(x_disp.shape)} "
                         "is not (E, C, d)")
    E, C, d = x_disp.shape
    f = w_gate.shape[-1]
    if (w_gate.shape != (E, d, f) or w_up.shape != (E, d, f)
            or w_down.shape != (E, f, d) or slot_w.shape != (E * C,)):
        raise ValueError(
            f"routed_expert_ffn: x_disp {tuple(x_disp.shape)}, slot_w "
            f"{tuple(slot_w.shape)}, w_gate {tuple(w_gate.shape)}, w_up "
            f"{tuple(w_up.shape)}, w_down {tuple(w_down.shape)} are not "
            "(E, C, d), (E * C,), (E, d, f), (E, d, f), (E, f, d)")
    return E, C, d, f


def routed_expert_ffn_torch(x_disp, slot_w, w_gate, w_up, w_down):
    """Plain PyTorch version: (E, C, d) -> (E, C, d) in x_disp's dtype, one
    batched product per matrix over every expert and slot (``slot_w`` is
    checked for its shape and not read).  Float32 products in IEEE
    float32 (``device.ieee_float32``)."""
    _check_shapes(x_disp, slot_w, w_gate, w_up, w_down)
    with ieee_float32():
        gate = torch.nn.functional.silu(torch.bmm(x_disp, w_gate))
        up = torch.bmm(x_disp, w_up)
        return torch.bmm(gate * up, w_down)


_LAUNCH_ARGS = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def routed_expert_ffn_cuda(x_disp, slot_w, w_gate, w_up, w_down):
    """The CUDA kernel's wrapper: same arguments and result as
    ``routed_expert_ffn_torch``, for tensors on one CUDA device: x_disp
    and the three stacks all float32 or all bfloat16, the stacks
    contiguous and starting on 16 bytes, d and f multiples of 8, C <=
    ``MAX_SLOTS``, E <= ``MAX_EXPERTS`` (E = 0 launches nothing),
    slot_w float32.  Raises on
    anything else, on a missing kernel library and on a failed launch;
    allocates its output and scratch with torch (a CUDA graph's capture
    takes them from its pool) and reads no value of the data on the
    host."""
    global LAUNCHES
    launch = build.function("routed_experts", "routed_experts_launch",
                            _LAUNCH_ARGS)
    stacks = (w_gate, w_up, w_down)
    dev = build.cuda_device("routed_expert_ffn_cuda", x_disp, slot_w,
                            *stacks)
    E, C, d, f = _check_shapes(x_disp, slot_w, w_gate, w_up, w_down)
    dt = x_disp.dtype
    if dt not in _DTYPES or any(w.dtype != dt for w in stacks) \
            or slot_w.dtype != torch.float32:
        raise ValueError(
            "routed_expert_ffn_cuda takes x_disp and the stacks all float32 "
            "or all bfloat16 and slot_w float32, got "
            f"{[t.dtype for t in (x_disp, slot_w, *stacks)]}")
    if not all(w.is_contiguous() and w.data_ptr() % 16 == 0
               for w in stacks):
        raise ValueError("routed_expert_ffn_cuda takes contiguous weight "
                         "stacks that start on 16 bytes")
    if not (1 <= C <= MAX_SLOTS and E <= MAX_EXPERTS) \
            or d % 8 or f % 8 or not d or not f:
        raise ValueError(f"routed_expert_ffn_cuda: E={E}, C={C}, d={d}, "
                         f"f={f}; needs 1 <= C <= {MAX_SLOTS}, E <= "
                         f"{MAX_EXPERTS}, d and f multiples of 8")
    if not E:                   # no expert: nothing to launch
        return torch.empty_like(x_disp)
    x = build.operand(x_disp, align16=True)
    sw = build.operand(slot_w)
    if dev.index not in _sms:
        _sms[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    grid = BLOCKS_PER_SM * _sms[dev.index]
    tw = tile_cols(dt)
    part = torch.empty(grid * 4 * C * tw, dtype=torch.float32, device=dev)
    n_tickets = E * (-(-f // tw) + -(-d // tw))
    # zeroed at every call (in a graph, at every replay): the kernel
    # counts on them and leaves them counted
    tickets = torch.zeros(n_tickets, dtype=torch.int32, device=dev)
    h = torch.empty((E, C, f), dtype=dt, device=dev)
    y = torch.empty((E, C, d), dtype=dt, device=dev)
    err = launch(x.data_ptr(), sw.data_ptr(), w_gate.data_ptr(),
                 w_up.data_ptr(), w_down.data_ptr(), E, C, d, f, _DTYPES[dt],
                 grid, part.data_ptr(), part.numel(), tickets.data_ptr(),
                 n_tickets, h.data_ptr(), y.data_ptr(), build.stream(dev))
    build.check(err, "routed_experts_launch")
    LAUNCHES += 2
    return y
