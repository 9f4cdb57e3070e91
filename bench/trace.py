"""What a ``--trace 1`` run records, and the reading of it.

* ``Spans``: host spans that the harness puts around the calls into the
  program's layers, by wrapping the entry for the length of the run.  A
  span ends after ``torch.cuda.synchronize`` where the layer's device
  work belongs to it, and is also a ``record_function`` range, so that
  the device trace can attribute kernels to it.  A ``--trace 0`` run
  wraps nothing.
* ``DeviceTrace``: ``torch.profiler`` over a window of the run (CPU and
  CUDA activity), read from the profiler's raw events: the kernels and
  copies on the device, the runtime calls that launched them, and the
  harness's ranges.  The window keeps ``MARGIN_S`` of idle host time at
  each edge, since the profiler drops device records it places outside
  its window.
"""
from __future__ import annotations

import time
from collections import defaultdict

import torch

MARGIN_S = 0.005
LAUNCH_CALLS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                "cudaGraphLaunch", "cudaMemcpyAsync", "cudaMemsetAsync",
                "cudaLaunchCooperativeKernel")


def _sync():
    if torch.cuda.is_available():
        torch.cuda.synchronize()


class Spans:
    """Host spans: ``(name, t0, t1, info)`` in ``time.perf_counter``
    seconds."""

    def __init__(self, device):
        self.items = []
        self._sync = device.type == "cuda"
        self._undo = []

    def wrap(self, owner, attr: str, name: str, info=None, sync=True):
        """Put a span around every call of ``owner.attr`` until
        ``unwrap``; ``info(args, kwargs, result)`` adds what the reader
        needs to count.  ``sync=False`` leaves the device running at the
        span's end (its device time is read from the trace)."""
        fn = getattr(owner, attr)

        def spanned(*a, **kw):
            with torch.profiler.record_function(name):
                t0 = time.perf_counter()
                out = fn(*a, **kw)
                if sync and self._sync:
                    torch.cuda.synchronize()
                t1 = time.perf_counter()
            self.items.append((name, t0, t1,
                               info(a, kw, out) if info else None))
            return out

        setattr(owner, attr, spanned)
        self._undo.append((owner, attr, fn))

    def unwrap(self):
        for owner, attr, fn in reversed(self._undo):
            setattr(owner, attr, fn)
        self._undo.clear()

    def between(self, name: str, t0: float, t1: float):
        return [s for s in self.items if s[0] == name and s[1] >= t0
                and s[2] <= t1]


class DeviceTrace:
    """``start``/``stop`` around the traced window; then ``read``."""

    def __init__(self):
        self.prof = None
        self.t0 = self.t1 = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        time.sleep(MARGIN_S)
        self._range = torch.profiler.record_function("bench.window")
        self._range.__enter__()
        _sync()
        self.t0 = time.perf_counter()

    def stop(self):
        _sync()
        self.t1 = time.perf_counter()
        self._range.__exit__(None, None, None)
        time.sleep(MARGIN_S)
        self.prof.__exit__(None, None, None)

    def read(self) -> "TraceReading":
        return TraceReading(self.prof.profiler.kineto_results.events())


class TraceReading:
    """The device events of the window and the host ranges over them, in
    the profiler's clock (ns)."""

    def __init__(self, events):
        cpu, dev = [], []
        for e in events:
            if e.name().startswith("bench."):
                if e.device_type() == torch.autograd.DeviceType.CUDA:
                    continue        # a range's mirror on the device
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name(), e.correlation_id()))
            else:
                cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                            e.name(), e.correlation_id(),
                            e.start_thread_id()))
        win = [c for c in cpu if c[2] == "bench.window"]
        if not win:
            raise RuntimeError("the trace has no window range")
        self.w0, self.w1 = win[0][0], win[0][1]
        self.device = sorted(d for d in dev
                             if d[1] > self.w0 and d[0] < self.w1)
        self.cpu = cpu
        if not self.device:
            raise RuntimeError("the trace recorded no device event")

    @property
    def window_s(self) -> float:
        return (self.w1 - self.w0) / 1e9

    def busy_intervals(self):
        out = []
        for a, b, _, _ in self.device:
            a, b = max(a, self.w0), min(b, self.w1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_s(self, needle: str) -> float:
        """Device seconds of the events whose name holds ``needle``."""
        return sum(b - a for a, b, n, _ in self.device if needle in n) / 1e9

    def kernel_count(self, needle: str) -> int:
        return sum(needle in n for _, _, n, _ in self.device)

    def device_s_under(self, span: str) -> float:
        """Device seconds of the work launched inside the host ranges
        named ``span`` (matched through the launching runtime calls)."""
        ranges = sorted((c[0], c[1], c[4]) for c in self.cpu
                        if c[2] == span)
        if not ranges:
            return 0.0
        corr = set()
        import bisect
        starts = [r[0] for r in ranges]
        for a, _, name, cid, tid in self.cpu:
            if not name.startswith(LAUNCH_CALLS):
                continue
            i = bisect.bisect_right(starts, a) - 1
            if i >= 0 and a <= ranges[i][1] and tid == ranges[i][2]:
                corr.add(cid)
        return sum(b - a for a, b, _, cid in self.device
                   if cid in corr) / 1e9

    def top_ops(self, n: int = 10):
        tot = defaultdict(int)
        for a, b, name, _ in self.device:
            tot[name] += b - a
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:160], t / 1e9] for name, t in rows]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest device idle gaps inside the window, each
        named by the host: the innermost harness range and the innermost
        host operation running at the gap's middle."""
        busy = self.busy_intervals()
        edges = [self.w0] + [x for iv in busy for x in iv] + [self.w1]
        gaps = sorted(((edges[i + 1] - edges[i], edges[i])
                       for i in range(0, len(edges), 2)
                       if edges[i + 1] > edges[i]), reverse=True)[:n]
        host = sorted((c for c in self.cpu
                       if not c[2].startswith(LAUNCH_CALLS)),
                      key=lambda c: c[0])
        out = []
        for length, start in gaps:
            mid = start + length // 2
            spans = [c for c in host if c[0] <= mid <= c[1]
                     and c[2] != "bench.window"]
            bench = [c for c in spans if c[2].startswith("bench.")]
            ops = [c for c in spans if not c[2].startswith("bench.")]
            label = "/".join(
                x for x in (min(bench, key=lambda c: c[1] - c[0])[2]
                            if bench else "harness",
                            min(ops, key=lambda c: c[1] - c[0])[2]
                            if ops else "python") if x)
            out.append([label[:160], length / 1e9])
        return out
