"""The program's own ranges in a traced window.  While a profiler is
active the port opens a host range ``repro.<name>`` around each of its
wall-clock spans and each garbage collection (``repro_torch.obs.trace``).
They are host operations, not user annotations, so they sit among the
reading's host events (``TraceReading.cpu``) and put nothing on the
device's timeline.  A program without them gives no ranges, and the
readers of them return None.  Times are the profiler's, in ns."""
from __future__ import annotations


def named(reading, names):
    """``[start, end]`` of the host ranges named one of ``names``, cut
    to the window."""
    w0, w1 = reading.w0, reading.w1
    return [(max(a, w0), min(b, w1)) for a, b, name, *_ in reading.cpu
            if name in names and b > w0 and a < w1]


def union(ivs):
    out = []
    for a, b in sorted(ivs):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def measure(ivs) -> int:
    return sum(b - a for a, b in union(ivs))


def minus(outer, inner) -> int:
    """ns inside ``outer`` and outside ``inner``: one sweep over both
    unions."""
    outer, inner = union(outer), union(inner)
    cut, j = 0, 0
    for a, b in outer:
        while j < len(inner) and inner[j][1] <= a:
            j += 1
        k = j
        while k < len(inner) and inner[k][0] < b:
            cut += min(b, inner[k][1]) - max(a, inner[k][0])
            k += 1
    return measure(outer) - cut


def mean_ms(reading, name):
    """Mean host ms of the ranges named ``name``; None where there are
    none."""
    ivs = named(reading, (name,))
    if not ivs:
        return None
    return sum(b - a for a, b in ivs) / len(ivs) / 1e6
