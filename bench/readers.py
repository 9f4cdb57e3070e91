"""Arithmetic the per-layer readers (``metrics/<name>.py``) share.  A
reader gets the run's context and the system module's output (``trace``: the
``TraceReading`` of the traced window; ``spans``: the harness's spans
inside it) and returns its number, or None where the window holds
nothing to read.  ``metrics/<family>.py`` reads every metric named
``<family>.<cells>`` that has no file of its own."""
from __future__ import annotations

from . import cost


def spans(out, name):
    return [s for s in out.get("spans", ()) if s[0] == name]


def per_unit_ms(out, name, units):
    """Host ms of the spans named ``name`` over the units they did."""
    ss = spans(out, name)
    n = sum(units(s) for s in ss)
    if not n:
        return None
    return 1e3 * sum(s[2] - s[1] for s in ss) / n


def roofline_percent(least_s, device_s):
    """A kernel's least time over its device time, in %; None where the
    kernel did not run in the window."""
    if not device_s or not least_s:
        return None
    return 100.0 * least_s / device_s


def mfu_percent(flops, window_s, peak_key):
    if not flops:
        return None
    return 100.0 * flops / (window_s * cost.PEAKS[peak_key])
