"""Host ms of the tracker a tick: the spans around
``DetectionEngine._interpolate`` (one fused tick graph a tick and the
filled frames' responses) over the ticks they ran."""
from bench import readers


def read(ctx, out):
    return readers.per_unit_ms(out, "bench.track", lambda s: s[3])
