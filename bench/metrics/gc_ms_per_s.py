"""Host ms of garbage collection a second: the program's ``repro.gc``
ranges (each collection made while the profiler runs) over the traced
window from the program's first range on.  That start leaves out the
harness's own ``gc.collect()`` that opens an NVR window after the
profiler starts, which no measured epoch waits for.  Read for every
``gc_ms_per_s.<cells>`` metric."""
from bench import ranges


def read(ctx, out):
    t = out["trace"]
    starts = [a for a, b, name, *_ in t.cpu
              if name.startswith("repro.") and name != "repro.gc"
              and b > t.w0 and a < t.w1]
    if not starts:
        return None
    t0 = max(min(starts), t.w0)
    gcs = [(max(a, t0), b) for a, b in ranges.named(t, ("repro.gc",))
           if b > t0]
    return (ranges.measure(gcs) / 1e6) / ((t.w1 - t0) / 1e9)
