"""Host ms of the runtime and scheduler a frame: the time inside the
program's ``repro.runtime.*`` ranges (ingest, micro-batch, epoch
boundary) and inside no detect, ROI or tracker range (the program's, or
the harness's wrappers around them), over the frames of the window's
``repro.runtime.ingest`` ranges (each ingest is one tick of every
camera)."""
from bench import ranges

RUNTIME = ("repro.runtime.ingest", "repro.runtime.batch",
           "repro.runtime.epoch")
INNER = ("repro.detect", "repro.roi", "repro.track", "bench.detect",
         "bench.track")


def read(ctx, out):
    t = out["trace"]
    ingests = len(ranges.named(t, ("repro.runtime.ingest",)))
    if not ingests:
        return None
    host_ns = ranges.minus(ranges.named(t, RUNTIME), ranges.named(t, INNER))
    return host_ns / 1e6 / (ingests * ctx.mix["cameras"])
