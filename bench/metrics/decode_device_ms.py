"""Device ms of one decode step: the device time of the work launched
inside the program's ``repro.llm.decode`` ranges (matched through the
launching runtime calls, ``TraceReading.device_s_under``) over their
count."""
from bench import ranges


def read(ctx, out):
    t = out["trace"]
    n = len(ranges.named(t, ("repro.llm.decode",)))
    if not n:
        return None
    return 1e3 * t.device_s_under("repro.llm.decode") / n
