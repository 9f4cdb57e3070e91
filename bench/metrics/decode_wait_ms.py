"""Host ms a decode step waits on the device: the program's
``repro.llm.read`` ranges (each blocking read of a token and each
request's final synchronize) over the count of its ``repro.llm.decode``
ranges.  ``decode_enqueue_ms`` plus this is the host's time a token."""
from bench import ranges


def read(ctx, out):
    t = out["trace"]
    steps = len(ranges.named(t, ("repro.llm.decode",)))
    if not steps:
        return None
    reads = ranges.named(t, ("repro.llm.read",))
    return sum(b - a for a, b in reads) / steps / 1e6
