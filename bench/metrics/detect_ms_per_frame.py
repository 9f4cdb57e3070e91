"""Host ms of the detect layer a detected frame: the spans around
``DetectionEngine._detect_batch`` (forward, decode, NMS, the copy back;
synchronized at their end) over the real frames they carried."""
from bench import readers


def read(ctx, out):
    return readers.per_unit_ms(out, "bench.detect",
                               lambda s: sum(r >= 0 for r in s[3]))
