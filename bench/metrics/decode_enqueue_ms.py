"""Host ms to enqueue one decode step: the program's ``repro.llm.decode``
ranges (the step's launches and its argmax, with no synchronize) over
their count."""
from bench import ranges


def read(ctx, out):
    return ranges.mean_ms(out["trace"], "repro.llm.decode")
