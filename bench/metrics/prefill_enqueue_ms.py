"""Host ms to enqueue one prefill: the program's ``repro.llm.prefill``
ranges (the prompt's copy to the device, the prefill step's launches and
its argmax, with no synchronize) over their count."""
from bench import ranges


def read(ctx, out):
    return ranges.mean_ms(out["trace"], "repro.llm.prefill")
