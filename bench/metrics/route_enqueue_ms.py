"""Host ms of one MoE router call: the program's ``repro.moe.route``
ranges (``models.moe.route``, eager at every step, outside the decode
step's CUDA graphs) over their count; None where there are none.  Read
for every ``route_enqueue_ms.<cells>`` metric."""
from bench import ranges


def read(ctx, out):
    return ranges.mean_ms(out["trace"], "repro.moe.route")
