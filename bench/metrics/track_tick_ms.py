"""Host ms of one tracker tick: the program's ``repro.track.tick``
ranges (a ``TickPipeline`` call: rows in, the graph replay, outputs
back) over their count.  ``track_ms_per_tick`` minus this is the fill's
own Python."""
from bench import ranges


def read(ctx, out):
    return ranges.mean_ms(out["trace"], "repro.track.tick")
