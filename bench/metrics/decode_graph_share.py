"""Share of decode steps replayed from CUDA graphs, in %: the program's
``repro.llm.decode_graph`` ranges (one around each step that replays)
over its ``repro.llm.decode`` ranges.  None where the window holds no
graph range (a program that never replays) or no decode range."""
from bench import ranges


def read(ctx, out):
    t = out["trace"]
    steps = len(ranges.named(t, ("repro.llm.decode",)))
    graphed = len(ranges.named(t, ("repro.llm.decode_graph",)))
    if not steps or not graphed:
        return None
    return 100.0 * graphed / steps
