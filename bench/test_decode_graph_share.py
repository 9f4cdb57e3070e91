"""CPU tests of ``metrics/decode_graph_share.py`` on synthetic readings:
decode ranges, some holding a graph range, inside the harness's window,
with stand-in kernels at its edges (a reading needs device events)."""
import pytest

from bench import harness
from bench.test_program_ranges import _Event
from bench.trace import TraceReading


def _reading(n_steps, n_graphed):
    """A 10 ms window of ``n_steps`` decode ranges 1 ms apart; the first
    ``n_graphed`` hold a graph range."""
    evs = [_Event(0, 10_000_000, "bench.window", False),
           _Event(0, 1, "kernel", True, -1),
           _Event(9_999_999, 10_000_000, "kernel", True, -2)]
    for i in range(n_steps):
        a = 1_000_000 * (i + 1)
        evs.append(_Event(a, a + 500_000, "repro.llm.decode", False))
        if i < n_graphed:
            evs.append(_Event(a + 10, a + 400_000, "repro.llm.decode_graph",
                              False))
    return TraceReading(evs)


@pytest.mark.parametrize("n_steps,n_graphed,want", [
    (8, 8, 100.0), (8, 4, 50.0), (0, 0, None), (8, 0, None)])
def test_decode_graph_share(n_steps, n_graphed, want):
    """100 where every decode range holds a graph range, 50 where half
    do; None where there is no decode range, or no graph range (a
    program without graphs, as before the graphed step)."""
    read = harness.load_reader("decode_graph_share")
    assert read(None, {"trace": _reading(n_steps, n_graphed)}) == want
