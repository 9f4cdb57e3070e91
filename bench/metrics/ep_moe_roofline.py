"""The MoE layer of one card's expert share as a share of its roofline:
the least time of the traced MoE calls (``cost_mla.moe_least_time``: the
router, the pairs the held experts kept and the shared expert at the
bf16 peak, against the touched held experts', the shared expert's and
the router's bytes at the HBM rate), over the device time launched
inside the program's ``repro.moe`` ranges (``models.moe.apply_moe``).
The pairs come from the routing record the harness keeps.  None where
the program has no such range.  Read for every ``ep_moe_roofline.<cells>``
metric."""
from bench import cost_mla, readers
from bench.systems.mla_moe import kept


def read(ctx, out):
    c = ctx.config
    least = sum(cost_mla.moe_least_time(c, T, kept(counts, T, c),
                                        sum(x > 0 for x in counts))
                for T, counts in out.get("moe_calls", ()))
    return readers.roofline_percent(least,
                                    out["trace"].device_s_under("repro.moe"))
