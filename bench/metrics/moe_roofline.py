"""The MoE layer's share of its roofline: the least time of the traced
MoE calls (the routed pairs' expert FLOPs at the bf16 peak against the
touched experts' weight bytes at the HBM rate: for one decode token,
its two experts' bytes), over the device time launched inside the spans
around ``models.moe.apply_moe``.  Read for every ``moe_roofline.<cells>``
metric."""
from bench import cost, readers


def read(ctx, out):
    calls = readers.spans(out, "bench.route")
    least = sum(cost.moe_least_time(ctx.config, s[3].shape[0],
                                    int(s[3].unique().numel()))
                for s in calls)
    return readers.roofline_percent(least,
                                    out["trace"].device_s_under("bench.moe"))
