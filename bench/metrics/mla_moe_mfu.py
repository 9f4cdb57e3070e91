"""The DeepSeek-V3 model steps as a share of the bf16 peak: the FLOPs the
requests completed in the traced window need (``cost_mla.request_flops``:
MLA in its expanded form, the dense FFN, the router, the shared expert,
only the routed pairs the experts held here kept; logits where a token
is served), over the window times 989 TFLOP/s.  Read for every
``mla_moe_mfu.<cells>`` metric."""
from bench import cost_mla, readers


def read(ctx, out):
    flops = sum(cost_mla.request_flops(ctx.config, P, n, pairs)
                for P, n, pairs in out.get("requests", ()))
    return readers.mfu_percent(flops, out["trace"].window_s,
                               "bf16_flops_per_s")
