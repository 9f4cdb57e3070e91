"""The model steps as a share of the bf16 peak: the FLOPs the requests
completed in the traced window need (2 x active parameters a token, the
routed experts only, plus attention over each token's context; logits
where a token is served), over the window times 989 TFLOP/s.  Read for
every ``llm_mfu.<cells>`` metric."""
from bench import cost, readers


def read(ctx, out):
    flops = sum(cost.llm_request_flops(ctx.config, P, n)
                for P, n in out["requests"])
    return readers.mfu_percent(flops, out["trace"].window_s,
                               "bf16_flops_per_s")
