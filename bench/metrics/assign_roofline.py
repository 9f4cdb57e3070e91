"""The association kernel's share of its roofline: a launch's least
time (its bytes at the HBM rate against the (B, T, D) cost matrix's IoUs
at the fp32 peak) times the traced launches, over the profiler's device
time of ``assign_kernel``."""
from bench import cost, readers


def read(ctx, out):
    t = out["trace"]
    n = t.kernel_count("assign_kernel")
    if not n:
        return None
    B = ctx.mix["cameras"]
    T = ctx.config["tracker"]["capacity"]
    D = ctx.config["deployment"]["max_out"]
    least = cost.least_time(B * T * D * cost.IOU_FLOPS,
                            cost.assign_bytes(B, T, D),
                            cost.PEAKS["fp32_flops_per_s"])
    return readers.roofline_percent(n * least, t.kernel_s("assign_kernel"))
