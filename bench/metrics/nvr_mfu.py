"""The detector's share of the chip's fp32 peak over the traced window:
the mini-SSD's closed-form convolution FLOPs times the frames detected
in the window, over the window times 67 TFLOP/s (the program holds TF32
off)."""
from bench import cost, readers


def read(ctx, out):
    frames = sum(sum(r >= 0 for r in s[3])
                 for s in readers.spans(out, "bench.detect"))
    return readers.mfu_percent(
        cost.ssd_conv_flops(ctx.config["detector"]) * frames,
        out["trace"].window_s, "fp32_flops_per_s")
