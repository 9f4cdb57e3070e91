"""The NMS kernel's share of its roofline: the least time of the traced
launches (the IoUs greedy NMS needs on their candidates, counted on the
reference's candidates, at the fp32 peak, against their bytes), over
the profiler's device time of ``nms_kernel``."""
import numpy as np

from bench import cost, readers


def read(ctx, out):
    launches = readers.spans(out, "bench.detect")
    t = out["trace"]
    n_dev = t.kernel_count("nms_kernel")
    if not launches or not n_dev:
        return None
    dep = ctx.config["deployment"]
    rids = [r for s in launches for r in s[3]]
    boxes, scores, _ = out["candidates"](rids)
    least, i = [], 0
    for s in launches:
        b = len(s[3])
        n_iou = sum(cost.nms_iou_count(boxes[j], scores[j], dep["iou_thr"],
                                       dep["score_thr"], dep["max_out"])
                    for j in range(i, i + b))
        i += b
        least.append(cost.least_time(
            cost.IOU_FLOPS * n_iou,
            cost.nms_bytes(b, scores.shape[1], dep["max_out"]),
            cost.PEAKS["fp32_flops_per_s"]))
    return readers.roofline_percent(float(np.mean(least)) * n_dev,
                                    t.kernel_s("nms_kernel"))
