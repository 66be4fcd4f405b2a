"""K2, the per-class NMS sweep (csrc/nms_suppress.cu): its IoU operations
on the float32 units, over the B*C rows of a step, each of the K kept
candidates (the top-k, or the prefilter's anchors where fewer)."""

from perfbench import roofline

NAMES = ("nms_rows_kernel", "nms_block_kernel")


def bound_s(cfg: dict, batch: int) -> float:
    k = min(int(cfg["top_k"]), int(cfg["prefilter_anchors"]) or roofline.anchors(cfg))
    return roofline.k2_operations(batch * int(cfg["num_classes"]), k) / roofline.PEAK_FLOPS["fp32"]
