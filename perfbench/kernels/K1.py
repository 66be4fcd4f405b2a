"""K1, the ARM->ODM cascade (csrc/cascade.cu): its bytes over the memory
bandwidth, at B frames of P anchors and C classes."""

from perfbench import roofline

NAMES = ("cascade_kernel",)


def bound_s(cfg: dict, batch: int) -> float:
    p, c = roofline.anchors(cfg), int(cfg["num_classes"])
    return roofline.k1_bytes(batch, p, c) / roofline.PEAK_BYTES
