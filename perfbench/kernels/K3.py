"""K3, the VGG stage-1 stem (csrc/stem.cu): its operations at the bf16
tensor-core rate, at the model's size."""

from perfbench import roofline

NAMES = ("stem_tc_kernel", "stem_kernel")


def bound_s(cfg: dict, batch: int) -> float:
    size = int(cfg["size"])
    return roofline.k3_operations(batch, size, size) / roofline.PEAK_FLOPS["bf16"]
