"""K4, VGG stage 2 (csrc/conv_stage.cu): its operations at the bf16
tensor-core rate, at half the model's size."""

from perfbench import roofline

NAMES = ("conv_stage_kernel",)


def bound_s(cfg: dict, batch: int) -> float:
    size = int(cfg["size"])
    return roofline.k4_operations(batch, size // 2, size // 2) / roofline.PEAK_FLOPS["bf16"]
