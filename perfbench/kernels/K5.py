"""K5, the int8 convolution (csrc/qconv.cu): named, so that the trace
counts it among the program's kernels, and not counted: its bound is per
shape (roofline.k5_bound_s), and no cell runs the int8 profile."""

NAMES = ("qconv_kernel",)


def bound_s(cfg: dict, batch: int) -> None:
    return None
