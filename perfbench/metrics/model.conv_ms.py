"""Device time a step of cuDNN's and cuBLAS's convolution and matrix-product
kernels (trace.kind), from the traced stretch."""

from perfbench.trace import kind

KIND = "conv"


def read(name, record):
    prof = record.get("profile")
    if not prof or not prof["steps"]:
        return None
    ms = sum(s for k, s in prof["kernel_s"].items() if kind(k) == KIND) * 1e3
    return ms / prof["steps"] if ms > 0 else None
