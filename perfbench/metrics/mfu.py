"""The whole step's share of the card's bf16 peak: the model's operations
a frame (perfbench/roofline.py's walk of the reference) times the frames a
second of the window, over 989 TFLOP/s, in percent."""

from perfbench import roofline


def read(name, record):
    rate = record.get("frames_per_s")
    if not rate:
        return None
    return 100.0 * roofline.model_flops(record["config"]) * rate / roofline.PEAK_FLOPS["bf16"]
