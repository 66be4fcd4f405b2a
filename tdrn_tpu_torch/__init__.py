"""tdrn_tpu_torch: the PyTorch / CUDA port of tdrn_tpu for NVIDIA Hopper.

It imports torch and numpy only, never jax and nothing of tdrn_tpu. Entry
points run on CUDA unless the caller passes ``device="cpu"``; there the
kernel wrappers run their plain PyTorch versions.
"""
