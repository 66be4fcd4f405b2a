"""Frame preprocessing on the device: uint8 RGB frames -> mean-subtracted float.

The port of ``tdrn_tpu/ops/preprocess.py``. The JAX resize
(``jax.image.resize(..., "linear")``) antialiases when it downscales, so the
bilinear resize here passes ``antialias=True``; without it a 480x640 -> 320
downscale differs by tens of pixel levels.

Under ``fold_mean`` (utils/precision.py ``apply_fold_mean``) the mean is not
subtracted: the frames leave as raw pixels with a constant ones channel
appended, and conv1_1's folded kernel does the subtraction.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdrn_tpu_torch.config import DetectorConfig


def preprocess_batch(
    frames_u8: torch.Tensor, cfg: DetectorConfig, dtype: torch.dtype = torch.float32,
    fold_mean: bool = False,
) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> contiguous (B, size, size, 3) mean-subtracted (NHWC);
    (B, size, size, 4) raw pixels + ones under ``fold_mean``."""
    x = frames_u8.to(torch.float32)
    if x.shape[1] != cfg.size or x.shape[2] != cfg.size:
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(cfg.size, cfg.size), mode="bilinear",
            align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)
    if fold_mean:
        return F.pad(x, (0, 1), value=1.0).to(dtype).contiguous()
    # Filled on the device by fill_: a tensor made from a list, or an item
    # assigned a Python number, is copied from the host, which a CUDA graph
    # capture refuses.
    mean = x.new_empty(3)
    for c, m in enumerate(cfg.pixel_means):
        mean[c].fill_(m)
    return (x - mean).to(dtype).contiguous()


def preprocess_frame(
    frame_u8: torch.Tensor, cfg: DetectorConfig, dtype: torch.dtype = torch.float32,
    fold_mean: bool = False,
) -> torch.Tensor:
    """uint8 (H, W, 3) -> (size, size, 3) mean-subtracted float (4 channels under fold_mean)."""
    return preprocess_batch(frame_u8[None], cfg, dtype, fold_mean)[0]
