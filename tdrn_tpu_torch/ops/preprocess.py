"""Frame preprocessing on the device: uint8 RGB frames -> mean-subtracted float.

The port of ``tdrn_tpu/ops/preprocess.py``. The JAX resize
(``jax.image.resize(..., "linear")``) antialiases when it downscales, so the
bilinear resize here passes ``antialias=True``; without it a 480x640 -> 320
downscale differs by tens of pixel levels.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tdrn_tpu_torch.config import DetectorConfig


def preprocess_batch(
    frames_u8: torch.Tensor, cfg: DetectorConfig, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 (B, H, W, 3) -> contiguous (B, size, size, 3) mean-subtracted (NHWC)."""
    x = frames_u8.to(torch.float32)
    if x.shape[1] != cfg.size or x.shape[2] != cfg.size:
        x = F.interpolate(
            x.permute(0, 3, 1, 2), size=(cfg.size, cfg.size), mode="bilinear",
            align_corners=False, antialias=True,
        ).permute(0, 2, 3, 1)
    mean = torch.tensor(cfg.pixel_means, dtype=torch.float32, device=x.device)
    return (x - mean).to(dtype).contiguous()


def preprocess_frame(
    frame_u8: torch.Tensor, cfg: DetectorConfig, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 (H, W, 3) -> (size, size, 3) mean-subtracted float."""
    return preprocess_batch(frame_u8[None], cfg, dtype)[0]
