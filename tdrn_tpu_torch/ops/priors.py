"""Prior (anchor) box generation, in numpy (bit-equal to ``tdrn_tpu.ops.priors``).

  cx = (j + 0.5) * step / size,  cy = (i + 0.5) * step / size
  per cell: [s, s] for s = min_size/size, then for each aspect ratio r:
            [s*sqrt(r), s/sqrt(r)] and [s/sqrt(r), s*sqrt(r)]
Output is (num_priors, 4) cxcywh in [0, 1], optionally clipped.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tdrn_tpu_torch.config import DetectorConfig


@functools.lru_cache(maxsize=None)
def prior_boxes_np(cfg: DetectorConfig) -> np.ndarray:
    """Priors as a host numpy array (float32, (num_priors, 4) cxcywh)."""
    outs = []
    for k, f in enumerate(cfg.feature_maps):
        step = cfg.steps[k]
        s = cfg.min_sizes[k] / cfg.size
        # Row-major cell order: i outer, j inner.
        ij = np.arange(f, dtype=np.float32)
        cy, cx = np.meshgrid(ij, ij, indexing="ij")
        cx = (cx + 0.5) * step / cfg.size
        cy = (cy + 0.5) * step / cfg.size
        centers = np.stack([cx, cy], axis=-1).reshape(-1, 2)  # (f*f, 2)

        whs = [(s, s)]
        for r in cfg.aspect_ratios[k]:
            rt = float(np.sqrt(r))
            whs.append((s * rt, s / rt))
            whs.append((s / rt, s * rt))
        whs = np.asarray(whs, dtype=np.float32)  # (A, 2)

        a = whs.shape[0]
        cells = np.repeat(centers, a, axis=0)  # (f*f*A, 2)
        sizes = np.tile(whs, (centers.shape[0], 1))  # (f*f*A, 2)
        outs.append(np.concatenate([cells, sizes], axis=-1))
    priors = np.concatenate(outs, axis=0).astype(np.float32)
    if cfg.clip:
        priors = np.clip(priors, 0.0, 1.0)
    if priors.shape != (cfg.num_priors, 4):
        raise ValueError(f"prior count {priors.shape} != {cfg.num_priors}")
    priors.flags.writeable = False  # shared by every caller of the cache
    return priors


def prior_boxes(cfg: DetectorConfig, device) -> torch.Tensor:
    """Priors as a (num_priors, 4) float32 tensor on ``device``."""
    return torch.tensor(prior_boxes_np(cfg), device=device)
