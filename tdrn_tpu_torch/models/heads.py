"""ARM / ODM prediction heads (the port of ``tdrn_tpu/models/heads.py``).

Per-scale 3x3 convs emitting (A*4) box offsets and (A*num_outputs) logits,
flattened in NHWC (cell, anchor) order, which is the row-major prior order of
ops/priors.py.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn

from tdrn_tpu_torch.models.layers import conv3x3


class MultiBoxHead(nn.Module):
    """Per-scale loc + conf heads; concatenates across scales in prior order."""

    def __init__(self, num_outputs: int, anchors_per_cell: Sequence[int],
                 in_channels: Sequence[int]):
        super().__init__()
        self.num_outputs = num_outputs
        for k, (a, c) in enumerate(zip(anchors_per_cell, in_channels)):
            setattr(self, f"loc{k}", conv3x3(c, a * 4))
            setattr(self, f"conf{k}", conv3x3(c, a * num_outputs))

    def forward(self, feats: List[torch.Tensor]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Each feature is cast to the heads' dtype first (flax's promote_dtype:
        fp32 heads read bf16 features in the resident-bf16 profile)."""
        dtype = self.loc0.weight.dtype
        locs, confs = [], []
        for k, x in enumerate(feats):
            x = x.to(dtype)
            b = x.shape[0]
            loc = getattr(self, f"loc{k}")(x)
            conf = getattr(self, f"conf{k}")(x)
            locs.append(loc.permute(0, 2, 3, 1).reshape(b, -1, 4))
            confs.append(conf.permute(0, 2, 3, 1).reshape(b, -1, self.num_outputs))
        return torch.cat(locs, dim=1), torch.cat(confs, dim=1)
