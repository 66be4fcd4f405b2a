"""Spatial partitioning: split ONE frame's height over the ranks (the port of
``tdrn_tpu/parallel/spatial.py``).

Data parallelism (parallel/mesh.py) scales throughput; it does not cut the
latency of one frame. Here each rank of a ``spatial`` mesh runs the
backbone's first segments on its band of rows. The JAX package shards H
and lets GSPMD insert the halo exchanges; here they are written out:

  * the backbone is its chain of segments (``backbone.segments()``,
    models/layers.py::Segment): a VGG stage (its 3x3 convs and its pool),
    the fused stems' K3 or K3 + K4, ResNet's stem and each bottleneck;
  * rank r owns rows ``[r*H/n, (r+1)*H/n)`` of a segment's input. Before the
    segment it takes a halo of ``h`` rows from each neighbour, ``h`` the
    segment's receptive radius rounded up to its stride (so a band starts
    on a pooling window), clipped at the frame's top and bottom. The
    segment's own modules run unchanged on band + halo and the output is
    cropped to the rows the band owns; zero padding thus acts only at the
    frame's true edges (K3 and K4 pad at their input's edge as well);
  * the first segment cuts its band + halo from the frames, which every
    rank holds; the halos of the next come from one ``all_gather`` of each
    rank's edge rows;
  * the bands are gathered at the first source (conv4_3, ResNet's C3), or
    earlier where a segment's halo exceeds a band or its stride does not
    divide one (TINY_64 at 4 ranks: VGG's stage 4 sees 2 rows a band
    against a halo of 3). Everything after runs replicated on every rank:
    the rest of the backbone, L2Norm, ARM, TCB, the ARM-guided sampling
    (it reads features at predicted positions, so no bounded halo serves
    it), the temporal cell, ODM and ``detect_fn``;
  * a GroupNorm (ResNet ``backbone_norm="group"``) inside a split segment
    normalizes by the statistics of the whole frame: each rank sums its
    owned rows and one all-reduce adds the bands
    (models/resnet.py::group_norm_statistics).

Every collective is an all_reduce (parallel/mesh.py::all_gather), which
gloo runs on CUDA tensors too. Preds, state and detections come back on
every rank; they match the one-process forward to float tolerance (convs
over a band sum in their own order).
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

from tdrn_tpu_torch.models.resnet import group_norm_statistics
from tdrn_tpu_torch.parallel.mesh import Mesh, all_gather, all_reduce_sum_, make_mesh

SPATIAL_AXIS = "spatial"


def make_spatial_mesh(device=None) -> Mesh:
    """The ranks of the process group as a 1-D ``spatial`` mesh, this rank
    on ``local_device(device)``."""
    mesh = make_mesh(device)
    return Mesh(mesh.group, mesh.rank, mesh.world, mesh.device, SPATIAL_AXIS)


class _Band:
    """A rank's rows ``[lo, hi)`` of a segment's input (band + halos), of
    which it owns ``[a, b)``, out of ``rows``."""

    def __init__(self, lo: int, hi: int, a: int, b: int, rows: int):
        self.lo, self.hi, self.a, self.b, self.rows = lo, hi, a, b, rows


def _group_stats(band: _Band, mesh: Mesh):
    """GroupNorm statistics of the whole frame from the owned rows of every
    rank: the grouped tensor's height divides the band's, and the owned
    rows scale with it."""

    def stats(g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        h = g.shape[3]
        f = (band.hi - band.lo) // h
        if f * h != band.hi - band.lo:
            raise ValueError(f"a GroupNorm input of {h} rows within a band of "
                             f"{band.hi - band.lo}")
        own = g[:, :, :, (band.a - band.lo) // f:(band.b - band.lo) // f]
        sums = torch.stack([own.sum(dim=(2, 3, 4)), (own * own).sum(dim=(2, 3, 4))])
        all_reduce_sum_([sums], mesh)
        count = g.shape[2] * (band.rows // f) * g.shape[4]
        mean, mean_sq = (sums / count)[..., None, None, None].unbind(0)
        return mean, mean_sq

    return stats


def _with_halos(x: torch.Tensor, h: int, band: _Band, mesh: Mesh) -> torch.Tensor:
    """x (B, C, own rows, W) NCHW -> band + halos: the last ``h`` rows of the
    rank above and the first ``h`` of the rank below, where they exist."""
    if h == 0:
        return x
    edges = all_gather(torch.stack([x[:, :, :h], x[:, :, -h:]]), mesh)  # (n, 2, B, C, h, W)
    parts = [x]
    if band.lo < band.a:
        parts.insert(0, edges[mesh.rank - 1, 1])
    if band.hi > band.b:
        parts.append(edges[mesh.rank + 1, 0])
    return torch.cat(parts, dim=2)


def _gather_rows(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Each rank's (B, C, rows, W) band -> the (B, C, n*rows, W) map on
    every rank."""
    full = all_gather(x.contiguous(), mesh)  # (n, B, C, rows, W)
    n, b, c, rows, w = full.shape
    return full.permute(1, 2, 0, 3, 4).reshape(b, c, n * rows, w)


def split_backbone(backbone, x_nhwc: torch.Tensor, mesh: Mesh) -> List[torch.Tensor]:
    """The backbone's four source maps on every rank, its first segments
    run on this rank's band of H (module docstring)."""
    n, rank = mesh.world, mesh.rank
    rows = x_nhwc.shape[1]
    if rows % n:
        raise ValueError(f"H={rows} does not split into {n} equal bands")
    segs = backbone.segments()
    sources: List[torch.Tensor] = []
    x: Optional[torch.Tensor] = None  # this rank's band of the next segment's input
    full = x_nhwc  # the replicated map, once the bands are gathered
    per = rows // n
    split = True
    for i, seg in enumerate(segs):
        if split:
            h = math.ceil(seg.radius / seg.stride) * seg.stride
            if per % seg.stride or (i > 0 and h > per):
                full, split = (_gather_rows(x, mesh) if i > 0 else x_nhwc), False
        if not split:
            full = seg.fn(full)
            if seg.source:
                sources.append(full)
            continue
        a, b = rank * per, (rank + 1) * per
        band = _Band(max(a - h, 0), min(b + h, rows), a, b, rows)
        xin = (x_nhwc[:, band.lo:band.hi].contiguous() if i == 0
               else _with_halos(x, h, band, mesh))
        with group_norm_statistics(_group_stats(band, mesh)):
            y = seg.fn(xin)
        s = seg.stride
        x = y[:, :, (a - band.lo) // s:(b - band.lo) // s]
        per, rows = per // s, rows // s
        if seg.source:  # the gather point
            full, split = _gather_rows(x, mesh), False
            sources.append(full)
    return sources


def spatial_forward(model, mesh: Mesh, detect_fn=None):
    """``fn(frames, state) -> (preds_or_dets, new_state)`` with H split over
    ``mesh``'s ranks. Every rank passes the same (B, H, W, 3) preprocessed
    frames and state, and gets the same predictions (``detect_fn(preds)``
    where given: decode and NMS run once, after the gather) and new state.
    H must split into equal bands. Runs under ``torch.no_grad`` (the
    collectives are not differentiable)."""
    if not hasattr(model, "forward_sources"):
        raise TypeError("spatial_forward takes a TDRN detector (models/detector.py)")

    @torch.no_grad()
    def fn(frames: torch.Tensor, state=None):
        sources = split_backbone(model.backbone, model.stem_input(frames), mesh)
        preds, new_state = model.forward_sources(sources, state)
        if detect_fn is not None:
            return detect_fn(preds), new_state
        return preds, new_state

    return fn
