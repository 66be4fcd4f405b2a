"""Streaming inference (the port of ``tdrn_tpu/inference.py``).

One step per batch of frames: uint8 frames -> preprocess -> TDRN forward with
the per-stream temporal state that stays on the device -> detect_topk.
``StreamingDetector`` serves S independent streams in the lanes of one batch,
with per-stream reset and active masks.

The JAX package runs that step as one jitted program whose state argument is
donated. Here, on the card, the step is one CUDA graph: captured once per
frame shape, after a warm-up on a side stream, and replayed for every later
``detect()``. The graph reads and updates the carried state in its own
buffers, in place (the donation), and every other tensor of the step lives
in the graph's private memory pool. On the CPU the same step runs eagerly.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from tdrn_tpu_torch import _build, weights
from tdrn_tpu_torch.config import DetectorConfig, get_config
from tdrn_tpu_torch.models.detector import TDRN, build_detector
from tdrn_tpu_torch.ops.detection import detect_topk
from tdrn_tpu_torch.ops.nms import TopDetections
from tdrn_tpu_torch.ops.preprocess import preprocess_batch
from tdrn_tpu_torch.ops.priors import prior_boxes
from tdrn_tpu_torch.train import checkpoint
from tdrn_tpu_torch.utils.logging import span
from tdrn_tpu_torch.utils.precision import apply_inference_precision
from tdrn_tpu_torch.utils.quantize import apply_int8_backbone, load_act_scales


def capture(fn, device, after=None):
    """Capture ``fn()`` as a CUDA graph on ``device``: (graph, fn's outputs).

    fn runs once first, eagerly on a side stream, so that every first-launch
    setup (kernel builds, shared-memory attributes, occupancy queries, cuDNN
    plans) is done and the capture records launches only; that run's results
    are dropped. ``after(outputs)``, if given, is captured behind fn (the
    streaming step's in-place state update). Each replay overwrites the
    outputs in place. A failed capture raises.

    ``capture.seconds`` sums the process's captures, warm-up and capture,
    up to a synchronize of the device: the card's warm-up work, not only its
    enqueue (set-up, read by the benchmark's ``setup.capture_s``).
    """
    t0 = time.perf_counter()
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    # thread_local: a CUDA call of another thread of the process does not
    # invalidate the capture.
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        out = fn()
        if after is not None:
            after(out)
    torch.cuda.synchronize(device)
    capture.seconds += time.perf_counter() - t0
    return graph, out


capture.seconds = 0.0


class _StepGraph:
    """The streaming step captured for one frame shape.

    Static inputs: the frames (uint8, on the card) and the reset and active
    masks (one (2, S) float tensor). Host inputs are staged through two
    pinned buffers in turn, each refilled only after the event recorded
    behind its last copy has passed, so the copies to the card run
    asynchronously and the host never overwrites a buffer still in flight.
    Frames already on the card are copied from where they are.

    Host ranges (``span``): ``tdrn::stage`` around ``load``, with
    ``tdrn::stage_wait`` around its wait on the buffer's event inside it;
    ``tdrn::replay`` around the graph's launch and ``tdrn::clone`` around
    the outputs' copies. None lies inside the captured step.
    """

    def __init__(self, det: "StreamingDetector", shape):
        dev = det.device
        self.frames = torch.zeros(shape, dtype=torch.uint8, device=dev)
        self.masks = torch.zeros((2, det.num_streams), dtype=torch.float32, device=dev)
        self._pinned = [
            (torch.empty(shape, dtype=torch.uint8, pin_memory=True),
             torch.empty((2, det.num_streams), dtype=torch.float32, pin_memory=True),
             torch.cuda.Event())
            for _ in range(2)
        ]
        self._turn = 0
        self.graph, (_, self.out) = capture(
            lambda: det._step(det._state, self.frames, self.masks[0], self.masks[1]),
            dev, after=lambda out: det._commit(out[0]),
        )
        det.captures += 1

    def load(self, frames: torch.Tensor, masks: np.ndarray) -> None:
        """Copy one step's inputs into the static inputs, on the current stream."""
        with span("tdrn::stage"):
            host_frames, host_masks, done = self._pinned[self._turn]
            self._turn ^= 1
            with span("tdrn::stage_wait"):
                done.synchronize()  # the copies that last read these buffers have run
            host_masks.copy_(torch.from_numpy(masks))
            self.masks.copy_(host_masks, non_blocking=True)
            if frames.is_cuda:
                self.frames.copy_(frames)
            else:
                host_frames.copy_(frames)
                self.frames.copy_(host_frames, non_blocking=True)
            done.record()

    def replay(self) -> TopDetections:
        """Run the step; returns copies of the outputs, which the next replay
        overwrites in place."""
        with span("tdrn::replay"):
            self.graph.replay()
        with span("tdrn::clone"):
            return TopDetections(*(None if t is None else t.clone() for t in self.out))


class StreamingDetector:
    """Stateful per-frame detector over S concurrent streams.

    detect(frames_u8) -> TopDetections with boxes (S,K,4) in [0,1] xyxy,
    scores (S,K) and classes (S,K); with ``chunk`` > 1 the frames are
    (chunk, S, H, W, 3) and every output gains the leading chunk axis.

    On the card each frame shape is captured once as a CUDA graph, after one
    eager warm-up step, and replayed after; ``captures`` and ``replays``
    count them. A capture or replay that fails raises: there is no eager
    fallback. Each ``detect`` is one ``tdrn::detect`` host range (``span``),
    on the card and on the CPU.
    """

    def __init__(
        self,
        model: TDRN,
        num_streams: int = 1,
        top_k: Optional[int] = None,
        prefilter: Optional[int] = None,
        chunk: int = 1,
        device=None,
        prefilter_recall: Optional[float] = None,
    ):
        """prefilter: image-wide anchor cap before the per-class NMS
        (cfg.prefilter_anchors); None keeps the config's setting.
        prefilter_recall: the prefilter's recall target
        (cfg.prefilter_recall); None keeps the config's setting. The port's
        selection is exact at any target (ops/detection.py).
        chunk: frames per stream per step. The state-independent model runs
        over all chunk*S frames at once (TDRN.chunk), the temporal cell steps
        them in order; reset and active apply once, at the chunk boundary.
        device: where the model and its state live (CUDA unless "cpu")."""
        self.chunk = int(chunk)
        if self.chunk < 1:
            raise ValueError(f"chunk must be >= 1, got {chunk}")
        if self.chunk > 1:
            model = model.clone(chunk=self.chunk)
        self.device = _build.resolve_device(device)
        self.model = model.to(self.device).eval()
        self.cfg = model.cfg
        if prefilter is not None:
            self.cfg = dataclasses.replace(self.cfg, prefilter_anchors=int(prefilter))
        if prefilter_recall is not None:
            self.cfg = dataclasses.replace(self.cfg, prefilter_recall=float(prefilter_recall))
        self.num_streams = num_streams
        self.top_k = top_k or model.cfg.top_k
        self.priors = prior_boxes(self.cfg, self.device)
        self._reset_lock = threading.Lock()
        self._pending_reset: set = set()
        self._state = model.zero_state(num_streams) if model.temporal_enabled else None
        self._graphs = {}  # frame shape -> _StepGraph
        self.captures = self.replays = 0

    @property
    def state(self):
        """The carried per-scale state, (S, C, f, f) tensors (None if not
        temporal). These are the live buffers, which every step overwrites in
        place: clone them to keep a snapshot."""
        return self._state

    def reset(self, stream_ids: Optional[List[int]] = None):
        """Mark streams for a state reset at the next frame (clip boundary).
        Safe against a concurrent detect(): a reset queued mid-step applies on
        the next step."""
        if stream_ids is None:
            stream_ids = list(range(self.num_streams))
        with self._reset_lock:
            self._pending_reset |= set(stream_ids)

    @torch.inference_mode()
    def _step(self, state, frames_u8, reset, active):
        """The whole step as a function of its inputs: (new_state, detections).
        frames_u8 (S, H, W, 3), or (chunk, S, H, W, 3); reset and active (S,).
        Shape-static and free of host syncs, so that it can be captured."""
        frames = frames_u8.flatten(0, 1) if self.chunk > 1 else frames_u8  # frame-major
        x = preprocess_batch(frames, self.cfg, self.model.dtype, self.model.fold_mean)
        if state is not None:
            # Per-stream reset: zero this lane's carried features.
            keep = (1.0 - reset)[:, None, None, None]
            state = [s * keep.to(s.dtype) for s in state]
        preds, new_state = self.model(x, state)
        if state is not None:
            # Inactive lanes keep their post-reset state.
            a = (active > 0)[:, None, None, None]
            new_state = [torch.where(a, ns, s) for ns, s in zip(new_state, state)]
        det = detect_topk(preds, self.priors, self.cfg, self.top_k)
        if self.chunk > 1:
            det = TopDetections(*(
                None if t is None else t.unflatten(0, (self.chunk, self.num_streams))
                for t in det
            ))
        return new_state, det

    def _commit(self, new_state) -> None:
        """Write a step's new state into the carried buffers, in place."""
        if self._state is not None:
            for s, ns in zip(self._state, new_state):
                s.copy_(ns)

    def _frames(self, frames_u8) -> torch.Tensor:
        frames = torch.as_tensor(frames_u8)
        lead = (self.num_streams,) if self.chunk == 1 else (self.chunk, self.num_streams)
        n = len(lead)
        if (frames.dtype != torch.uint8 or frames.dim() != n + 3
                or tuple(frames.shape[:n]) != lead or frames.shape[-1] != 3):
            raise ValueError(
                f"frames must be uint8 {lead + ('H', 'W', 3)}, got "
                f"{frames.dtype} {tuple(frames.shape)}"
            )
        return frames

    @torch.inference_mode()
    def _run(self, frames: torch.Tensor, masks: np.ndarray) -> TopDetections:
        if self.device.type == "cpu":
            new_state, det = self._step(
                self._state, frames, torch.from_numpy(masks[0]), torch.from_numpy(masks[1])
            )
            self._commit(new_state)
            return det
        key = tuple(frames.shape)
        graph = self._graphs.get(key)
        if graph is None:
            graph = self._graphs[key] = _StepGraph(self, key)
        graph.load(frames, masks)
        det = graph.replay()
        self.replays += 1
        return det

    def detect(self, frames_u8, active=None) -> TopDetections:
        """frames_u8: (S, H, W, 3) uint8 RGB, or (chunk, S, H, W, 3), numpy or
        tensor. active: optional (S,) 0/1 mask, numpy or a tensor on any
        device; lanes with 0 do not advance their state this step and their
        detections must be ignored."""
        with span("tdrn::detect"):
            with self._reset_lock:
                pending = self._pending_reset
                self._pending_reset = set()
            masks = np.zeros((2, self.num_streams), np.float32)  # reset, active
            masks[0, sorted(pending)] = 1.0
            if active is not None:  # a tensor on the card is read back here, before the step
                masks[1] = torch.as_tensor(active, dtype=torch.float32, device="cpu").numpy()
            else:
                masks[1] = 1.0
            try:
                return self._run(self._frames(frames_u8), masks)
            except Exception:
                # A failed step must not swallow queued clip-boundary resets.
                with self._reset_lock:
                    self._pending_reset |= pending
                raise


def make_clip_forward(model: TDRN, top_k: Optional[int] = None, device=None):
    """Whole-clip detect: (T, B, H, W, 3) uint8 -> TopDetections with a
    leading T axis, the state starting at zero. The JAX package's scan is a
    loop over the streaming step (one graph replay a frame on the card); the
    detector of each batch size is kept for the next clip."""
    detectors = {}

    def run(frames_u8) -> TopDetections:
        frames = torch.as_tensor(frames_u8)
        batch = frames.shape[1]
        det = detectors.get(batch)
        if det is None:
            det = detectors[batch] = StreamingDetector(
                model, num_streams=batch, top_k=top_k, device=device
            )
        for s in det.state or ():
            s.zero_()
        outs = [det.detect(frame) for frame in frames]
        return TopDetections(*(
            None if field[0] is None else torch.stack(field) for field in zip(*outs)
        ))

    return run


def make_single_image_forward(
    model: TDRN, top_k: Optional[int] = None, prefilter: Optional[int] = None,
    prefilter_recall: Optional[float] = None,
):
    """Single-image detect: (B, H, W, 3) uint8 -> TopDetections, zero state."""
    cfg = model.cfg
    if prefilter is not None:
        cfg = dataclasses.replace(cfg, prefilter_anchors=int(prefilter))
    if prefilter_recall is not None:
        cfg = dataclasses.replace(cfg, prefilter_recall=float(prefilter_recall))
    k = top_k or cfg.top_k

    @torch.inference_mode()
    def run(images_u8: torch.Tensor) -> TopDetections:
        x = preprocess_batch(images_u8, cfg, model.dtype, model.fold_mean)
        state = model.zero_state(images_u8.shape[0]) if model.temporal_enabled else None
        preds, _ = model(x, state)
        return detect_topk(preds, prior_boxes(cfg, x.device), cfg, k)

    return run


class LoadedModel(NamedTuple):
    model: TDRN
    cfg: DetectorConfig
    step: int
    meta: dict


def _is_temporal(path: str) -> bool:
    return path.split(" ")[0].split(".")[0] == "temporal"


def load_inference_model(
    checkpoint_dir: str,
    *,
    dataset: Optional[str] = None,
    backbone: Optional[str] = None,
    temporal: Optional[bool] = None,
    stem: Optional[str] = None,
    temporal_cell: Optional[str] = None,
    tcb_channels: Optional[int] = None,
    backbone_norm: Optional[str] = None,
    dtype: torch.dtype = torch.float32,
    precision: Optional[str] = None,
    int8_scales: Optional[str] = None,
    random_init: bool = False,
    seed: int = 0,
    verbose: bool = True,
    dataset_fallback: str = "voc_320",
    device=None,
) -> LoadedModel:
    """Build a detector for inference from a checkpoint directory
    (train/checkpoint.py's layout), on ``device`` (CUDA unless "cpu").

    Model-construction flags default to the directory's ``model_meta.json``;
    explicit keyword arguments override it. The params are grafted onto a
    seeded template (weights.load_random_params) subtree by subtree: a
    temporal checkpoint loads into a non-temporal model and the other way
    round, the temporal subtree reported, not fatal; any other subtree
    absent or of another shape raises ValueError.

    precision="bf16" converts to the resident-bf16 profile after the
    restore (utils/precision.py); "int8" is bf16 with the quantized backbone
    (utils/quantize.py) on the activation scales in the json file
    ``int8_scales``. The checkpoint itself stays fp32.
    """
    # Only reads: a random_init caller must not create checkpoint directories.
    meta = checkpoint.load_meta(checkpoint_dir) or {}

    def pick(cli, key, default):
        return cli if cli is not None else meta.get(key, default)

    cfg = get_config(pick(dataset, "dataset", dataset_fallback))
    backbone_name = pick(backbone, "backbone", "vgg16")
    # FrozenBN and GroupNorm resnets have identical param trees, so a wrong
    # norm restores silently and computes wrong activations.
    if backbone_name == "resnet101" and backbone_norm is None and "backbone_norm" not in meta:
        print(
            "WARNING: resnet checkpoint meta lacks 'backbone_norm'; assuming "
            "'frozen'. A GroupNorm-trained checkpoint restores into a FrozenBN "
            "model without error but computes garbage — pass backbone_norm "
            "explicitly (CLI --backbone_norm) if this checkpoint used "
            "--backbone_norm group."
        )
    model = build_detector(
        cfg,
        backbone=backbone_name,
        temporal=bool(pick(temporal, "temporal", True)),
        stem=pick(stem, "stem", "conv"),
        temporal_cell=pick(temporal_cell, "temporal_cell", "convgru"),
        tcb_channels=int(pick(tcb_channels, "tcb_channels", 256)),
        backbone_norm=pick(backbone_norm, "backbone_norm", "frozen"),
        width_mult=float(meta.get("width_mult", 1.0)),
        dtype=dtype,
        device=device,
    )
    weights.load_random_params(model, seed)

    def apply_precision(model):
        if precision == "int8":
            if int8_scales is None:
                raise ValueError(
                    "precision='int8' needs int8_scales (calibrate offline: "
                    "eval_torch.py --precision int8 --save_scales <path>)"
                )
            model = apply_inference_precision(model, "bf16")
            return apply_int8_backbone(model, act_scales=load_act_scales(int8_scales))
        return apply_inference_precision(model, precision)

    if random_init:
        return LoadedModel(apply_precision(model), cfg, 0, meta)
    out = checkpoint.restore_params(checkpoint_dir, model.state_dict())
    if out is None:
        raise FileNotFoundError(f"no checkpoint found in {checkpoint_dir}")
    params, missing, extra = out
    # Only the temporal subtree may legitimately stay at its template
    # (clip-trained <-> single-frame eval). Anything else means the model was
    # built with the wrong geometry: randomly initialized heads would
    # silently produce garbage.
    bad = [m for m in missing if not _is_temporal(m)]
    if bad:
        raise ValueError(
            f"checkpoint/model mismatch: {len(bad)} non-temporal subtree(s) "
            f"absent or shape-mismatched in {checkpoint_dir}: {bad[:6]} — "
            "pass the matching --dataset/--backbone (or fix model_meta.json)"
        )
    if verbose and (missing or extra):
        print(
            f"restore: {len(missing)} template subtree(s) kept at init "
            f"{missing[:4]}, {len(extra)} checkpoint subtree(s) unused {extra[:4]}"
        )
    model.load_state_dict(params, strict=True)
    return LoadedModel(apply_precision(model), cfg, checkpoint.latest_step(checkpoint_dir) or 0, meta)
