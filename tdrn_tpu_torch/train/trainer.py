"""Training step machinery (the port of ``tdrn_tpu/train/trainer.py``).

SGD with momentum 0.9 and weight decay 5e-4, a warmup + step-decay LR
schedule, global-norm gradient clipping, image and clip (truncated-BPTT)
losses, bf16 compute and QAT, as functions on an explicit train state:

  * ``TrainState``: the fp32 master params (a dict name -> tensor, the
    model's ``named_parameters``), the optimizer state (momentum traces and
    the step count the schedule reads) and the step;
  * the optimizer is optax's chain, in its order and arithmetic:
    ``clip_by_global_norm`` (scale by ``max_norm / norm`` only when
    ``norm >= max_norm``), ``add_decayed_weights`` (on every parameter,
    the FrozenBN affines included), ``sgd(momentum)`` (trace ``g + m *
    trace``, update ``-lr(count) * trace``, count from 0); the schedule is
    computed in float32 as the JAX package computes it;
  * the forward is ``torch.func.functional_call`` of the model on the params,
    so the bf16 compute path casts the non-head params once a step, outside
    the frame loop, and the gradient flows through the cast to the fp32
    masters. Clip mode carries the temporal state across the T frames with
    autograd; ``remat`` checkpoints each frame's forward
    (``torch.utils.checkpoint``, non-reentrant).

With a parallel/mesh.py ``mesh`` the step is data-parallel: each rank
runs it on its rows of the global batch, the losses are divided by the
positive counts of the global batch (each all-reduced before the clamp to
1), and the gradients are summed over the ranks (one flat all-reduce,
before the global-norm clip), so every rank applies the update of the
one-process step on the global batch: the JAX package's jitted step on a
``data`` mesh. A per-rank normalized, averaged gradient (DDP's default)
would differ whenever the ranks hold different numbers of positives.

The step's parts run under ``record_function`` ranges (``tdrn::forward``,
``tdrn::loss`` with ``tdrn::match`` and ``tdrn::mine`` inside it,
``tdrn::backward``, ``tdrn::optimizer``), which tools/train_bench_torch.py
reads from a torch.profiler trace.

The model must be a float training model: its state is its parameters (no
buffers, so no int8 QConvs).
"""

from __future__ import annotations

from typing import Callable, Dict, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
from torch.func import functional_call
from torch.profiler import record_function
from torch.utils.checkpoint import checkpoint

from tdrn_tpu_torch.config import DetectorConfig
from tdrn_tpu_torch.models.temporal import init_state
from tdrn_tpu_torch.ops.priors import prior_boxes
from tdrn_tpu_torch.parallel.mesh import Mesh, all_reduce_sum_
from tdrn_tpu_torch.train.loss import CountReduce, Targets, refine_multibox_loss
from tdrn_tpu_torch.utils.precision import FP32_SUBTREES

Tensor = torch.Tensor
Params = Dict[str, Tensor]


class SGDState(NamedTuple):
    trace: Params  # momentum traces, one per parameter (fp32)
    count: int  # optimizer steps taken: the LR schedule's input


class TrainState(NamedTuple):
    params: Params
    opt_state: SGDState
    step: int


def make_lr_schedule(
    base_lr: float = 1e-3,
    warmup_steps: int = 500,
    milestones: Sequence[int] = (80_000, 100_000),
    gamma: float = 0.1,
) -> Callable[[int], np.float32]:
    """Linear warmup, then step decay at the milestones: count -> float32 LR,
    in the float32 operations of the JAX schedule (optax's
    ``piecewise_constant_schedule`` after the warmup)."""
    f32 = np.float32
    bounds = sorted((int(m), f32(gamma)) for m in milestones)

    def schedule(count: int) -> np.float32:
        count = int(count)
        if count < warmup_steps:
            return f32(base_lr) * f32(count + 1) / f32(max(warmup_steps, 1))
        v = f32(base_lr)
        for threshold, scale in bounds:
            ind = f32(max(0.0, np.sign(threshold - count)))
            v = v * ind + (f32(1) - ind) * scale * v
        return v

    return schedule


class SGD:
    """optax.chain(clip_by_global_norm, add_decayed_weights, sgd(momentum)):
    ``init(params)`` and ``update(grads, state, params) -> (updates,
    state)``, on lists of tensors with torch's ``_foreach`` operations (a
    few launches a step on the card, no host sync)."""

    def __init__(self, schedule, momentum: float, weight_decay: float, grad_clip_norm: float):
        self.schedule = schedule
        self.momentum = float(momentum)
        self.weight_decay = float(weight_decay)
        self.grad_clip_norm = float(grad_clip_norm or 0.0)

    def init(self, params: Params) -> SGDState:
        return SGDState({k: torch.zeros_like(v) for k, v in params.items()}, 0)

    def update(self, grads: Params, state: SGDState, params: Params) -> Tuple[Params, SGDState]:
        keys = list(params)
        g = [grads[k] for k in keys]
        if self.grad_clip_norm > 0:
            norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
            max_norm = torch.full_like(norm, self.grad_clip_norm)
            factor = torch.where(norm < max_norm, torch.ones_like(norm), max_norm / norm)
            g = torch._foreach_mul(g, factor)
        if self.weight_decay:
            g = torch._foreach_add(g, torch._foreach_mul([params[k] for k in keys],
                                                         self.weight_decay))
        trace = torch._foreach_add(g, torch._foreach_mul([state.trace[k] for k in keys],
                                                         self.momentum))
        lr = float(self.schedule(state.count))
        updates = torch._foreach_mul(trace, -lr)
        return dict(zip(keys, updates)), SGDState(dict(zip(keys, trace)), state.count + 1)


def make_optimizer(
    base_lr: float = 1e-3,
    momentum: float = 0.9,
    weight_decay: float = 5e-4,
    warmup_steps: int = 500,
    milestones: Sequence[int] = (80_000, 100_000),
    gamma: float = 0.1,
    grad_clip_norm: float = 10.0,
) -> SGD:
    """SGD + momentum on the reference schedule; ``grad_clip_norm`` adds
    global-norm clipping (0 disables)."""
    return SGD(make_lr_schedule(base_lr, warmup_steps, milestones, gamma), momentum,
               weight_decay, grad_clip_norm)


def apply_updates(params: Params, updates: Params) -> Params:
    keys = list(params)
    return dict(zip(keys, torch._foreach_add([params[k] for k in keys],
                                             [updates[k] for k in keys])))


def init_train_state(model: torch.nn.Module, optimizer: SGD) -> TrainState:
    """Step 0 of training ``model`` as it stands: fp32 copies of its
    parameters and zero momentum."""
    params = {k: v.detach().float().clone() for k, v in model.named_parameters()}
    extra = sorted(set(model.state_dict()) - set(params))
    if extra:
        raise ValueError(f"a training model holds only parameters; found buffers {extra[:4]}")
    return TrainState(params, optimizer.init(params), 0)


def cast_compute(params: Params, dtype: torch.dtype,
                 keep_fp32: Tuple[str, ...] = FP32_SUBTREES) -> Params:
    """The params the forward reads: each cast to ``dtype`` except those
    under the ``keep_fp32`` top-level modules (the heads and L2Norm scales).
    A differentiable cast, so gradients reach the fp32 masters."""
    return {k: v if k.split(".", 1)[0] in keep_fp32 else v.to(dtype) for k, v in params.items()}


def _forward(model, params: Params, x: Tensor, state):
    with record_function("tdrn::forward"):
        return functional_call(model, params, (x, state))


def _loss(preds, priors, targets, cfg, count_reduce: CountReduce = None):
    with record_function("tdrn::loss"):
        return refine_multibox_loss(preds, priors, targets, cfg, count_reduce=count_reduce)


def _clip_loss(model, params: Params, frames: Tensor, targets: Targets, priors: Tensor,
               cfg: DetectorConfig, remat: bool = False, dtype: torch.dtype = torch.float32,
               count_reduce: CountReduce = None):
    """Run the model over a (T, B, H, W, 3) clip, carrying the temporal state
    from a zero state in ``dtype``; the mean of the per-frame losses and
    metrics, each frame divided by its own positive counts. ``remat``
    recomputes each frame's forward in the backward."""
    batch = frames.shape[1]
    state = init_state(batch, cfg.feature_maps, model.tcb_channels, dtype, frames.device)
    losses, per_frame = [], []
    for t in range(frames.shape[0]):
        if remat:
            preds, state = checkpoint(_forward, model, params, frames[t], state,
                                      use_reentrant=False)
        else:
            preds, state = _forward(model, params, frames[t], state)
        loss, metrics = _loss(
            preds, priors, Targets(targets.boxes[t], targets.labels[t], targets.valid[t]), cfg,
            count_reduce)
        losses.append(loss)
        per_frame.append(metrics)
    mean = {k: torch.stack([m[k] for m in per_frame]).mean() for k in per_frame[0]}
    return torch.stack(losses).mean(), mean


def _image_loss(model, params: Params, images: Tensor, targets: Targets, priors: Tensor,
                cfg: DetectorConfig, dtype: torch.dtype = torch.float32,
                count_reduce: CountReduce = None):
    state = None
    if model.temporal_enabled:
        state = init_state(images.shape[0], cfg.feature_maps, model.tcb_channels, dtype,
                           images.device)
    preds, _ = _forward(model, params, images, state)
    return _loss(preds, priors, targets, cfg, count_reduce)


def _global_metrics(metrics: Dict[str, Tensor], mesh: Mesh) -> Dict[str, Tensor]:
    """The metrics of the global batch: the rank's loss and loss parts
    (already divided by the global counts) summed over the ranks in one
    all-reduce; the positive counts are global already."""
    keys = [k for k in metrics if not k.startswith("num_pos")]
    summed = all_reduce_sum_([torch.stack([metrics[k] for k in keys])], mesh)[0]
    return {**metrics, **dict(zip(keys, summed.unbind(0)))}


def make_train_step(
    model: torch.nn.Module,
    optimizer: SGD,
    clip_mode: bool = False,
    remat: bool = False,
    compute_dtype: Optional[torch.dtype] = None,
    qat_scales: Optional[Dict[str, float]] = None,
    mesh: Optional[Mesh] = None,
):
    """The train step ``(ts, images, targets) -> (ts, metrics)``.

    clip_mode=False: images (B, H, W, 3), targets (B, G, ...).
    clip_mode=True:  frames (T, B, H, W, 3), targets (T, B, G, ...), truncated
    BPTT over the clip; ``remat`` checkpoints the per-frame forwards.

    compute_dtype=torch.bfloat16: the feature-pyramid params are cast to bf16
    once a step, outside the frame loop, while the heads, the L2Norm scales,
    the loss, the optimizer state and the masters stay fp32 (the split of the
    resident-bf16 inference profile); the carry is bf16.

    qat_scales: calibrated activation scales (utils/quantize.py); the forward
    runs utils/quantize.apply_qat's copy of ``model`` (fake-quantized convs,
    straight-through gradients) on the same params, so masters, optimizer
    state and checkpoints stay plain fp32. Composes with compute_dtype.

    The tensors must be on the params' device; metrics come back as 0-dim
    tensors there (reading one waits for the step).
    """
    cfg = model.cfg
    dtype = torch.float32 if compute_dtype is None else compute_dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise NotImplementedError(f"compute dtype {dtype} is not ported (fp32 or bf16)")
    loss_model = model
    if qat_scales:
        from tdrn_tpu_torch.utils.quantize import apply_qat

        loss_model = apply_qat(model, qat_scales)
    priors_by_device: Dict[torch.device, Tensor] = {}
    reduce_over = mesh if mesh is not None and mesh.group is not None else None
    count_reduce = None
    if reduce_over is not None:
        count_reduce = lambda n: all_reduce_sum_([n], reduce_over)[0]  # noqa: E731

    def loss_fn(params: Params, images: Tensor, targets: Targets):
        priors = priors_by_device.get(images.device)
        if priors is None:
            priors = priors_by_device[images.device] = prior_boxes(cfg, images.device)
        if dtype != torch.float32:
            params = cast_compute(params, dtype)
        if clip_mode:
            return _clip_loss(loss_model, params, images, targets, priors, cfg, remat, dtype,
                              count_reduce)
        return _image_loss(loss_model, params, images, targets, priors, cfg, dtype, count_reduce)

    def train_step(ts: TrainState, images: Tensor, targets: Targets):
        params = {k: v.detach().requires_grad_(True) for k, v in ts.params.items()}
        loss, metrics = loss_fn(params, images, targets)
        with record_function("tdrn::backward"):
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(params.items(), grads)}
        if reduce_over is not None:
            with record_function("tdrn::all_reduce"):
                all_reduce_sum_(list(grads.values()), reduce_over)
        with record_function("tdrn::optimizer"):
            updates, opt_state = optimizer.update(grads, ts.opt_state, ts.params)
            new = TrainState(apply_updates(ts.params, updates), opt_state, ts.step + 1)
        out = {k: v.detach() for k, v in metrics.items()}
        out["loss"] = loss.detach()
        if reduce_over is not None:
            out = _global_metrics(out, reduce_over)
        return new, out

    return train_step
