"""Checkpoints of the port (the port of ``tdrn_tpu/train/checkpoint.py``).

A checkpoint directory holds

    <dir>/model_meta.json         the model's construction flags, the same
                                  file and keys as the JAX package's trainer
                                  writes
    <dir>/<step>/params.pt        the port's ``state_dict`` (CPU tensors; an
                                  int8 QConv's weight stays int8), read with
                                  ``torch.load(..., weights_only=True)``
    <dir>/<step>/train_state.pt   a training run's optimizer state (momentum
                                  traces and count) and step, beside it

and the newest step wins. Inference reads ``params.pt`` alone, so a training
run's checkpoint serves unchanged; ``CheckpointManager.restore_latest``
reads both files and resumes exactly. ``tools/orbax_to_torch.py`` converts
a JAX package (orbax) checkpoint into this layout.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Dict, Optional, Tuple

import torch

META_FILENAME = "model_meta.json"
PARAMS_FILENAME = "params.pt"
TRAIN_STATE_FILENAME = "train_state.pt"

StateDict = Dict[str, torch.Tensor]


def save_meta(directory: str, meta: dict) -> None:
    """Persist the model's construction flags next to the checkpoints, so
    that consumers (eval/test/serve/live) rebuild the exact model without the
    user passing every train-time flag again."""
    os.makedirs(directory, exist_ok=True)
    with open(os.path.join(directory, META_FILENAME), "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)


def load_meta(directory: str) -> Optional[dict]:
    path = os.path.join(directory, META_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def latest_step(directory: str) -> Optional[int]:
    """The newest step with a params file in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory)
             if d.isdigit() and os.path.isfile(os.path.join(directory, d, PARAMS_FILENAME))]
    return max(steps) if steps else None


def _save_atomic(obj, path: str) -> None:
    torch.save(obj, path + ".tmp")
    os.replace(path + ".tmp", path)


def _host(tensors: StateDict) -> StateDict:
    return {k: v.detach().cpu().contiguous() for k, v in tensors.items()}


def save_params(directory: str, step: int, state_dict: StateDict) -> str:
    """Write ``state_dict`` as step ``step``'s params (atomically: a reader
    never sees half a file); returns the file's path."""
    step_dir = os.path.join(directory, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, PARAMS_FILENAME)
    _save_atomic(_host(state_dict), path)
    return path


def load_params(directory: str, step: Optional[int] = None) -> Optional[StateDict]:
    """Step ``step``'s params (the newest if None), or None if there is none."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            return None
    path = os.path.join(directory, str(int(step)), PARAMS_FILENAME)
    return torch.load(path, map_location="cpu", weights_only=True)


def restore_params(directory: str, template: StateDict) -> Optional[Tuple[StateDict, list, list]]:
    """Params-only, subtree-tolerant restore of the newest step (for
    inference): its params grafted onto ``template`` (:func:`graft_params`).
    Returns (params, missing, extra), or None if there is no checkpoint."""
    src = load_params(directory)
    if src is None:
        return None
    return graft_params(src, template)


def _nest(flat: StateDict) -> dict:
    root: dict = {}
    for key, v in flat.items():
        *parents, leaf = key.split(".")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return root


def graft_params(src: StateDict, template: StateDict) -> Tuple[StateDict, list, list]:
    """Copy the matching tensors of ``src`` onto ``template`` (both
    ``state_dict``s), walking them as trees of their dotted keys.

    Returns (grafted, missing, extra): ``missing`` are template subtrees
    absent (or leaves shape-mismatched) in src, which keep the template's
    values; ``extra`` are src subtrees with no template counterpart. A
    subtree is reported once, by its dotted path (``"temporal"``), as the
    JAX package reports ``"/temporal"``.
    """
    missing, extra, out = [], [], {}

    def walk(s, t, prefix):
        if not isinstance(t, dict):
            if isinstance(s, dict):
                missing.append(prefix)
                s = t
            elif tuple(s.shape) != tuple(t.shape):
                missing.append(f"{prefix} (shape {tuple(s.shape)} != {tuple(t.shape)})")
                s = t
            out[prefix] = s
            return
        s = s if isinstance(s, dict) else {}
        for k, tv in t.items():
            path = f"{prefix}.{k}" if prefix else k
            if k in s:
                walk(s[k], tv, path)
            else:
                missing.append(path)
                walk(tv, tv, path)
        for k in s:
            if k not in t:
                extra.append(f"{prefix}.{k}" if prefix else k)

    walk(_nest(src), _nest(template), "")
    return {k: out[k] for k in template}, missing, extra


class CheckpointManager:
    """Train-state checkpoints in a directory: ``maybe_save`` every
    ``save_every`` steps, the newest ``max_to_keep`` kept, ``restore_latest``
    exact (params, momentum traces, count and step).

    A save copies the state to the host at once (the train loop may then
    update its tensors) and writes the files on a background thread;
    ``wait`` joins it. The train state's step directory is complete once
    ``train_state.pt`` is there: it is written after ``params.pt``.
    """

    def __init__(self, directory: str, save_every: int = 5000, max_to_keep: int = 5):
        self.directory = os.path.abspath(directory)
        self.save_every = int(save_every)
        self.max_to_keep = int(max_to_keep)
        os.makedirs(self.directory, exist_ok=True)
        self._writer: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def maybe_save(self, ts, force: bool = False, step: Optional[int] = None) -> bool:
        """Save ``ts`` (a train/trainer.py TrainState) if the step hits the
        cadence; call it every step (a no-op otherwise)."""
        step = int(ts.step if step is None else step)
        if not force and (step == 0 or step % self.save_every != 0):
            return False
        params = _host(ts.params)
        train_state = {"trace": _host(ts.opt_state.trace), "count": int(ts.opt_state.count),
                       "step": int(ts.step)}
        self.wait()
        self._writer = threading.Thread(target=self._write, args=(step, params, train_state),
                                        daemon=True)
        self._writer.start()
        return True

    def _write(self, step: int, params: StateDict, train_state: dict) -> None:
        try:
            save_params(self.directory, step, params)
            _save_atomic(train_state,
                         os.path.join(self.directory, str(step), TRAIN_STATE_FILENAME))
            steps = sorted(int(d) for d in os.listdir(self.directory) if d.isdigit())
            for old in steps[:-self.max_to_keep] if self.max_to_keep > 0 else []:
                shutil.rmtree(os.path.join(self.directory, str(old)), ignore_errors=True)
        except Exception as e:  # re-raised by wait()
            self._error = e

    def wait(self) -> None:
        """Wait for the pending save; raise what it raised."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def restore_latest(self, template):
        """The newest checkpoint as a TrainState on the devices and dtypes of
        ``template``'s tensors (None if there is none). Its parameter names
        and shapes must equal the template's."""
        from tdrn_tpu_torch.train.trainer import SGDState, TrainState

        self.wait()
        step = self.latest_step()
        if step is None:
            return None
        step_dir = os.path.join(self.directory, str(step))
        state_path = os.path.join(step_dir, TRAIN_STATE_FILENAME)
        if not os.path.isfile(state_path):
            raise FileNotFoundError(
                f"{step_dir} holds params but no {TRAIN_STATE_FILENAME}: not a training "
                "checkpoint (use --init_from to start from its params)")
        params = load_params(self.directory, step)
        st = torch.load(state_path, map_location="cpu", weights_only=True)

        def like(src: StateDict, tmpl: StateDict, what: str) -> StateDict:
            if src.keys() != tmpl.keys():
                raise ValueError(f"{what} of {step_dir}: keys differ from the model's "
                                 f"({sorted(set(src) ^ set(tmpl))[:4]})")
            out = {}
            for k, t in tmpl.items():
                if tuple(src[k].shape) != tuple(t.shape):
                    raise ValueError(f"{what} {k}: shape {tuple(src[k].shape)} != {tuple(t.shape)}")
                out[k] = src[k].to(device=t.device, dtype=t.dtype)
            return out

        return TrainState(like(params, template.params, "params"),
                          SGDState(like(st["trace"], template.opt_state.trace, "momentum"),
                                   int(st["count"])),
                          int(st["step"]))

    def save_meta(self, meta: dict) -> None:
        save_meta(self.directory, meta)
