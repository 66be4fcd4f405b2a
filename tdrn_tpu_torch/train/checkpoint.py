"""Checkpoints of the port (the inference half of ``tdrn_tpu/train/checkpoint.py``).

A checkpoint directory holds

    <dir>/model_meta.json      the model's construction flags, the same file
                               and keys as the JAX package's trainer writes
    <dir>/<step>/params.pt     the port's ``state_dict`` (CPU tensors; an int8
                               QConv's weight stays int8), read with
                               ``torch.load(..., weights_only=True)``

and the newest step wins. ``tools/orbax_to_torch.py`` converts a JAX
package (orbax) checkpoint into this layout. A training state adds its own
files beside ``params.pt`` in the step's directory.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional, Tuple

import torch

META_FILENAME = "model_meta.json"
PARAMS_FILENAME = "params.pt"

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


def save_params(directory: str, step: int, state_dict: StateDict) -> str:
    """Write ``state_dict`` as step ``step``'s params (atomically: a reader
    never sees half a file); returns the file's path."""
    step_dir = os.path.join(directory, str(int(step)))
    os.makedirs(step_dir, exist_ok=True)
    path = os.path.join(step_dir, PARAMS_FILENAME)
    tensors = {k: v.detach().cpu().contiguous() for k, v in state_dict.items()}
    torch.save(tensors, path + ".tmp")
    os.replace(path + ".tmp", path)
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
