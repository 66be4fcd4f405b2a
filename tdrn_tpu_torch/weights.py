"""JAX parameter trees <-> the port's ``state_dict``.

The port's own copy of the rules of ``tdrn_tpu/utils/torch_weights.py``.
Module attribute names equal the flax module names, so a key is the flax
path joined with "." (leaf ``kernel`` -> ``weight``), and only layouts change:

  conv    kernel: flax HWIO            <-> torch OIHW
  deconv  kernel: flax (kH,kW,in,out)  <-> torch (in,out,kH,kW), spatially
          FLIPPED (lax.conv_transpose correlates with the kernel as stored;
          torch's ConvTranspose2d scatters it)
  scale / bias vectors: unchanged.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import numpy as np
import torch


def _flatten_tree(tree, prefix=()) -> Iterator[Tuple[tuple, np.ndarray]]:
    """Yield (path, leaf) for a nested dict of arrays."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten_tree(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _torch_key(path) -> str:
    suffix = "weight" if path[-1] == "kernel" else path[-1]
    return ".".join(path[:-1] + (suffix,))


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A JAX param tree (``{"params": ...}`` or bare; leaves array-like) -> the
    port's ``state_dict`` (float32 CPU tensors)."""
    tree = tree["params"] if "params" in tree else tree
    out = {}
    for path, leaf in _flatten_tree(tree):
        v = np.asarray(leaf, np.float32)
        if path[-1] == "kernel":
            if "deconv" in path:
                v = np.transpose(v[::-1, ::-1], (2, 3, 0, 1))
            else:
                v = np.transpose(v, (3, 2, 0, 1))
        out[_torch_key(path)] = torch.from_numpy(np.array(v))
    return out


def params_to_jax(state_dict) -> dict:
    """The port's ``state_dict`` -> ``{"params": nested dict of numpy arrays}``."""
    root: dict = {}
    for key, t in state_dict.items():
        path = key.split(".")
        v = t.detach().cpu().float().numpy()  # bf16 has no numpy dtype
        if path[-1] == "weight":
            path[-1] = "kernel"
            if "deconv" in path:
                v = np.transpose(v, (2, 3, 0, 1))[::-1, ::-1]
            else:
                v = np.transpose(v, (2, 3, 1, 0))
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.ascontiguousarray(v)
    return {"params": root}


def load_jax_params(model: torch.nn.Module, tree) -> torch.nn.Module:
    """Load a JAX param tree into ``model`` strictly: a missing or extra key,
    or a shape mismatch, raises. Each tensor takes its parameter's dtype; into
    a bf16 parameter that rounds to nearest even, as ``astype(bfloat16)`` does."""
    model.load_state_dict(params_from_jax(tree), strict=True)
    return model


def load_random_params(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """Load a seeded numpy draw in the JAX layout into ``model`` through
    :func:`load_jax_params`: xavier-uniform kernels, small normal biases, the
    L2Norm scales as built. The weights of the benchmarks and smoke runs."""
    rng = np.random.default_rng(seed)
    tree = params_to_jax(model.state_dict())

    def fill(node):
        for key, v in node.items():
            if isinstance(v, dict):
                fill(v)
            elif key == "kernel":
                kh, kw, ci, co = v.shape
                lim = np.sqrt(6.0 / (kh * kw * (ci + co)))
                node[key] = rng.uniform(-lim, lim, v.shape).astype(np.float32)
            elif key == "bias":
                node[key] = rng.normal(0.0, 0.01, v.shape).astype(np.float32)

    fill(tree["params"])
    return load_jax_params(model, tree)
