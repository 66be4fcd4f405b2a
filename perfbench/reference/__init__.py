"""The plain references of the benchmark's configurations.

A configuration file names its reference with ``"reference": "<stem>"``,
the module ``perfbench/reference/<stem>.py``; without the key it is
``model`` (TDRN on VGG-16 or ResNet-101). :func:`reference` (also
``bench.reference``) returns the module, and every caller goes through
it. A reference module keeps:

``param_spec(cfg)``
    ``(name, shape, kind)`` of every parameter of the program's model, in a
    fixed order; the benchmark draws its weights by it (``kind``:
    ``kernel``, ``bias``, ``bn_scale``, ``bn3_scale`` or ``l2norm``).
``FP32_GROUPS``
    the top-level groups of those names that the serving profile keeps in
    float32 where the configuration's ``precision`` is bf16.
``zero_state(cfg, batch, device)``
    the carried state at a snippet's start.
``preprocess(cfg, frames_u8)``
    uint8 (B, H, W, 3) frames -> the forward's input.
``forward(cfg, weights, x, state, lowp=None)``
    ``((arm_loc, arm_conf, odm_loc, odm_conf), new_state)``; ``lowp``,
    where given, rounds every tensor the serving profile holds in bf16
    (the control's :func:`fp8`).

It computes in float32 (the harness turns TF32 off before it runs), imports
nothing of the measured program and nothing of JAX, and takes nothing the
program made. It may import the pieces of ``model`` it shares (``tcb``,
``head``, ``convgru``, ``arm_guided_sampling``) rather than copy them. The
detect tail (``detect.py``) and the control's rounding (:func:`fp8`) are
shared by every configuration.
"""

from __future__ import annotations

import importlib
from types import ModuleType

import torch


def reference(cfg: dict) -> ModuleType:
    """The plain reference module of a configuration: ``reference/<stem>.py``,
    ``stem`` the file's ``reference`` key, ``model`` where it has none."""
    stem = cfg.get("reference", "model")
    if not stem.isidentifier():
        raise ValueError(f"configuration {cfg.get('name')!r}: reference {stem!r} is no module name")
    return importlib.import_module(f"{__name__}.{stem}")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with one scale for the tensor (its largest
    magnitude to 448): the precision below bf16, the control's."""
    amax = x.abs().amax().clamp(min=1e-30)
    return (x * (448.0 / amax)).to(torch.float8_e4m3fn).to(torch.float32) * (amax / 448.0)
