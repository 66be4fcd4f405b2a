"""JAX parameter trees <-> the port's ``state_dict``.

The port's own copy of the rules of ``tdrn_tpu/utils/torch_weights.py``.
Module attribute names equal the flax module names, so a key is the flax
path joined with "." (leaf ``kernel`` -> ``weight``), and only layouts change:

  conv    kernel: flax HWIO            <-> torch OIHW
  deconv  kernel: flax (kH,kW,in,out)  <-> torch (in,out,kH,kW), spatially
          FLIPPED (lax.conv_transpose correlates with the kernel as stored;
          torch's ConvTranspose2d scatters it)
  scale / bias vectors: unchanged (L2Norm, FrozenBN and GroupNorm leaves
          are all named ``scale`` / ``bias``, as in the JAX tree).
  int8 QConv (a node with ``wscale``): kernel int8 HWIO <-> weight int8
          (O, H, W, I), kept int8; ``wscale``, ``xscale`` (0-dim) and
          ``bias`` fp32.

A torchvision ResNet checkpoint loads into the ResNet backbone through
:func:`load_resnet_backbone` (BatchNorm folded into FrozenBN), and a VGG-16
checkpoint (the reduced-fc ``vgg16_reducedfc.pth`` layout or torchvision's
``vgg16``) into the VGG backbone through :func:`load_vgg_backbone`.
:func:`init_weights` draws a training model's initial weights from a
``torch.Generator`` with the JAX package's initializers.
"""

from __future__ import annotations

from typing import Dict, Iterator, Optional, Tuple

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


def _quantized_nodes(tree, prefix=()) -> set:
    """Paths of the nodes of a JAX tree that are int8 QConvs (hold ``wscale``)."""
    found = {prefix} if "wscale" in tree else set()
    for k, v in tree.items():
        if isinstance(v, dict):
            found |= _quantized_nodes(v, prefix + (k,))
    return found


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """A JAX param tree (``{"params": ...}`` or bare; leaves array-like) -> the
    port's ``state_dict`` (CPU tensors: float32, and int8 for a QConv's
    weight)."""
    tree = tree["params"] if "params" in tree else tree
    quantized = _quantized_nodes(tree)
    out = {}
    for path, leaf in _flatten_tree(tree):
        if path[-1] == "kernel" and path[:-1] in quantized:
            v = np.asarray(leaf, np.int8).transpose(3, 0, 1, 2)  # HWIO -> (O, H, W, I)
            out[_torch_key(path)] = torch.from_numpy(np.ascontiguousarray(v))
            continue
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
        t = t.detach().cpu()
        if t.dtype == torch.int8:  # a QConv's weight, (O, H, W, I) -> HWIO
            path[-1] = "kernel"
            v = t.numpy().transpose(1, 2, 3, 0)
        else:
            v = t.float().numpy()  # bf16 has no numpy dtype
        if path[-1] == "weight":
            path[-1] = "kernel"
            if "deconv" in path:
                v = np.transpose(v, (2, 3, 0, 1))[::-1, ::-1]
            else:
                v = np.transpose(v, (2, 3, 1, 0))
        node = root
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = np.array(v, order="C")  # keeps a 0-dim leaf 0-dim
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
    L2Norm scales and the ResNet norms' scales as built, except each
    residual branch's last norm (bn3), whose scale is uniform in [0.1, 0.3),
    damped as in trained ResNets: at scale 1 the residual stream of
    ResNet-101 grows to ~150, and bf16 rounding alone then moves its outputs
    by 9 % of their max. An int8 QConv's buffers are left as they are:
    utils/quantize.apply_int8_backbone derives them from the float weights.
    The weights of the benchmarks and smoke runs."""
    rng = np.random.default_rng(seed)
    tree = params_to_jax(model.state_dict())

    def fill(node, name=""):
        if "wscale" in node:  # an int8 QConv
            return
        for key, v in node.items():
            if isinstance(v, dict):
                fill(v, key)
            elif key == "kernel":
                kh, kw, ci, co = v.shape
                lim = np.sqrt(6.0 / (kh * kw * (ci + co)))
                node[key] = rng.uniform(-lim, lim, v.shape).astype(np.float32)
            elif key == "bias":
                node[key] = rng.normal(0.0, 0.01, v.shape).astype(np.float32)
            elif key == "scale" and name == "bn3":  # a ResNet block's last norm
                node[key] = rng.uniform(0.1, 0.3, v.shape).astype(np.float32)

    fill(tree["params"])
    return load_jax_params(model, tree)


# --- torchvision ResNet checkpoints -> the ResNet backbone -----------------
#
# torchvision's key layout: conv1 / bn1 / layer{1..4}.{i}.conv{1..3} /
# layer{1..4}.{i}.bn{1..3} / layer{1..4}.{i}.downsample.{0,1}. Its convs are
# OIHW like the port's, and bias-free: the port's conv biases are set to 0.
# Each BatchNorm folds into a FrozenBN affine, in float64:
# scale = gamma / sqrt(var + eps), bias = beta - mean * scale.

BN_EPS = 1e-5


def _fold_bn(sd, prefix: str) -> Tuple[np.ndarray, np.ndarray]:
    f64 = lambda k: np.asarray(_numpy(sd[f"{prefix}.{k}"]), np.float64)
    scale = f64("weight") / np.sqrt(f64("running_var") + BN_EPS)
    bias = f64("bias") - f64("running_mean") * scale
    return scale.astype(np.float32), bias.astype(np.float32)


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _resnet_torch_prefix(module_path) -> Optional[str]:
    """A backbone-relative module path, e.g. ("stage2_0", "proj_bn"), -> its
    torchvision key prefix; None for modules with no pretrained weights
    (extra1, extra2)."""
    mod = module_path[0]
    if mod == "stem":
        return "conv1"
    if mod == "stem_bn":
        return "bn1"
    if mod.startswith("stage") and len(module_path) > 1:
        stage, block = mod[len("stage"):].split("_")
        sub = module_path[1]
        if sub.startswith(("conv", "bn")):
            return f"layer{stage}.{block}.{sub}"
        if sub in ("proj", "proj_bn"):
            return f"layer{stage}.{block}.downsample.{0 if sub == 'proj' else 1}"
    return None


def resnet_backbone_from_torchvision(sd, template):
    """Fill a ResNet backbone's state dict from a torchvision ResNet state dict.

    ``template``: the backbone's ``state_dict()`` (keys relative to the
    backbone, FrozenBN norm). Returns (new state dict of float32 CPU tensors,
    loaded keys, skipped keys). Every key that maps is checked strictly for
    its shape; modules with no pretrained weights (extra1, extra2) keep their
    template values and are listed as skipped."""
    out, loaded, skipped = {}, [], []
    for key, value in template.items():
        path = key.split(".")
        leaf, prefix = path[-1], _resnet_torch_prefix(path[:-1])
        if prefix is None:
            out[key] = value.detach().cpu().float()
            skipped.append(key)
            continue
        if leaf == "weight":  # a conv kernel, OIHW on both sides
            w = np.asarray(_numpy(sd[f"{prefix}.weight"]), np.float32)
        elif f"{prefix}.running_mean" not in sd:  # a conv bias
            w = np.zeros(tuple(value.shape), np.float32)
        else:  # FrozenBN scale / bias from the folded BatchNorm
            w = _fold_bn(sd, prefix)[0 if leaf == "scale" else 1]
        if tuple(w.shape) != tuple(value.shape):
            raise ValueError(f"{prefix} -> {key}: shape {w.shape} != template {tuple(value.shape)}")
        out[key] = torch.from_numpy(np.array(w))
        loaded.append(key)
    return out, loaded, skipped


def load_resnet_backbone(model: torch.nn.Module, source):
    """Load a torchvision ResNet checkpoint into ``model.backbone`` (a ResNet
    backbone with FrozenBN norm). ``source``: a state dict, or the path of a
    file that ``torch.load`` reads (a state dict or {"state_dict": ...}).
    Returns (model, loaded keys, skipped keys)."""
    sd = source
    if not isinstance(source, dict):
        sd = torch.load(source, map_location="cpu", weights_only=True)
    sd = sd.get("state_dict", sd)
    new, loaded, skipped = resnet_backbone_from_torchvision(sd, model.backbone.state_dict())
    model.backbone.load_state_dict(new, strict=True)
    return model, loaded, skipped


# --- VGG-16 checkpoints -> the VGG backbone ---------------------------------
#
# ssd.pytorch's reduced-fc ``nn.Sequential`` (integer keys, conv6/conv7
# included) or torchvision's ``vgg16`` (``features.<i>``, no conv6/conv7).
# Both are OIHW like the port, so the kernels load as they are.

_REDUCEDFC_MAP = {
    0: "conv1_1", 2: "conv1_2",
    5: "conv2_1", 7: "conv2_2",
    10: "conv3_1", 12: "conv3_2", 14: "conv3_3",
    17: "conv4_1", 19: "conv4_2", 21: "conv4_3",
    24: "conv5_1", 26: "conv5_2", 28: "conv5_3",
    31: "conv6", 33: "conv7",
}
_TORCHVISION_VGG_MAP = {i: n for i, n in _REDUCEDFC_MAP.items() if i < 31}


def vgg_params_from_state_dict(sd) -> Dict[str, Dict[str, torch.Tensor]]:
    """Detect the layout and return {conv name: {"weight": OIHW, "bias"}}
    (float32 CPU tensors) for the convs the state dict holds."""
    if any(k.startswith("features.") for k in sd):
        idx_map, prefix = _TORCHVISION_VGG_MAP, "features."
    else:
        idx_map, prefix = _REDUCEDFC_MAP, ""
    out = {}
    for idx, name in idx_map.items():
        wk, bk = f"{prefix}{idx}.weight", f"{prefix}{idx}.bias"
        if wk not in sd:
            continue
        out[name] = {"weight": torch.from_numpy(np.array(_numpy(sd[wk]), np.float32)),
                     "bias": torch.from_numpy(np.array(_numpy(sd[bk]), np.float32))}
    return out


def load_vgg_backbone(model: torch.nn.Module, source, strict: bool = False):
    """Load a VGG-16 checkpoint into ``model.backbone`` (VGG16Reduced).
    ``source``: a state dict, or the path of a file ``torch.load`` reads.
    Layers the model lacks or whose shape differs (a torchvision checkpoint
    has no conv6/conv7; the s2d stem's conv1_1) are skipped, or raise under
    ``strict``. Returns (model, loaded names, skipped names)."""
    sd = source
    if not isinstance(source, dict):
        sd = torch.load(source, map_location="cpu", weights_only=True)
        if hasattr(sd, "state_dict"):
            sd = sd.state_dict()
    backbone = model.backbone
    loaded, skipped = [], []
    for name, new in vgg_params_from_state_dict(sd).items():
        conv = getattr(backbone, name, None)
        if conv is None:
            skipped.append(name)
            continue
        if tuple(conv.weight.shape) != tuple(new["weight"].shape):
            if strict:
                raise ValueError(f"{name}: shape {tuple(new['weight'].shape)} != "
                                 f"{tuple(conv.weight.shape)}")
            skipped.append(name)
            continue
        with torch.no_grad():
            conv.weight.copy_(new["weight"])
            conv.bias.copy_(new["bias"])
        loaded.append(name)
    if strict and skipped:
        raise ValueError(f"unloaded layers: {skipped}")
    return model, loaded, skipped


# --- Initial weights for training -------------------------------------------


def init_weights(model: torch.nn.Module, generator: torch.Generator) -> torch.nn.Module:
    """Draw the initial weights of a freshly built detector from ``generator``
    with the JAX package's initializers: xavier-uniform conv kernels and zero
    biases, except flax's default lecun-normal (truncated at 2 std) on the
    layers built without an initializer (the ResNet stem and ``proj``
    shortcuts, the TCB deconvs), and the temporal cells' pass-through init.
    The L2Norm scales and the ResNet norms keep their built values. The
    model and ``generator`` are on the CPU (move the model afterwards)."""
    from tdrn_tpu_torch.models.temporal import TemporalPropagation

    if any(p.device.type != "cpu" for p in model.parameters()):
        raise ValueError("init_weights draws on the CPU: build the model with device='cpu'")

    cells = set()
    with torch.no_grad():
        for name, mod in model.named_modules():
            if isinstance(mod, TemporalPropagation):
                for cell in mod.children():
                    cell.reset_parameters(generator=generator)
                    cells.update(id(m) for m in cell.modules())
                continue
            if id(mod) in cells or not isinstance(mod, (torch.nn.Conv2d, torch.nn.ConvTranspose2d)):
                continue
            leaf = name.rsplit(".", 1)[-1]
            lecun = isinstance(mod, torch.nn.ConvTranspose2d) or (
                name.startswith("backbone.") and leaf in ("stem", "proj"))
            w = mod.weight
            if lecun:
                # flax variance_scaling(1, "fan_in", "truncated_normal"); the
                # fan-in is the kernel's taps times its input channels.
                cin = w.shape[0] if isinstance(mod, torch.nn.ConvTranspose2d) else w.shape[1]
                std = float(np.sqrt(1.0 / (cin * w.shape[2] * w.shape[3]))) / 0.87962566103423978
                torch.nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
            else:
                torch.nn.init.xavier_uniform_(w, generator=generator)
            if mod.bias is not None:
                mod.bias.zero_()
    return model
