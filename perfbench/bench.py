"""What every cell shares: finding a cell's files by the names in
BENCHMARK.json, the program's model for a configuration, and the weights
and frames drawn from the seed.

A cell (an entry of ``workloads``) names a configuration and a traffic mix.
The configuration is the file its ``configs`` entry names
(``configs/<config>.json``); the file's optional ``reference`` key names its
plain reference, ``reference/<stem>.py`` (``model`` without the key; the
contract and :func:`reference` in reference/__init__.py). The traffic mix is
``traffic/<traffic>.json``, whose ``driver`` names the generator under
``drivers/`` that runs it; the limits of the cell's output comparison are
``limits/<cell>.json``; a per-layer metric is read by
``metrics/<name>.py``, or by the file of its name without the last dotted
part (``mfu.clips`` -> ``metrics/mfu.py``); the bound of each hand-written
kernel of the program is ``kernels/<kernel>.py`` (roofline.py).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from perfbench.reference import reference  # noqa: F401  (bench.reference, the name callers use)

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_json(path: str) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _for_cell(metrics: List[dict], cell: str, reported=None) -> List[dict]:
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell in m["workloads"]:
                out.append(m)
        elif reported is None or m["moves"] in reported:
            out.append(m)
    return out


def find_cell(name: str, bench: Optional[dict] = None) -> Cell:
    bench = bench or benchmark()
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json (have {sorted(by_name)})")
    w = by_name[name]
    cfg_entry = next(c for c in bench["configs"] if c["name"] == w["config"])
    e2e = _for_cell(bench["end_to_end"], name)
    reported = {m["name"] for m in e2e}
    return Cell(
        name=name, chips=int(w["chips"]),
        config=load_json(os.path.join(ROOT, cfg_entry["file"])),
        traffic=load_json(os.path.join(HERE, "traffic", f"{w['traffic']}.json")),
        limits=load_json(os.path.join(HERE, "limits", f"{name}.json")),
        end_to_end=e2e, per_layer=_for_cell(bench["per_layer"], name, reported),
    )


def load_module(path: str):
    spec = importlib.util.spec_from_file_location(
        "perfbench_" + os.path.basename(path)[:-3].replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(traffic: dict):
    return importlib.import_module(f"perfbench.drivers.{traffic['driver']}")


def reader(metric: str):
    """The reader module of a per-layer metric."""
    for stem in (metric, metric.rsplit(".", 1)[0]):
        path = os.path.join(HERE, "metrics", f"{stem}.py")
        if os.path.exists(path):
            return load_module(path)
    raise FileNotFoundError(f"no reader for per-layer metric {metric!r} under perfbench/metrics")


# ------------------------------------------------------------------ the program


GEOMETRY = ("num_classes", "size", "feature_maps", "steps", "min_sizes", "aspect_ratios",
            "variance", "conf_thresh", "nms_thresh", "top_k", "arm_filter_thresh",
            "pixel_means", "prefilter_anchors", "fused_cascade")


def port_config(cfg: dict):
    """The program's DetectorConfig for a configuration file, held equal to
    the file's geometry (the reference reads the file)."""
    from tdrn_tpu_torch.config import get_config

    out = dataclasses.replace(get_config(cfg["dataset"]), fused_cascade=bool(cfg["fused_cascade"]),
                              prefilter_anchors=int(cfg["prefilter_anchors"]))
    for key in GEOMETRY:
        have = getattr(out, key)
        want = cfg[key]
        norm = lambda v: json.loads(json.dumps(v))  # tuples -> lists
        if norm(have) != norm(want):
            raise ValueError(f"configuration {cfg['name']}: {key} is {want} in the file, "
                             f"{have} in the program")
    return out


def build_model(cfg: dict, device, stem: Optional[str] = None):
    """The program's detector for a configuration, float32, built on the
    device (its own initial values; the benchmark's weights replace them)."""
    from tdrn_tpu_torch.models.detector import build_detector

    return build_detector(
        port_config(cfg), backbone=cfg["backbone"], temporal=True,
        stem=stem or cfg.get("stem", "conv"), temporal_cell=cfg["temporal_cell"],
        tcb_channels=int(cfg["tcb_channels"]), width_mult=float(cfg.get("width_mult", 1.0)),
        backbone_norm=cfg.get("backbone_norm") or "frozen", device=device)


# ----------------------------------------------------------- inputs from the seed


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The weights of a run, drawn on ``device`` from ``seed`` in three large
    draws: xavier-uniform kernels, N(0, 0.01) biases (the norms' too), the
    last norm of each ResNet bottleneck uniform in [0.1, 0.3) (damped, as in
    trained ResNets: at scale 1 the residual stream of ResNet-101 grows past
    100 and bf16 rounding alone moves its outputs by 9 %), the other norm
    scales 1 and the L2Norm scales 10 and 8, as built; in the dtypes the
    configuration serves them in (``precision`` bf16: bf16 but for the heads
    and L2Norm scales)."""
    ref = reference(cfg)
    spec = ref.param_spec(cfg)
    gen = generator(seed, device)
    count = lambda kind: sum(int(np.prod(s)) for _, s, k in spec if k == kind)
    uniform = torch.rand(count("kernel"), generator=gen, device=device) * 2 - 1
    normal = torch.randn(count("bias"), generator=gen, device=device) * 0.01
    damped = 0.1 + 0.2 * torch.rand(max(count("bn3_scale"), 1), generator=gen, device=device)
    taken = {"kernel": 0, "bias": 0, "bn3_scale": 0}
    l2 = iter((10.0, 8.0))
    out = {}
    for name, shape, kind in spec:
        n = int(np.prod(shape))
        if kind in taken:
            src = {"kernel": uniform, "bias": normal, "bn3_scale": damped}[kind]
            t = src[taken[kind]:taken[kind] + n].view(shape)
            taken[kind] += n
            if kind == "kernel":
                t = t * float(np.sqrt(6.0 / (shape[2] * shape[3] * (shape[0] + shape[1]))))
        else:
            t = torch.full(shape, next(l2) if kind == "l2norm" else 1.0, device=device)
        lowp = cfg["precision"] == "bf16" and name.split(".")[0] not in ref.FP32_GROUPS
        out[name] = t.to(torch.bfloat16 if lowp else torch.float32).contiguous()
    return out


def load_weights(model, weights: Dict[str, torch.Tensor]):
    """Copy the benchmark's weights into the program's model, every name and
    shape matched (load_state_dict, strict)."""
    with torch.no_grad():
        model.load_state_dict(weights, strict=True)
    return model


def frame_pool(seed: int, lanes: int, per_lane: int, size: int, device) -> np.ndarray:
    """(per_lane, lanes, size, size, 3) uint8 frames drawn on ``device`` from
    the seed, on the host: frame i of lane l is pool[i % per_lane, l]. A
    frame is a smooth random field (bilinear upsampling of a 1/16 grid) with
    grain, so that it has image-like structure."""
    gen = generator(seed + 1, device)
    n = per_lane * lanes
    coarse = torch.rand((n, 3, max(size // 16, 2), max(size // 16, 2)), generator=gen,
                        device=device) * 255.0
    smooth = torch.nn.functional.interpolate(coarse, size=(size, size), mode="bilinear",
                                             align_corners=False)
    grain = torch.randn((n, 3, size, size), generator=gen, device=device) * 12.0
    frames = (smooth + grain).clamp(0, 255).round().to(torch.uint8)
    frames = frames.permute(0, 2, 3, 1).reshape(per_lane, lanes, size, size, 3)
    return frames.cpu().numpy()
