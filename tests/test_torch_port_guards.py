"""Rules of the port that hold without a GPU: it imports no JAX and nothing of
tdrn_tpu; its entry points refuse to run on a CUDA-less machine unless asked
for the CPU; its kernel wrappers reject what their kernels do not take and
never hand a non-CPU tensor to the plain version; the ctypes signatures
match the CUDA sources' entry points."""

import ctypes
import os
import re
import subprocess
import sys

import pytest
import torch

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.config import TINY_64
from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
from tdrn_tpu_torch.ops.stem import fused_conv_stage, fused_stem_stage1

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tdrn_tpu_torch")


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


def test_import_leaves_out_jax_and_tdrn_tpu():
    mods = sorted(_modules())
    assert "tdrn_tpu_torch.inference" in mods and "tdrn_tpu_torch.models.detector" in mods
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tdrn_tpu' or m.startswith('tdrn_tpu.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+tdrn_tpu(\.|\s|$)|from\s+tdrn_tpu(\.|\s))",
    re.M,
)


def test_source_names_no_jax_import():
    for path in [os.path.join(ROOT, f) for f in ("chip_smoke.py", "chip_compare.py")] + [
        os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")
    ]:
        with open(path) as fh:
            hit = _FORBIDDEN.search(fh.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"
    assert _FORBIDDEN.search("from tdrn_tpu_torch.ops import nms") is None
    assert _FORBIDDEN.search("import tdrn_tpu.ops") is not None


_EXTERN_C = re.compile(r'extern\s+"C"\s+int\s+(\w+)\s*\(([^)]*)\)')
_CTYPE = {"ptr": ctypes.c_void_p, "int": ctypes.c_int, "float": ctypes.c_float}


def _param_kind(param: str) -> str:
    """'ptr', 'int' or 'float' for one C parameter declaration."""
    if "*" in param:
        return "ptr"
    words = param.replace("const", " ").split()
    assert len(words) == 2 and words[0] in ("int", "float"), param
    return words[0]


def test_entry_point_signatures_match_the_sources():
    """Every extern "C" function in csrc/*.cu has a _build._SIGNATURES entry
    under its file's name with the same name, arity and pointer/int/float
    kinds, and every entry has such a function: otherwise ctypes would pass
    a pointer as a 32-bit int, or the wrong number of arguments."""
    csrc = os.path.join(PKG, "csrc")
    found = {}
    for f in sorted(os.listdir(csrc)):
        if f.endswith(".cu"):
            with open(os.path.join(csrc, f)) as fh:
                for fn, params in _EXTERN_C.findall(fh.read()):
                    kinds = [_CTYPE[_param_kind(p)] for p in params.split(",")]
                    found[fn] = (f[:-3], kinds)
    assert len(found) == len(_build._SIGNATURES) == 4
    for name, (fn, argtypes) in _build._SIGNATURES.items():
        assert fn in found, f"{name}: no extern \"C\" {fn} in csrc/"
        src, kinds = found[fn]
        assert src == name, f"{fn} is in {src}.cu, expected {name}.cu"
        assert argtypes == kinds, f"{fn}: _SIGNATURES {argtypes} against the source's {kinds}"
    assert _param_kind("const void* x") == "ptr" and _param_kind("int B") == "int"
    assert _param_kind("float iou_thresh") == "float"


def test_entry_points_refuse_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.models.detector import build_detector

    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            build_detector(TINY_64, width_mult=0.125, tcb_channels=32, **kw)
    model = build_detector(TINY_64, width_mult=0.125, tcb_channels=32, device="cpu")
    for kw in ({}, {"device": "cuda"}):
        with pytest.raises(RuntimeError, match="CUDA"):
            StreamingDetector(model, **kw)
    with pytest.raises(RuntimeError, match="CUDA"):
        _build.library("stem")


def test_unported_options_raise():
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.models.detector import build_detector

    small = dict(width_mult=0.125, tcb_channels=32, device="cpu")
    for kw in (dict(stem="s2d"), dict(dtype=torch.float16), dict(temporal_cell="light"),
               dict(backbone="resnet101"), dict(head_dtype=torch.float16)):
        with pytest.raises(NotImplementedError):
            build_detector(TINY_64, **kw, **small)
    with pytest.raises(NotImplementedError):
        StreamingDetector(build_detector(TINY_64, **small), chunk=2, device="cpu")


def _preds(p=255, c=4, b=1):
    return RawPredictions(
        torch.zeros(b, p, 4), torch.zeros(b, p, 2), torch.zeros(b, p, 4), torch.zeros(b, p, c)
    )


def test_cascade_wrapper_rejects_bad_input():
    priors = torch.full((255, 4), 0.5)
    fused_refine_cascade(_preds(), priors, TINY_64)
    fused_refine_cascade(_preds(), priors, TINY_64, torch.empty(1, 255))
    bad = [
        (_preds()._replace(odm_conf=torch.zeros(1, 255, 4, dtype=torch.float64)), priors, None),
        (_preds()._replace(arm_loc=torch.zeros(1, 4, 255).transpose(1, 2)), priors, None),
        (_preds()._replace(arm_conf=torch.zeros(1, 255, 3)), priors, None),
        (_preds(), priors[:100], None),
        (_preds()._replace(arm_loc=torch.zeros(1, 255, 4, device="meta")), priors, None),
        # the per-anchor buffer: shape, dtype, layout, device
        (_preds(), priors, torch.empty(1, 254)),
        (_preds(), priors, torch.empty(255)),
        (_preds(), priors, torch.empty(1, 255, dtype=torch.float64)),
        (_preds(), priors, torch.empty(1, 510)[:, ::2]),
        (_preds(), priors, torch.empty(1, 255, device="meta")),
    ]
    for preds, pri, top in bad:
        with pytest.raises((TypeError, ValueError)):
            fused_refine_cascade(preds, pri, TINY_64, top)


def test_nms_wrapper_rejects_bad_input():
    boxes, scores = torch.zeros(3, 10, 4), torch.ones(3, 10)
    suppress_sorted(boxes, scores)
    for b, s in [
        (boxes.double(), scores),
        (boxes, scores.half()),
        (torch.zeros(3, 4, 10).transpose(1, 2), scores),
        (boxes, torch.ones(3, 11)),
        (boxes.to("meta"), scores.to("meta")),
    ]:
        with pytest.raises((TypeError, ValueError)):
            suppress_sorted(b, s)


def test_stem_wrapper_rejects_bad_input():
    """K3 and K4 alike."""
    for wrapper, cout in ((fused_stem_stage1, 8), (fused_conv_stage, 16)):
        _rejects_bad_input(wrapper, cout)


def _rejects_bad_input(wrapper, cout):
    x = torch.zeros(1, 8, 8, 3)
    k1, b1 = torch.zeros(3, 3, 3, 8), torch.zeros(8)
    k2, b2 = torch.zeros(3, 3, 8, cout), torch.zeros(cout)
    assert wrapper(x, k1, b1, k2, b2).shape == (1, 4, 4, cout)
    bf = lambda t: t.to(torch.bfloat16)
    assert wrapper(bf(x), bf(k1), bf(b1), bf(k2), b2).dtype == torch.bfloat16
    for args, kw in [
        ((x.double(), k1, b1, k2, b2), {}),
        ((bf(x), k1, b1, k2, b2), {}),
        ((x, k1, b1.half(), k2, b2), {}),
        ((torch.zeros(1, 3, 8, 8).permute(0, 2, 3, 1), k1, b1, k2, b2), {}),
        ((torch.zeros(1, 7, 8, 3), k1, b1, k2, b2), {}),
        ((x, k1, b1, torch.zeros(3, 3, 8, 24), b2), {}),
        ((x, k1, b1, k2, b2), {"compute_dtype": torch.float16}),
        ((x, k1, b1, k2, b2), {"out_dtype": torch.float16}),
        ((x.to("meta"), k1.to("meta"), b1.to("meta"), k2.to("meta"), b2.to("meta")), {}),
    ]:
        with pytest.raises((TypeError, ValueError)):
            wrapper(*args, **kw)
