"""Rules of the port that hold without a GPU: it imports no JAX and nothing of
tdrn_tpu (its package, bench_torch.py, tools/device_bench_torch.py and the
*_torch.py CLIs), and no cv2 outside live_torch.py's own function; its
entry points refuse to run on a CUDA-less machine unless asked for the CPU;
the streaming step's path holds no host sync, which would break its CUDA
graph capture; chunk, fold-mean, pad-stem and every backbone, norm, stem,
cell and selection option of the JAX package no longer raise; its kernel
wrappers reject what their kernels do not take and never hand a non-CPU
tensor to the plain version; the ctypes signatures match the CUDA sources'
entry points."""

import ctypes
import dataclasses
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from tdrn_tpu_torch import _build
from tdrn_tpu_torch.config import TINY_64
from tdrn_tpu_torch.ops.cascade import fused_refine_cascade
from tdrn_tpu_torch.ops.detection import RawPredictions
from tdrn_tpu_torch.ops.nms_suppress import suppress_sorted
from tdrn_tpu_torch.ops.qconv import pack_weight, qconv
from tdrn_tpu_torch.ops.stem import fused_conv_stage, fused_stem_stage1
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "tdrn_tpu_torch")


def _modules():
    for dirpath, _, files in os.walk(PKG):
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT)[:-3]
                yield rel.replace(os.sep, ".").removesuffix(".__init__")


# The port's scripts at the root and under tools/ (they import torch and
# tdrn_tpu_torch at their top level, or drive the CLIs that do).
# tools/orbax_to_torch.py and tools/verify_pretrained_torch.py bridge the two
# packages and are not among them.
CLIS = ("serve_torch", "test_torch", "eval_torch", "live_torch", "profile_trace_torch",
        "train_torch")
SCRIPTS = ("bench_torch", "tools.device_bench_torch", "tools.train_bench_torch",
           "tools.synth_fidelity_torch", "tools.synth_vid_fidelity_torch") + CLIS


def test_import_leaves_out_jax_and_tdrn_tpu():
    mods = sorted(_modules())
    assert "tdrn_tpu_torch.inference" in mods and "tdrn_tpu_torch.models.detector" in mods
    assert "tdrn_tpu_torch.eval.runner" in mods and "tdrn_tpu_torch.eval.voc_eval" in mods
    for m in ("inference", "train.checkpoint", "data.image", "data.voc", "data.vid",
              "eval.motion", "utils.logging", "ops.matching", "train.loss", "train.trainer",
              "data.augment", "data.loader", "data.process_loader", "data.native"):
        assert f"tdrn_tpu_torch.{m}" in mods, m
    mods += SCRIPTS
    code = (
        "import sys\n"
        + "".join(f"import {m}\n" for m in mods)
        + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'tdrn_tpu' or m.startswith('tdrn_tpu.') or m in ('cv2', 'orbax')"
        " or m.startswith('orbax.')]\n"
        "print(bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
        timeout=120,
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout


_FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+tdrn_tpu(\.|\s|$)|from\s+tdrn_tpu(\.|\s)"
    r"|import\s+orbax\b|from\s+orbax\b)",
    re.M,
)


def _port_sources():
    scripts = ("chip_smoke.py", "chip_compare.py", "bench_torch.py",
               "tools/device_bench_torch.py", "tools/train_bench_torch.py",
               "tools/synth_fidelity_torch.py", "tools/synth_vid_fidelity_torch.py") + tuple(
        f"{c}.py" for c in CLIS)
    return [os.path.join(ROOT, f) for f in scripts] + [
        os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs if f.endswith(".py")
    ]


def test_source_names_no_jax_import():
    for path in _port_sources():
        with open(path) as fh:
            hit = _FORBIDDEN.search(fh.read())
        assert hit is None, f"{path}: {hit.group(0)!r}"
    assert _FORBIDDEN.search("from tdrn_tpu_torch.ops import nms") is None
    assert _FORBIDDEN.search("import tdrn_tpu.ops") is not None
    assert _FORBIDDEN.search("import orbax.checkpoint as ocp") is not None


_CV2 = re.compile(r"^([ \t]*)(import\s+cv2\b|from\s+cv2\b)", re.M)
# Inside a function only: live_torch.py (video capture, writing and drawing),
# chip_smoke.py (cv2.resize timed beside the port's, where cv2 exists),
# data/augment.py (the training augmentation's HSV, canvas and float resize)
# and data/process_loader.py (a worker sets OpenCV to one thread).
_CV2_IN_FUNCTION = ("live_torch.py", "chip_smoke.py", "augment.py", "process_loader.py")


def test_host_path_needs_no_cv2():
    """The serve/test/eval path decodes and resizes with data/image.py: no
    port module and no CLI imports cv2, and no script at module level; only
    the training augmentation calls it, from inside its functions."""
    for path in _port_sources():
        hits = _CV2.findall(open(path).read())
        if os.path.basename(path) in _CV2_IN_FUNCTION:
            assert all(indent for indent, _ in hits), f"{path}: cv2 at module level"
        else:
            assert not hits, f"{path}: imports cv2"
    assert any(_CV2.findall(open(os.path.join(ROOT, "live_torch.py")).read()))
    assert any(_CV2.findall(open(os.path.join(PKG, "data", "augment.py")).read()))
    assert _CV2.findall("\n\nimport cv2") == [("", "import cv2")]
    assert _CV2.search("    import cv2") and not _CV2.search("import cv2x")


# Calls that wait for the card or read its values on the host: any of them on
# the streaming step's path would break the step's CUDA graph capture.
_HOST_SYNC = re.compile(r"\.item\(\)|\.cpu\(\)|\.tolist\(\)|\.nonzero\(|torch\.nonzero")


def _step_path_sources():
    yield os.path.join(PKG, "inference.py")
    for sub in ("ops", "models"):
        d = os.path.join(PKG, sub)
        yield from (os.path.join(d, f) for f in sorted(os.listdir(d)) if f.endswith(".py"))


def test_step_path_has_no_host_sync():
    paths = list(_step_path_sources())
    assert len(paths) > 10
    for module in ("ops/qconv.py", "models/layers.py"):  # the int8 profile's step path
        assert os.path.join(PKG, module) in paths, module
    for path in paths:
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                hit = _HOST_SYNC.search(line)
                assert hit is None, f"{path}:{n}: {hit.group(0)!r} on the captured step's path"
    for bad in ("x.item()", "t.cpu()", "a.tolist()", "m.nonzero(as_tuple=True)", "torch.nonzero(m)"):
        assert _HOST_SYNC.search(bad) is not None, bad
    assert _HOST_SYNC.search("t.cpu_count, x.items()") is None


def test_chunk_fold_mean_and_pad_stem_are_ported():
    """No NotImplementedError is left for them, nor for a stem, cell,
    backbone, norm or selection option, in the source or in a call."""
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.models.detector import build_detector
    from tdrn_tpu_torch.utils.precision import apply_fold_mean, apply_pad_stem

    for dirpath, _, files in os.walk(PKG):
        for f in files:
            if not f.endswith(".py"):
                continue
            with open(os.path.join(dirpath, f)) as fh:
                src = fh.read()
            for m in re.finditer(r"NotImplementedError\(([^)]*)\)", src):
                assert not re.search(r"chunk|fold|pad|stem|cell|backbone|norm|approx|recall",
                                     m.group(1), re.I), f"{f}: {m.group(0)}"
    model = build_detector(TINY_64, width_mult=0.125, tcb_channels=32, device="cpu")
    assert StreamingDetector(model, chunk=2, device="cpu").model.chunk == 2
    assert apply_fold_mean(model).fold_mean and apply_pad_stem(model, 8).pad_stem == 8
    s2d = build_detector(TINY_64, stem="s2d", width_mult=0.125, tcb_channels=32, device="cpu")
    assert apply_fold_mean(s2d).backbone.conv1_1.in_channels == 16


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
    assert len(found) == len(_build._SIGNATURES) == 5
    assert _build._SIGNATURES["qconv"][0] == "tdrn_qconv"
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
    # The training entry points: train_torch.py and tools/train_bench_torch.py.
    import train_torch
    from tools import train_bench_torch

    for main, argv in ((train_torch.main, ["--data_root", ROOT]),
                       (train_bench_torch.main, ["--config", "tiny_64"])):
        for extra in ([], ["--device", "cuda"]):
            with pytest.raises(RuntimeError, match="CUDA"):
                main(argv + extra)


def test_unported_options_raise():
    """fp16 is not ported and raises; every combination the JAX package's
    build_detector builds (backbone, norm, stem, cell) builds and detects,
    with approx_topk and prefilter_recall < 1 on."""
    from tdrn_tpu_torch.inference import StreamingDetector
    from tdrn_tpu_torch.models.detector import build_detector

    small = dict(width_mult=0.125, tcb_channels=32, device="cpu")
    for kw in (dict(dtype=torch.float16), dict(head_dtype=torch.float16)):
        with pytest.raises(NotImplementedError):
            build_detector(TINY_64, **kw, **small)
    cfg = dataclasses.replace(TINY_64, approx_topk=True, prefilter_anchors=64,
                              prefilter_recall=0.9, fused_cascade=True)
    combos = [dict(backbone="vgg16", stem=s) for s in
              ("conv", "s2d", "poly", "poly2", "fused", "fused2")]
    combos += [dict(backbone="resnet101", backbone_norm=n, width_mult=0.0625)
               for n in ("frozen", "group")]
    frames = np.random.default_rng(0).integers(0, 256, (2, 64, 64, 3), dtype=np.uint8)
    for kw in combos:
        for cell in ("convgru", "light", "hybrid"):
            model = build_detector(cfg, temporal_cell=cell, **{**small, **kw})
            det = StreamingDetector(model, num_streams=2, device="cpu").detect(frames)
            assert det.scores.shape == (2, cfg.top_k) and bool(torch.isfinite(det.boxes).all())
            assert det.prefilter_overflow is not None
    for bad in (dict(backbone="resnet50"), dict(stem="s4d"), dict(temporal_cell="lstm"),
                dict(backbone="resnet101", backbone_norm="batch")):
        with pytest.raises(ValueError):
            build_detector(TINY_64, **{**small, **bad})


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


def test_qconv_wrapper_rejects_bad_input():
    """K5's wrapper: dtypes, shapes and contiguity of the weights, scales and
    packed weights, a square kernel, stride and dilation, the output dtype
    and a device with no kernel or plain version; an even Cout and 16-byte
    alignment are the kernel's own, checked on the card only. The input may
    come in any memory format and any channel count."""
    x = torch.zeros(1, 16, 6, 7, dtype=torch.bfloat16)
    w = torch.zeros(8, 3, 3, 16, dtype=torch.int8)
    s, fac, bias = torch.tensor(1.0), torch.ones(8), torch.zeros(8)
    assert qconv(x, w, s, fac, bias).shape == (1, 6, 7, 8)
    assert qconv(x, w, s, fac, bias, stride=2, out_dtype=torch.float32).shape == (1, 3, 4, 8)
    assert qconv(x.float().contiguous(memory_format=torch.channels_last), w, s, fac, bias,
                 wpack=pack_weight(w)).shape == (1, 6, 7, 8)
    assert qconv(x[:, :12], w[..., :12].contiguous(), s, fac, bias).shape == (1, 6, 7, 8)  # 12 channels
    for args, kw in [
        ((x.to(torch.int8), w, s, fac, bias), {}),
        ((x, w.float(), s, fac, bias), {}),
        ((x, w, s, fac.double(), bias), {}),
        ((x, w, s, fac, bias.bfloat16()), {}),
        ((x[0], w, s, fac, bias), {}),
        ((x, w[:, :, :, :8], s, fac, bias), {}),
        ((x, w[:, :, :2].contiguous(), s, fac, bias), {}),  # not square
        ((x, w.transpose(1, 2), s, fac, bias), {}),  # not contiguous
        ((x, w, s, fac[:4], bias), {}),
        ((x, w, s, fac, bias), {"stride": 0}),
        ((x, w, s, fac, bias), {"dilation": 0}),
        ((x, w, s, fac, bias), {"out_dtype": torch.float16}),
        ((x[:, :, :1, :1].contiguous(), torch.zeros(8, 2, 2, 16, dtype=torch.int8), s, fac, bias),
         {}),  # no output pixel
        ((x.to("meta"), w.to("meta"), s.to("meta"), fac.to("meta"), bias.to("meta")), {}),
        ((x.half(), w, s, fac, bias), {}),
        ((x, w, s.double(), fac, bias), {}),
        ((x, w, s[None], fac, bias), {}),
        ((x, w, s, fac, bias), {"wpack": pack_weight(w)[:, :64].contiguous()}),
    ]:
        with pytest.raises((TypeError, ValueError)):
            qconv(*args, **kw)
