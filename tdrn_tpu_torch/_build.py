"""Device selection, and the nvcc build + ctypes binding of the CUDA kernels.

Each ``csrc/<name>.cu`` exports a plain C function and is compiled on its own
with nvcc for ``sm_90a`` into ``build/tdrn_tpu_torch/lib<name>_<hash>.so``
under the repository root. The hash covers the source, the shared headers
``csrc/*.cuh``, its flags and the nvcc version, so a library is rebuilt
exactly when one of them changes, at the first call that needs it.
``build_all`` starts every nvcc at once.

Set-up counters of the process: ``build_all.compiled``, the sources nvcc
compiled; ``library.seconds``, each library's first load in seconds (the
nvcc version check, any build and the ``ctypes`` load), which the
benchmark's ``setup.build_s`` reads.

Pointers and the CUDA stream go to the C functions as ``c_void_p``; each C
function launches on the stream it is given, allocates nothing and returns
``cudaGetLastError()``, which :func:`check` turns into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

import torch

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "tdrn_tpu_torch")

_COMMON = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
# Per-source flags. nms_suppress keeps every IoU operation separately rounded
# (no FMA contraction) so its keep mask is bit-equal to the plain version.
_EXTRA = {"cascade": [], "nms_suppress": ["-fmad=false"], "stem": [], "conv_stage": [],
          "qconv": [], "affine_act": []}

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# C signature of each kernel's entry point: (name, argtypes).
_SIGNATURES = {
    # arm_loc, arm_conf, odm_loc, odm_conf, priors, boxes, scores_cm,
    # per_anchor (or null), B, P, C, v0, v1, arm_thresh, stream
    "cascade": ("tdrn_cascade", [_P] * 8 + [_I, _I, _I, _F, _F, _F, _P]),
    # boxes, scores, out, N, K, iou_thresh, stream
    "nms_suppress": ("tdrn_nms_suppress", [_P, _P, _P, _I, _I, _F, _P]),
    # x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, in_bf16, round_bf16,
    # out_bf16, stream
    "stem": ("tdrn_stem", [_P] * 6 + [_I] * 9 + [_P]),
    # x, k1, b1, k2, b2, out, B, H, W, Cin, Cmid, Cout, in_bf16, out_bf16, stream
    "conv_stage": ("tdrn_conv_stage", [_P] * 6 + [_I] * 8 + [_P]),
    # x, w (packed), s, fac, bias, out, ws (or null), B, H, W, C, Cout, KH, KW,
    # stride, dilation, sb, sh, sw, sc, x_bf16, out_bf16, bn, splits, stages,
    # flat, kp, grid, stream
    "qconv": ("tdrn_qconv", [_P] * 7 + [_I] * 21 + [_P]),
    # x, conv_bias (or null), scale, bias, res (or null), res_conv_bias,
    # res_scale, res_bias (or null), rows, C, shortcut, stream
    "affine_act": ("tdrn_affine_act", [_P] * 8 + [_I] * 3 + [_P]),
}

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names another.

    With no device given and no CUDA device present this raises; the port
    never falls back to the CPU on its own.
    """
    if device is None:
        device = "cuda"
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the plain "
            "PyTorch versions on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


@functools.lru_cache(maxsize=None)
def _toolchain():
    """(nvcc path, its --version text); the version is part of every hash."""
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    nvcc = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(nvcc):
        nvcc = shutil.which("nvcc")
        if nvcc is None:
            raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout
    return nvcc, version


def _lib_path(name: str) -> str:
    src = b""
    for path in [os.path.join(_CSRC, f"{name}.cu")] + sorted(glob.glob(os.path.join(_CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            src += f.read()
    flags = " ".join(_COMMON + _EXTRA[name])
    digest = hashlib.sha256(src + flags.encode() + _toolchain()[1].encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"lib{name}_{digest[:16]}.so")


def build_all(names=None) -> Dict[str, str]:
    """Compile the named kernels (default: all) whose library is missing.

    One nvcc process per source, all started together. Returns
    {name: compiler output} for the sources that were compiled; raises
    with the compiler's output if any build fails.
    """
    names = list(names or _SIGNATURES)
    nvcc = _toolchain()[0]
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        path = _lib_path(name)
        if os.path.exists(path):
            continue
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = [nvcc, *_COMMON, *_EXTRA[name], "-o", tmp,
               os.path.join(_CSRC, f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, path)
    logs, failed = {}, []
    for name, (proc, tmp, path) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
            continue
        os.replace(tmp, path)  # atomic: a concurrent process sees all or nothing
        build_all.compiled += 1
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


build_all.compiled = 0


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        if not torch.cuda.is_available():
            raise RuntimeError(f"kernel {name} needs a CUDA device")
        t0 = time.perf_counter()
        build_all([name])
        lib = ctypes.CDLL(_lib_path(name))
        fn_name, argtypes = _SIGNATURES[name]
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _libs[name] = lib
        library.seconds[name] = time.perf_counter() - t0
        return lib


library.seconds = {}


def entry(name: str):
    """The C entry point of kernel ``name``."""
    return getattr(library(name), _SIGNATURES[name][0])


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(name: str, err: int) -> None:
    """Raise if a kernel's launch returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"kernel {name} launch failed with CUDA error {err}")


def require(t: torch.Tensor, name: str, shape, dtype=torch.float32) -> None:
    """Validate a kernel argument: dtype, shape and contiguity."""
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def route(*tensors: torch.Tensor) -> str:
    """'cpu' (plain version) or 'cuda' (kernel) for tensors on one device."""
    dev = tensors[0].device
    if any(t.device != dev for t in tensors):
        raise ValueError("kernel arguments lie on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no kernel or plain version for device {dev}")
    return dev.type
