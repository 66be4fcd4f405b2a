"""ctypes binding of the native JPEG decoder ``csrc/libtdrn_io.so``: the port's
counterpart of ``tdrn_tpu/data/native.py``, with its API and argtypes.

The library decodes a JPEG (libjpeg), resizes it bilinearly and subtracts
the mean in C++, one image or a batch over its own thread pool. It is
committed built: it links ``libjpeg.so.62`` and was compiled with
``-march=native``, so on another host it may fail to load or, worse, load
and die of an illegal instruction at its first call. This binding therefore

* never builds it (the JAX binding runs ``make -C csrc``, which writes into
  the JAX package's tree);
* loads it in this process only after a probe in a child process has loaded
  it *and* decoded a small JPEG to the pixels PIL decodes; ``available()``
  is True only then, and ``unavailable_reason()`` says why it is not.

Nothing on the training path calls it; a caller falls back to
``data/image.py`` (PIL) when ``available()`` is False, as the JAX binding's
callers fall back to cv2. The decode functions raise when it is
unavailable, as the JAX binding's do.
"""

from __future__ import annotations

import ctypes
import functools
import os
import signal
import subprocess
import sys
from typing import Optional, Sequence, Tuple

import numpy as np

LIB_PATH = os.path.abspath(
    os.path.join(os.path.dirname(__file__), "..", "..", "csrc", "libtdrn_io.so"))

# Run as `python -c _PROBE <library>`: load the library, write a 16x16 JPEG
# of one color with PIL, decode it at 8x8 and read its size; exit 0 only if
# every pixel is within 2 of PIL's decode and the size is (16, 16).
_PROBE = r"""
import ctypes, os, sys, tempfile
import numpy as np
from PIL import Image
lib = ctypes.CDLL(sys.argv[1])
f32p = ctypes.POINTER(ctypes.c_float)
lib.tdrn_decode_resize.restype = ctypes.c_int
lib.tdrn_decode_resize.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, f32p]
lib.tdrn_jpeg_dims.restype = ctypes.c_int
lib.tdrn_jpeg_dims.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_int),
                               ctypes.POINTER(ctypes.c_int)]
with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "probe.jpg")
    Image.fromarray(np.full((16, 16, 3), (200, 40, 90), np.uint8)).save(path, quality=95)
    ref = np.asarray(Image.open(path).convert("RGB"), np.float32)
    out = np.zeros((8, 8, 3), np.float32)
    if lib.tdrn_decode_resize(path.encode(), out.ctypes.data_as(f32p), 8, None) != 0:
        sys.exit("tdrn_decode_resize returned an error")
    h, w = ctypes.c_int(), ctypes.c_int()
    if lib.tdrn_jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        sys.exit("tdrn_jpeg_dims returned an error")
err = float(np.abs(out - ref[0, 0]).max())
if err > 2 or (h.value, w.value) != (16, 16):
    sys.exit(f"wrong decode: max|diff| {err} from PIL's pixel, size {(h.value, w.value)}")
"""
PROBE_TIMEOUT_S = 60


def probe(lib_path: str = LIB_PATH) -> Tuple[bool, str]:
    """(True, "") if a child process loads the library and decodes right,
    else (False, the reason)."""
    if not os.path.exists(lib_path):
        return False, f"{lib_path} does not exist (the port never builds it)"
    try:
        res = subprocess.run([sys.executable, "-c", _PROBE, lib_path], capture_output=True,
                             text=True, timeout=PROBE_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        return False, f"the probe did not finish in {PROBE_TIMEOUT_S} s"
    if res.returncode == 0:
        return True, ""
    if res.returncode < 0:
        return False, f"the probe died of {signal.Signals(-res.returncode).name}"
    tail = (res.stderr.strip().splitlines() or ["no output"])[-1]
    return False, f"the probe exited {res.returncode}: {tail}"


@functools.lru_cache(maxsize=None)
def _load(lib_path: str) -> Tuple[Optional[ctypes.CDLL], str]:
    ok, reason = probe(lib_path)
    if not ok:
        return None, reason
    lib = ctypes.CDLL(lib_path)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.tdrn_decode_resize.restype = ctypes.c_int
    lib.tdrn_decode_resize.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int, f32p]
    lib.tdrn_decode_resize_batch.restype = ctypes.c_int
    lib.tdrn_decode_resize_batch.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int,
        f32p,
        ctypes.c_int,
        f32p,
        ctypes.c_int,
    ]
    lib.tdrn_jpeg_dims.restype = ctypes.c_int
    lib.tdrn_jpeg_dims.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib, ""


def available(lib_path: str = LIB_PATH) -> bool:
    return _load(lib_path)[0] is not None


def unavailable_reason(lib_path: str = LIB_PATH) -> str:
    """Why the library is unavailable ("" when it is available)."""
    return _load(lib_path)[1]


def _lib(lib_path: str = LIB_PATH) -> ctypes.CDLL:
    lib, reason = _load(lib_path)
    if lib is None:
        raise RuntimeError(f"native tdrn_io library unavailable: {reason}")
    return lib


def _mean_ptr(mean):
    if mean is None:
        return None
    arr = np.ascontiguousarray(np.asarray(mean, np.float32))
    if arr.shape != (3,):
        raise ValueError(f"mean must hold 3 values, got shape {arr.shape}")
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), arr  # keep arr alive


def decode_resize(path: str, size: int, mean=None) -> np.ndarray:
    """Decode one JPEG -> (size, size, 3) float32 RGB (mean-subtracted if given)."""
    lib = _lib()
    out = np.empty((size, size, 3), np.float32)
    mp = _mean_ptr(mean)
    rc = lib.tdrn_decode_resize(
        path.encode(), out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), size,
        mp[0] if mp else None,
    )
    if rc != 0:
        raise IOError(f"native decode failed for {path}")
    return out


def decode_resize_batch(
    paths: Sequence[str], size: int, mean=None, num_threads: int = 8
) -> np.ndarray:
    """Decode a batch of JPEGs in the native thread pool -> (N, size, size, 3)."""
    lib = _lib()
    n = len(paths)
    encoded = [p.encode() + b"\0" for p in paths]
    offsets = np.zeros(n, np.int64)
    offsets[1:] = np.cumsum([len(e) for e in encoded])[:-1]
    blob = b"".join(encoded)
    out = np.empty((n, size, size, 3), np.float32)
    mp = _mean_ptr(mean)
    failures = lib.tdrn_decode_resize_batch(
        blob,
        offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        size,
        mp[0] if mp else None,
        num_threads,
    )
    if failures:
        raise IOError(f"native batch decode: {failures}/{n} failures")
    return out


def jpeg_dims(path: str) -> Tuple[int, int]:
    lib = _lib()
    h = ctypes.c_int()
    w = ctypes.c_int()
    if lib.tdrn_jpeg_dims(path.encode(), ctypes.byref(h), ctypes.byref(w)) != 0:
        raise IOError(f"cannot read {path}")
    return h.value, w.value
