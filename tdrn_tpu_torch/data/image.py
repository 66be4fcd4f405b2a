"""Host image I/O without OpenCV: the port's counterparts of the ``cv2`` calls
the JAX package's CLIs make.

* :func:`resize` reproduces ``cv2.resize(img, (w, h))`` (INTER_LINEAR on
  uint8) in integer arithmetic, as OpenCV computes it: 11-bit coefficients,
  a horizontal pass in int32 and the vertical pass of its vectorized path,
  in numpy.
  An exact 2x downscale on both axes is OpenCV's 2x2 area mean, which this
  arithmetic gives as well.
* :func:`decode` / :func:`imread` decode an encoded image (JPEG, PNG, ...)
  to RGB uint8 through PIL, with the EXIF orientation applied as
  ``cv2.imread``/``cv2.imdecode`` apply it; :func:`encode` / :func:`imwrite`
  write one. ``cv2.imread`` + ``cvtColor(BGR2RGB)`` and ``cv2.imdecode`` are
  their references.
"""

from __future__ import annotations

import functools
import io
import os
from typing import Optional, Tuple, Union

import numpy as np

_COEF_BITS = 11
_COEF_SCALE = 1 << _COEF_BITS  # OpenCV's INTER_RESIZE_COEF_SCALE


@functools.lru_cache(maxsize=64)
def _taps(src: int, dst: int, edge_weight: bool, channels: int = 1):
    """The two source indices and the two 11-bit weights (int32) of each
    output position along one axis, the indices clamped into [0, src) and,
    for ``channels`` > 1, expanded over an axis of interleaved channels.
    ``edge_weight``: a position past either border takes the edge pixel at
    weight 0, as OpenCV does along x; along y it keeps the position's
    weights and fetches the clamped rows."""
    scale = np.float64(src) / np.float64(dst)
    f = ((np.arange(dst, dtype=np.float64) + 0.5) * scale - 0.5).astype(np.float32)
    i0 = np.floor(f).astype(np.int64)
    f = (f - i0.astype(np.float32)).astype(np.float32)
    if edge_weight:
        f[(i0 < 0) | (i0 >= src - 1)] = 0.0
    # saturate_cast<short>(float) rounds half to even, as np.rint does.
    scale11 = np.float32(_COEF_SCALE)
    w = [np.rint(v * scale11).astype(np.int32) for v in (np.float32(1.0) - f, f)]
    idx = [np.clip(i, 0, src - 1) for i in (i0, i0 + 1)]
    if channels > 1:
        idx = [(i[:, None] * channels + np.arange(channels)).ravel() for i in idx]
        w = [np.repeat(v, channels) for v in w]
    for v in idx + w:
        v.setflags(write=False)  # shared by every caller through the cache
    return tuple(idx + w)


def resize(img: np.ndarray, size: Union[int, Tuple[int, int]]) -> np.ndarray:
    """Bilinear resize of an (H, W) or (H, W, C) uint8 image to ``size``
    (an int for size x size, or (width, height) as cv2 takes it); equal to
    ``cv2.resize(img, size)`` with INTER_LINEAR. numpy on the calling
    thread (its loops release the GIL), so concurrent callers run in
    parallel."""
    if img.dtype != np.uint8 or img.ndim not in (2, 3):
        raise ValueError(f"resize takes an (H, W[, C]) uint8 image, got {img.dtype} {img.shape}")
    dw, dh = (size, size) if isinstance(size, (int, np.integer)) else size
    h, w = img.shape[:2]
    if (h, w) == (dh, dw):
        return img.copy()
    c = img.shape[2] if img.ndim == 3 else 1
    x0, x1, a0, a1 = _taps(w, dw, True, c)
    y0, y1, b0, b1 = _taps(h, dh, False)
    flat = np.ascontiguousarray(img).reshape(h, w * c)
    # Horizontal pass: int32 sums of the 11-bit weights (at most 255 * 2048).
    hor = np.take(flat, x0, axis=1).astype(np.int32)
    hor *= a0
    right = np.take(flat, x1, axis=1).astype(np.int32)
    right *= a1
    hor += right
    # Vertical pass as OpenCV's SIMD path computes it (16-bit high products);
    # the result is within [0, 255] by construction.
    hor >>= 4
    top = np.take(hor, y0, axis=0)
    top *= b0[:, None]
    top >>= 16
    bottom = np.take(hor, y1, axis=0)
    bottom *= b1[:, None]
    bottom >>= 16
    top += bottom
    top += 2
    top >>= 2
    return top.astype(np.uint8).reshape((dh, dw) + img.shape[2:])


def _pil():
    try:
        from PIL import Image, ImageOps
    except ImportError as e:  # pragma: no cover - both machines have PIL
        raise RuntimeError(
            "no image decoder: tdrn_tpu_torch decodes and encodes images with "
            "PIL (Pillow), which is not installed"
        ) from e
    return Image, ImageOps


def decode(data: bytes) -> Optional[np.ndarray]:
    """Encoded image bytes -> (H, W, 3) uint8 RGB, or None if they do not
    decode (``cv2.imdecode`` returns None there)."""
    Image, ImageOps = _pil()
    try:
        with Image.open(io.BytesIO(data)) as im:
            im = ImageOps.exif_transpose(im)
            return np.array(im.convert("RGB"))
    except (OSError, ValueError, Image.DecompressionBombError):
        return None


def imread(path: str) -> np.ndarray:
    """An image file -> (H, W, 3) uint8 RGB; raises if it does not decode."""
    with open(path, "rb") as f:
        img = decode(f.read())
    if img is None:
        raise ValueError(f"cannot decode image {path}")
    return img


_FORMATS = {".jpg": "JPEG", ".jpeg": "JPEG", ".png": "PNG"}


def encode(img: np.ndarray, ext: str = ".jpg", quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> encoded bytes (JPEG at ``quality``, or PNG)."""
    Image, _ = _pil()
    fmt = _FORMATS.get(ext.lower())
    if fmt is None:
        raise ValueError(f"unsupported image format {ext!r} (have {sorted(_FORMATS)})")
    buf = io.BytesIO()
    kw = {"quality": int(quality)} if fmt == "JPEG" else {}
    Image.fromarray(np.ascontiguousarray(img, np.uint8)).save(buf, format=fmt, **kw)
    return buf.getvalue()


def imwrite(path: str, img: np.ndarray, quality: int = 95) -> None:
    """Write (H, W, 3) uint8 RGB to ``path``; the format follows its extension."""
    data = encode(img, os.path.splitext(path)[1], quality)
    with open(path, "wb") as f:
        f.write(data)
