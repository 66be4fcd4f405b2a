"""The port's binding of the native JPEG decoder (tdrn_tpu_torch/data/native.py
over the committed csrc/libtdrn_io.so):

  * bit-equal to the JAX package's binding (tdrn_tpu/data/native.py) on
    decode_resize with and without the mean, decode_resize_batch and
    jpeg_dims, on JPEGs like tests/test_vid_data.py's synthetic tree;
    skipped only where the JAX binding itself reports the library
    unavailable, as test_native_matches_cv2 is;
  * a library that does not load (missing, not a shared object) is
    unavailable with a reason;
  * csrc/'s listing and mtimes unchanged by every call: the port never
    builds the library.
"""

import os

import numpy as np
import pytest

from tdrn_tpu_torch.data import image
from tdrn_tpu_torch.data import native
from tests.test_torch_port_threads import one_torch_thread  # noqa: F401 (autouse)

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
MEAN = (123.0, 117.0, 104.0)


def _csrc_state():
    return sorted((f, os.stat(os.path.join(CSRC, f)).st_mtime_ns) for f in os.listdir(CSRC))


@pytest.fixture(autouse=True)
def csrc_untouched():
    before = _csrc_state()
    yield
    assert _csrc_state() == before


@pytest.fixture(scope="module")
def jpegs(tmp_path_factory):
    """Random 120x160 and 75x100 JPEGs (quality 95)."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.RandomState(0)
    paths = []
    for t, (h, w) in enumerate([(120, 160)] * 3 + [(75, 100)]):
        p = str(root / f"{t:06d}.JPEG")
        image.imwrite(p, rng.randint(0, 255, (h, w, 3), np.uint8))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def jax_native():
    from tdrn_tpu.data import native as jnative

    if not jnative.available():
        pytest.skip("the JAX binding reports the native library unavailable")
    return jnative


def test_port_binding_equals_jax_binding(jax_native, jpegs):
    assert native.available() and native.unavailable_reason() == ""
    for p in jpegs:
        for mean in (None, MEAN):
            got, want = native.decode_resize(p, 64, mean), jax_native.decode_resize(p, 64, mean)
            assert got.dtype == want.dtype == np.float32 and np.array_equal(got, want)
        assert native.jpeg_dims(p) == jax_native.jpeg_dims(p)
    assert native.jpeg_dims(jpegs[-1]) == (75, 100)
    got = native.decode_resize_batch(jpegs, 32, MEAN, num_threads=2)
    want = jax_native.decode_resize_batch(jpegs, 32, MEAN, num_threads=2)
    assert got.shape == (4, 32, 32, 3) and np.array_equal(got, want)
    # Within 1.0 of PIL's decode and data/image.py's resize (OpenCV's).
    ref = image.resize(image.imread(jpegs[0]), 64).astype(np.float32)
    np.testing.assert_allclose(native.decode_resize(jpegs[0], 64), ref, atol=1.0)
    with pytest.raises(IOError):
        native.decode_resize(jpegs[0] + ".missing", 64)


def test_unloadable_library_is_unavailable_with_a_reason(tmp_path):
    missing = str(tmp_path / "libnothing.so")
    assert not native.available(missing)
    assert "does not exist" in native.unavailable_reason(missing)
    with pytest.raises(RuntimeError, match="unavailable"):
        native._lib(missing)  # what the decode functions call
    junk = tmp_path / "libjunk.so"
    junk.write_bytes(b"not a shared object")
    ok, reason = native.probe(str(junk))
    assert not ok and "exited 1" in reason and "OSError" in reason
    assert not native.available(str(junk)) and native.unavailable_reason(str(junk)) == reason
