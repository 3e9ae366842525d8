"""Port parity: the v210 and yuv422p8 formats and the to_rgba / from_rgba
stages of phaneron_tpu_torch against phaneron_tpu on the CPU (the
file-media formats: tests/test_torch_planar.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import coeffs as jcoeffs
from phaneron_tpu.ops import io as jio
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu_torch.ops import coeffs as tcoeffs
from phaneron_tpu_torch.ops import io as tio
from phaneron_tpu_torch.ops.formats import get_format as tget_format
from torch_parity import random_words

torch.set_num_threads(1)

WIDTHS = [96, 100, 256, 1280]  # 100 and 1280 carry a v210 pitch pad
H = 16


def _t(a):
    """numpy plane -> port tensor (uint32 words as int32 bit-views)."""
    a = np.asarray(a)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a.copy())


def _np(t, like):
    a = t.numpy()
    return a.view(np.uint32) if like.dtype == np.uint32 else a


def _random_planes(name, width, rng):
    if name == "v210":
        return [random_words(rng, width, H)]
    fmt = jget_format(name)
    return [rng.integers(0, 256, size=s, dtype=np.uint8) for s, _ in fmt.plane_shapes(width, H)]


@pytest.mark.parametrize("name", ["v210", "yuv422p8"])
@pytest.mark.parametrize("width", WIDTHS)
def test_fill_and_black_bufs_equal(name, width):
    jf, tf = jget_format(name), tget_format(name)
    for jb, tb in ((jf.fill_buf, tf.fill_buf), (jf.black_buf, tf.black_buf)):
        for a, b in zip(jb(width, H), tb(width, H)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)
    assert tf.plane_shapes(width, H) == jf.plane_shapes(width, H)


@pytest.mark.parametrize("name", ["v210", "yuv422p8"])
@pytest.mark.parametrize("width", WIDTHS)
def test_unpack_codes_equal(name, width):
    jf, tf = jget_format(name), tget_format(name)
    rng = np.random.default_rng(width)
    for planes in (jf.fill_buf(width, H), _random_planes(name, width, rng)):
        want = jf.unpack_codes([jnp.asarray(p) for p in planes], width, H)
        got = tf.unpack_codes([_t(p) for p in planes], width, H)
        for a, b in zip(got, want):
            assert a.dtype == torch.int32
            assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("name", ["v210", "yuv422p8"])
@pytest.mark.parametrize("width", WIDTHS)
def test_pack_codes_equal(name, width):
    """Random codes over the format's range (and past it, for v210's
    10-bit field mask) pack to the same planes."""
    jf, tf = jget_format(name), tget_format(name)
    rng = np.random.default_rng(1000 + width)
    hi = 2048 if name == "v210" else 256
    codes = [rng.integers(0, hi, size=(H, width), dtype=np.int32) for _ in range(3)]
    want = jf.pack_codes(*[jnp.asarray(c) for c in codes], width, H)
    got = tf.pack_codes(*[torch.from_numpy(c) for c in codes], width, H)
    for a, b in zip(got, want):
        b = np.asarray(b)
        assert np.array_equal(_np(a, b), b)


@pytest.mark.parametrize("mode", ["analytic", "lut"])
@pytest.mark.parametrize("name", ["v210", "yuv422p8"])
@pytest.mark.parametrize("width", WIDTHS)
def test_rgba_roundtrip_bit_exact_and_matches_jax(name, width, mode):
    """from_rgba(to_rgba(fill_buf)) == fill_buf to the byte; the linear
    RGBA agrees with JAX's to_rgba within one LUT step (torch's float32
    pow is within 1 ulp of XLA's, tests/test_torch_colour.py)."""
    jf, tf = jget_format(name), tget_format(name)
    src = tf.fill_buf(width, H)
    tl = tcoeffs.make_loader(tf.INFO, "709", "709", mode)
    ts = tcoeffs.make_saver(tf.INFO, "709", mode)
    rgba = tio.to_rgba(tf, [_t(p) for p in src], tl, width, H)
    out = tio.from_rgba(tf, rgba, ts, width, H)
    for a, b in zip(src, out):
        assert _np(b, a).tobytes() == a.tobytes()
    jl = jcoeffs.make_loader(jf.INFO, "709", "709", mode)
    want = np.asarray(jio.to_rgba(jf, [jnp.asarray(p) for p in src], jl, width, H))
    assert rgba.shape == want.shape
    assert np.abs(rgba.numpy() - want).max() <= 4e-5


def test_unknown_format_raises_keyerror():
    with pytest.raises(KeyError):
        tget_format("yuv444p12le")
    assert tget_format("yuv422p") is tget_format("yuv422p8")
