"""Port parity for the file-media formats (yuv422p10le, yuv420p, nv12,
rgba8, bgra8) and the planar kernels' plain versions (B10's 10-bit mode,
B11, B12, B13 in ops/kernels.py) against phaneron_tpu on the CPU: its
format modules, its XLA to_rgba / from_rgba and its Pallas kernels
(interpret mode).  The CUDA kernels are held to these plain versions on
the card by chip_smoke.py.

Contracts: host buffers and codes bit for bit; unpacks within one LUT
step (TOL_UNPACK: XLA contracts the colour matrix into FMAs, and the
Pallas kernels split codes into bf16 hi/lo parts, exact for 10-bit
codes, so random 10-bit planes stay in [0, 1023]); packs equal on the
ramps, pitch pad included, and within 1 code on random RGBA."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import coeffs as jcoeffs
from phaneron_tpu.ops import io as jio
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.pallas_kernels import (
    make_planar420_pack_rgba,
    make_planar420_unpack_rgba,
    make_planar422_pack_rgba,
    make_planar422_unpack_rgba,
)
from phaneron_tpu_torch.graph.convert import params_from_numpy
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import coeffs as tcoeffs
from phaneron_tpu_torch.ops import io as tio
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops.formats import get_format as tget_format

torch.set_num_threads(1)

TOL_UNPACK = 3.1e-5  # one LUT step at the top of the BT.709 curve
H = 16
WIDTHS = [256, 100, 101]  # 100: a pitch pad; 101: an odd width as well
FORMATS = ["yuv422p10le", "yuv420p", "nv12", "rgba8", "bgra8"]


def _heights(name):
    """4:2:0 formats also at an odd height ((H+1)/2 chroma rows)."""
    return (H, H - 1) if jget_format(name).INFO.sub_y == 2 else (H,)


def _random_planes(name, width, height, rng):
    hi = 1024 if name == "yuv422p10le" else 256
    return [rng.integers(0, hi, size=s, dtype=dt) for s, dt in jget_format(name).plane_shapes(width, height)]


def _t(planes):
    return [torch.from_numpy(np.array(p, copy=True)) for p in planes]


def _np(planes):
    return [p.numpy() for p in planes]


def _equal(got, want):
    return len(got) == len(want) and all(
        a.dtype == np.asarray(b).dtype and a.shape == np.asarray(b).shape and np.array_equal(a, np.asarray(b))
        for a, b in zip(got, want)
    )


def _code_delta(got, want) -> int:
    return max(int(np.abs(a.astype(np.int64) - np.asarray(b).astype(np.int64)).max()) for a, b in zip(got, want))


# ------------------------------------------------------------ formats


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("width", WIDTHS)
def test_host_buffers_equal(name, width):
    """plane_shapes, num_bytes, from_bytes, black_buf and fill_buf equal
    JAX's to the byte."""
    jf, tf = jget_format(name), tget_format(name)
    assert vars(tf.INFO) == vars(jf.INFO)
    rng = np.random.default_rng(width)
    for h in _heights(name):
        assert tf.plane_shapes(width, h) == jf.plane_shapes(width, h)
        assert tf.num_bytes(width, h) == jf.num_bytes(width, h)
        assert tf.pitch_bytes(width) == jf.pitch_bytes(width)
        for fn in ("black_buf", "fill_buf"):
            assert _equal(getattr(tf, fn)(width, h), getattr(jf, fn)(width, h)), (fn, h)
        data = b"".join(p.tobytes() for p in _random_planes(name, width, h, rng))
        assert _equal(tf.from_bytes(data, width, h), jf.from_bytes(data, width, h))


@pytest.mark.parametrize("name", FORMATS)
@pytest.mark.parametrize("width", WIDTHS)
def test_codes_equal(name, width):
    """unpack_codes / pack_codes (unpack_rgba_codes / pack_rgba_codes for
    RGB) equal JAX's bit for bit on the ramp and on random planes."""
    jf, tf = jget_format(name), tget_format(name)
    rng = np.random.default_rng(100 + width)
    for h in _heights(name):
        for planes in (jf.fill_buf(width, h), _random_planes(name, width, h, rng)):
            if jf.INFO.is_rgb:
                want = [jf.unpack_rgba_codes([jnp.asarray(p) for p in planes], width, h)]
                got = [tf.unpack_rgba_codes(_t(planes), width, h)]
            else:
                want = jf.unpack_codes([jnp.asarray(p) for p in planes], width, h)
                got = tf.unpack_codes(_t(planes), width, h)
            assert all(g.dtype == torch.int32 for g in got)
            assert _equal(_np(got), want)
        hi = 1 << jf.INFO.num_bits
        if jf.INFO.is_rgb:
            codes = rng.integers(0, 256, size=(4, h, width), dtype=np.int32)
            want = jf.pack_rgba_codes(jnp.asarray(codes), width, h)
            got = tf.pack_rgba_codes(torch.from_numpy(codes), width, h)
        else:
            codes = [rng.integers(0, hi, size=(h, width), dtype=np.int32) for _ in range(3)]
            want = jf.pack_codes(*[jnp.asarray(c) for c in codes], width, h)
            got = tf.pack_codes(*[torch.from_numpy(c) for c in codes], width, h)
        assert _equal(_np(got), want)


def test_params_from_numpy_carries_file_media_planes():
    """uint16 10-bit planes and (H, W, 4) uint8 pixels cross unchanged."""
    rng = np.random.default_rng(3)
    p10 = _random_planes("yuv422p10le", 100, H, rng)
    px = _random_planes("rgba8", 100, H, rng)
    port = params_from_numpy({"layers": [{"src": p10}, {"src": px, "mix": 0.5}]}, "cpu")
    assert [t.dtype for t in port["layers"][0]["src"]] == [torch.uint16] * 3
    assert _equal(_np(port["layers"][0]["src"]), p10)
    assert port["layers"][1]["src"][0].dtype == torch.uint8
    assert _equal(_np(port["layers"][1]["src"]), px)


# ---------------------------------------------- unpacks (B10, B12)


@pytest.mark.parametrize("width", [256, 720])
def test_planar422_unpack_10bit_matches_kernel(width):
    """B10's 10-bit mode: the spatial kernel at 256, the phase kernel at 720."""
    fmt = jget_format("yuv422p10le")
    rng = np.random.default_rng(width)
    jfn = make_planar422_unpack_rgba("yuv422p10le", width, H, interpret=True)
    for planes in (fmt.fill_buf(width, H), _random_planes("yuv422p10le", width, H, rng)):
        want = np.asarray(jfn([jnp.asarray(p) for p in planes]))
        got = K.planar422_unpack(_t(planes), width, H, fmt_name="yuv422p10le")
        assert got.dtype == torch.float32 and tuple(got.shape) == (4, H, width)
        assert np.abs(got.numpy() - want).max() <= TOL_UNPACK


@pytest.mark.parametrize("name", ["yuv420p", "nv12"])
@pytest.mark.parametrize("width", [256, 100])
def test_planar420_unpack_matches_kernel(name, width):
    """B12: the spatial kernel at 256 (its one-hot product de-interleaves
    nv12), the phase kernel at 100."""
    fmt = jget_format(name)
    rng = np.random.default_rng(width + 7)
    jfn = make_planar420_unpack_rgba(name, width, H, interpret=True)
    for planes in (fmt.fill_buf(width, H), _random_planes(name, width, H, rng)):
        want = np.asarray(jfn([jnp.asarray(p) for p in planes]))
        got = K.planar420_unpack(_t(planes), width, H, fmt_name=name)
        assert tuple(got.shape) == (4, H, width)
        assert np.abs(got.numpy() - want).max() <= TOL_UNPACK


# -------------------------------------------------- packs (B11, B13)


def _pack_cases(name, width, h, rng):
    """(rgba, tolerance): the decoded ramp (exact, pad columns included)
    and random RGBA in [-0.05, 1.05] (within 1 code)."""
    ramp = tio.to_rgba(
        tget_format(name), _t(jget_format(name).fill_buf(width, h)),
        K.format_loader(name, "709", "709", torch.device("cpu")), width, h,
    )
    rand = torch.from_numpy(rng.uniform(-0.05, 1.05, (4, h, width)).astype(np.float32))
    return [(ramp, 0), (rand, 1)]


@pytest.mark.parametrize("name", ["yuv422p10le", "yuv422p8"])
@pytest.mark.parametrize("width", [256, 100])
def test_planar422_pack_matches_kernel(name, width):
    """B11 at 10 and 8 bit against make_planar422_pack_rgba, with 3 and 4
    channels in."""
    rng = np.random.default_rng(width + 11)
    jfn = make_planar422_pack_rgba(name, width, H, interpret=True)
    for rgba, tol in _pack_cases(name, width, H, rng):
        want = [np.asarray(p) for p in jfn(jnp.asarray(rgba.numpy()))]
        for c in (4, 3):
            got = _np(K.planar422_pack(rgba[:c].contiguous(), name))
            assert [g.dtype for g in got] == [w.dtype for w in want]
            assert _code_delta(got, want) <= tol
        if tol == 0:
            assert _equal(got, jget_format(name).fill_buf(width, H))


@pytest.mark.parametrize("name", ["yuv420p", "nv12"])
@pytest.mark.parametrize("width", [256, 100])
def test_planar420_pack_matches_kernel(name, width):
    """B13 against make_planar420_pack_rgba (chroma from the even pixels
    of even lines; nv12 interleaves Cb and Cr)."""
    rng = np.random.default_rng(width + 13)
    jfn = make_planar420_pack_rgba(name, width, H, interpret=True)
    for rgba, tol in _pack_cases(name, width, H, rng):
        want = [np.asarray(p) for p in jfn(jnp.asarray(rgba.numpy()))]
        got = _np(K.planar420_pack(rgba, name))
        assert [g.shape for g in got] == [w.shape for w in want]
        assert _code_delta(got, want) <= tol
        if tol == 0:
            assert _equal(got, jget_format(name).fill_buf(width, H))


@pytest.mark.parametrize("name", ["yuv420p", "nv12"])
@pytest.mark.parametrize("width", [100, 101])
def test_planar420_odd_height_matches_xla(name, width):
    """An odd height, where the Pallas 4:2:0 kernels assert: B12 and B13's
    plain versions against JAX's XLA to_rgba / from_rgba; the ramp round
    trips to the byte."""
    h = H - 1
    jf, tf = jget_format(name), tget_format(name)
    rng = np.random.default_rng(width + 17)
    jl = jcoeffs.make_loader(jf.INFO, "709", "709")
    js = jcoeffs.make_saver(jf.INFO, "709")
    for planes in (jf.fill_buf(width, h), _random_planes(name, width, h, rng)):
        want = np.asarray(jio.to_rgba(jf, [jnp.asarray(p) for p in planes], jl, width, h))
        got = K.planar420_unpack(_t(planes), width, h, fmt_name=name)
        assert np.abs(got.numpy() - want).max() <= TOL_UNPACK
        packed = _np(K.planar420_pack(got, name))
        assert _code_delta(packed, jio.from_rgba(jf, jnp.asarray(got.numpy()), js, width, h)) <= 1
    rt = _np(K.planar420_pack(K.planar420_unpack(_t(jf.fill_buf(width, h)), width, h, fmt_name=name), name))
    assert _equal(rt, tf.fill_buf(width, h))


# ------------------------------------------------------- RGB formats


@pytest.mark.parametrize("name", ["rgba8", "bgra8"])
@pytest.mark.parametrize("col_spec", ["709", "sRGB"])
def test_rgb_formats_match_jax(name, col_spec):
    """to_rgba within one LUT step of JAX (alpha through the transfer
    function too), from_rgba equal to JAX's (alpha written as 255), and
    the 8-bit round trip exact."""
    width = 100
    jf, tf = jget_format(name), tget_format(name)
    rng = np.random.default_rng(len(name) + len(col_spec))
    jl = jcoeffs.make_loader(jf.INFO, col_spec, col_spec)
    js = jcoeffs.make_saver(jf.INFO, col_spec)
    tl = tcoeffs.make_loader(tf.INFO, col_spec, col_spec)
    ts = tcoeffs.make_saver(tf.INFO, col_spec)
    planes = _random_planes(name, width, H, rng)
    want = np.asarray(jio.to_rgba(jf, [jnp.asarray(p) for p in planes], jl, width, H))
    got = tio.to_rgba(tf, _t(planes), tl, width, H)
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, H, width)
    assert np.abs(got.numpy() - want).max() <= TOL_UNPACK
    rgba = rng.uniform(-0.05, 1.05, (4, H, width)).astype(np.float32)
    assert _equal(_np(tio.from_rgba(tf, torch.from_numpy(rgba), ts, width, H)),
                  jio.from_rgba(jf, jnp.asarray(rgba), js, width, H))
    back = _np(tio.from_rgba(tf, got, ts, width, H))[0]
    rgb_bytes = list(tf.CHANNEL_ORDER[:3])
    assert np.array_equal(back[..., rgb_bytes], planes[0][..., rgb_bytes])
    assert (back[..., tf.CHANNEL_ORDER[3]] == 255).all()


# ----------------------------------------------------------- wrappers


def test_cpu_wrappers_run_plain_versions_and_refuse_other_formats():
    w, h = 100, 15
    rng = np.random.default_rng(5)
    counters = (K.planar422_unpack, K.planar422_pack, K.planar420_unpack, K.planar420_pack)
    before = [fn.launches for fn in counters]
    p10 = _t(_random_planes("yuv422p10le", w, h, rng))
    rgba = K.planar422_unpack(p10, w, h, fmt_name="yuv422p10le")
    assert torch.equal(rgba, K.planar422_unpack_plain(p10, w, h, fmt_name="yuv422p10le"))
    for name in ("yuv422p10le", "yuv422p8"):
        assert all(torch.equal(a, b) for a, b in zip(K.planar422_pack(rgba, name), K.planar422_pack_plain(rgba, name)))
    for name in ("yuv420p", "nv12"):
        planes = _t(_random_planes(name, w, h, rng))
        assert torch.equal(K.planar420_unpack(planes, w, h, fmt_name=name),
                           K.planar420_unpack_plain(planes, w, h, fmt_name=name))
        assert all(torch.equal(a, b) for a, b in zip(K.planar420_pack(rgba, name), K.planar420_pack_plain(rgba, name)))
    assert [fn.launches for fn in counters] == before
    assert _build._load.cache_info().currsize == 0
    with pytest.raises(ValueError, match="not one of"):
        K.planar422_pack(rgba, "nv12")
    with pytest.raises(ValueError, match="not one of"):
        K.planar420_unpack(p10, w, h, fmt_name="yuv422p10le")
    with pytest.raises(ValueError, match="expected"):
        K.planar420_pack(rgba[:2], "nv12")
    with pytest.raises(ValueError, match="no kernel for device"):
        K.planar422_pack(torch.empty((4, h, w), device="meta"), "yuv422p10le")
