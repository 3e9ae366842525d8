"""Port parity for the media channel and the stage programs of every
format against phaneron_tpu on the CPU, at 256x16.

The media channel (chip_smoke.py's media path, cut in size): a
yuv422p10le clip as a cut (the FFmpeg producer's ProRes background), a
yuv420p clip under an axis-aligned DVE (scale 0.5, offset (0.2, -0.15):
a picture in picture) dissolving to an nv12 clip under the same matrix,
and a keyed rgba8 graphic on top (an image-sequence lower third: alpha
255 in a band, 128 on its edge rows, 0 elsewhere); yuv422p10le out with
``emit_rgba``, whose frame feeds an sRGB rgba8 preview pack and an nv12
file pack.  The port (K3 10-bit, B12 twice, K4 pair, torch rgba8 decode
and combine, B11; then B13 and the rgba8 pack) is held against JAX's
``make_channel_program`` on its XLA path and on its Pallas path
(``pallas_stages`` with ``warp_bucket`` set: the Pallas planar unpacks,
warp pair and planar pack, in interpret mode).

Contracts: packed codes within 1; the rgba frame within 2e-4 and its
alpha the top layer's; unpack stage programs within one LUT step."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import kernels as K
from torch_parity import max_code_delta, random_words

torch.set_num_threads(1)

W, H = 256, 16
TOL_UNPACK = 3.1e-5
TOL_RGBA = 2e-4
MAT = transform_matrix(W, H, scale_x=0.5, scale_y=0.5, offset_x=0.2, offset_y=-0.15)
FORMATS = ["v210", "yuv422p10le", "yuv422p8", "yuv420p", "nv12", "rgba8", "bgra8"]


def _graphic(w, h):
    """(H, W, 4) rgba8 lower third, premultiplied: alpha 255 in a band of
    rows, 128 on the rows at its edges, 0 elsewhere; red ramps across."""
    alpha = np.zeros(h, np.float64)
    top, bottom = int(0.7 * h), int(0.85 * h)
    alpha[top:bottom] = 255.0
    alpha[[top - 1, bottom]] = 128.0
    colour = np.stack(np.broadcast_arrays(np.linspace(20, 235, w)[None, :], 160.0, 60.0), -1)
    px = np.zeros((h, w, 4), np.uint8)
    px[..., :3] = np.round(colour * alpha[:, None, None] / 255.0)
    px[..., 3] = alpha[:, None]
    return px


def _random_planes(name, w, h, rng):
    if name == "v210":
        return [random_words(rng, w, h)]
    hi = 1024 if name == "yuv422p10le" else 256
    return [rng.integers(0, hi, size=s, dtype=dt) for s, dt in jget_format(name).plane_shapes(w, h)]


def _spec(pallas: bool):
    return jpipe.ChannelSpec(
        W, H, "yuv422p10le",
        layers=(
            jpipe.LayerSpec("yuv422p10le"),
            jpipe.LayerSpec("yuv420p", transition="dissolve", has_transform=True, axis_aligned=True,
                            src_b_format="nv12", warp_bucket=bucket_of(MAT) if pallas else -1),
            jpipe.LayerSpec("rgba8"),
        ),
        emit_rgba=True, pallas_stages=pallas,
    )


def _params(mix: float):
    rng = np.random.default_rng(0)
    return {"layers": [
        {"src": _random_planes("yuv422p10le", W, H, rng)},
        {"src": jget_format("yuv420p").fill_buf(W, H), "src_b": _random_planes("nv12", W, H, rng),
         "matrix": MAT, "mix": np.float32(mix)},
        {"src": [_graphic(W, H)]},
    ]}


def _jax(params):
    return {"layers": [
        {k: ([jnp.asarray(p) for p in v] if isinstance(v, list) else jnp.asarray(v)) for k, v in lp.items()}
        for lp in params["layers"]
    ]}


def _code_delta(got, want) -> int:
    return max(
        int(np.abs(g.numpy().astype(np.int64) - np.asarray(w).astype(np.int64)).max())
        for g, w in zip(got, want)
    )


def _port_frame(params, plain=False):
    spec = spec_from_fields(_spec(False)._asdict())
    return tpipe.make_channel_program(spec, plain=plain)(params_from_numpy(params, "cpu"))


@pytest.mark.parametrize("mix", [0.35, 1.0])
@pytest.mark.parametrize("pallas", [False, True])
def test_media_channel_matches_jax(pallas, mix):
    """The frame, packed yuv422p10le within 1 code of both JAX paths, the
    rgba frame within 2e-4 with the graphic's alpha, and the two consumer
    packs of that frame within 1 code of JAX's stage programs."""
    params = _params(mix)
    out = _port_frame(params)
    want = jpipe.make_channel_program(_spec(pallas))(_jax(params))
    assert [p.dtype for p in out["packed"]] == [torch.uint16] * 3
    assert [tuple(p.shape) for p in out["packed"]] == [np.asarray(p).shape for p in want["packed"]]
    assert _code_delta(out["packed"], want["packed"]) <= 1
    rgba = out["rgba"].numpy()
    assert rgba.shape == (4, H, W) and np.isfinite(rgba).all()
    assert np.abs(rgba - np.asarray(want["rgba"])).max() <= TOL_RGBA
    top = tpipe.make_unpack_program("rgba8", W, H, "709", "709")(params_from_numpy(params, "cpu")["layers"][2]["src"])
    assert np.array_equal(rgba[3], top[3].numpy())
    for fmt, col in (("rgba8", "sRGB"), ("nv12", "709")):
        got = tpipe.make_pack_program(fmt, W, H, col)(out["rgba"])
        ref = jpipe.make_pack_program(fmt, W, H, col)(jnp.asarray(rgba))
        assert _code_delta(got, ref) <= 1


def test_media_channel_plain_program_equals_wrappers_on_cpu():
    """On CPU tensors the kernel wrappers are the plain versions and launch
    nothing: the channel program equals its plain=True form."""
    counters = (K.planar422_unpack, K.planar420_unpack, K.planar422_pack)
    before = [fn.launches for fn in counters]
    params = _params(0.6)
    a, b = _port_frame(params), _port_frame(params, plain=True)
    assert all(torch.equal(x, y) for x, y in zip(a["packed"], b["packed"]))
    assert torch.equal(a["rgba"], b["rgba"])
    assert [fn.launches for fn in counters] == before
    # the dissolve pair runs under one DVE matrix; no packed composite run
    spec = spec_from_fields(_spec(False)._asdict())
    assert tpipe._packed_composite_run(spec, params_from_numpy(params, "cpu")) is None
    assert tpipe.missing_kernel(spec) is None


@pytest.mark.parametrize("channels", [4, 3])
@pytest.mark.parametrize("fmt", FORMATS)
def test_unpack_stage_program_matches_jax(fmt, channels):
    rng = np.random.default_rng(len(fmt) + channels)
    planes = _random_planes(fmt, W, H, rng)
    want = np.asarray(jpipe.make_unpack_program(fmt, W, H, "709", "709", channels=channels)(
        [jnp.asarray(p) for p in planes]))
    port = params_from_numpy({"layers": [{"src": planes}]}, "cpu")["layers"][0]["src"]
    got = tpipe.make_unpack_program(fmt, W, H, "709", "709", channels=channels)(port)
    plain = tpipe.make_unpack_program(fmt, W, H, "709", "709", channels=channels, plain=True)(port)
    assert tuple(got.shape) == (channels, H, W) and torch.equal(got, plain)
    assert np.abs(got.numpy() - want).max() <= TOL_UNPACK


@pytest.mark.parametrize("fmt", FORMATS)
def test_pack_stage_program_matches_jax(fmt):
    rng = np.random.default_rng(len(fmt))
    rgba = rng.uniform(-0.05, 1.05, (4, H, W)).astype(np.float32)
    want = jpipe.make_pack_program(fmt, W, H, "709")(jnp.asarray(rgba))
    got = tpipe.make_pack_program(fmt, W, H, "709")(torch.from_numpy(rgba))
    plain = tpipe.make_pack_program(fmt, W, H, "709", plain=True)(torch.from_numpy(rgba))
    assert all(torch.equal(a, b) for a, b in zip(got, plain))
    if fmt == "v210":
        assert max_code_delta(words_to_numpy(got[0]), np.asarray(want[0]), W, H) <= 1
    else:
        assert [g.numpy().dtype for g in got] == [np.asarray(w).dtype for w in want]
        assert _code_delta(got, want) <= 1


def test_interlaced_pack_programs_match_jax():
    """4:2:0 interlaced output through B13 (chroma from the top field's
    lines), and the packed-domain field select of yuv422p10le equal to
    the interleave-then-pack it replaces."""
    rng = np.random.default_rng(9)
    top, bottom = (rng.uniform(0.0, 1.0, (4, H, W)).astype(np.float32) for _ in range(2))
    tt, tb = torch.from_numpy(top), torch.from_numpy(bottom)
    want = jpipe.make_interlaced_pack_program("yuv420p", W, H, "709")(jnp.asarray(top), jnp.asarray(bottom))
    got = tpipe.make_interlaced_pack_program("yuv420p", W, H, "709")(tt, tb)
    assert _code_delta(got, want) <= 1
    pack = tpipe.make_pack_program("yuv422p10le", W, H, "709")
    word = tpipe.make_interlaced_word_pack_program("yuv422p10le")(pack(tt), pack(tb))
    ref = tpipe.make_interlaced_pack_program("yuv422p10le", W, H, "709", plain=True)(tt, tb)
    assert all(torch.equal(a, b) for a, b in zip(word, ref))
    assert tpipe.make_interlaced_word_pack_program("nv12") is None
