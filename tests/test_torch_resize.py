"""Port parity for off-geometry sources (ROADMAP A3): ``resize_frame`` and
``flip_vals`` (ops/geometry.py) against phaneron_tpu's, ``transparent``
(ops/composite.py), and channel frames whose layers carry ``src_size``
(a clip at another size than the channel: unpacked at its own size,
then stretch-fit) against JAX's XLA path on the CPU.

Contracts: the resize equals JAX's to the bit (two separable passes,
every quotient an IEEE division); channel frames within 1 code, an
``emit_rgba`` frame within 2e-4 with the top layer's alpha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops import composite as jcomposite
from phaneron_tpu.ops import geometry as jgeometry
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import composite as tcomposite
from phaneron_tpu_torch.ops import geometry as tgeometry
from phaneron_tpu_torch.ops.warp import warp_plain
from torch_parity import max_code_delta, random_words

torch.set_num_threads(1)

W, H = 192, 16
TOL_RGBA = 2e-4
QUARTER = transform_matrix(W, H, scale_x=0.5, scale_y=0.5, offset_x=-0.25, offset_y=0.25)


@pytest.mark.parametrize("flip", [(False, False), (True, False), (False, True), (True, True)])
def test_flip_vals_equals_jax(flip):
    got = tgeometry.flip_vals(*flip)
    want = jgeometry.flip_vals(*flip)
    assert got.dtype == want.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("out_hw", [(40, 64), (5, 7), (9, 13), (720, 1280)])
@pytest.mark.parametrize("kw", [
    dict(),
    dict(scale=1.3, offset_x=0.1, offset_y=-0.05),
    dict(scale=0.7, flip=(True, False)),
    dict(flip=(True, True), offset_x=-0.2),
])
def test_resize_frame_bit_exact_against_jax(out_hw, kw):
    """Up- and down-scales (9x13 -> 40x64, 5x7, itself, 720x1280), scale,
    offsets and flips: resize_frame equals JAX's to the bit."""
    rng = np.random.default_rng(sum(out_hw))
    src = rng.uniform(-0.1, 1.1, (4, 9, 13)).astype(np.float32)
    kj, kt = dict(kw), dict(kw)
    if "flip" in kw:
        kj["flip"] = jnp.asarray(jgeometry.flip_vals(*kw["flip"]))
        kt["flip"] = tgeometry.flip_vals(*kw["flip"])
    want = np.asarray(jgeometry.resize_frame(jnp.asarray(src), *out_hw, **kj))
    got = tgeometry.resize_frame(torch.from_numpy(src), *out_hw, **kt)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert got.numpy().tobytes() == want.tobytes()


def test_resize_frame_takes_tensor_arguments_and_three_channels():
    src = torch.from_numpy(np.random.default_rng(2).random((3, 6, 10), dtype=np.float32))
    a = tgeometry.resize_frame(src, 12, 20, torch.tensor(0.8), torch.tensor(0.05), torch.tensor(0.1),
                               torch.from_numpy(tgeometry.flip_vals(True, False)))
    b = np.asarray(jgeometry.resize_frame(jnp.asarray(src.numpy()), 12, 20, 0.8, 0.05, 0.1,
                                          jnp.asarray(jgeometry.flip_vals(True, False))))
    assert a.numpy().tobytes() == b.tobytes()


def test_transparent_equals_jax():
    got = tcomposite.transparent(H, W)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(jcomposite.transparent(H, W)))
    frame = torch.from_numpy(np.random.default_rng(4).random((4, H, W), dtype=np.float32))
    assert torch.equal(tcomposite.combine([got, frame]), frame)  # the identity of 'over'


# ------------------------------------------------------- channel frames

def _planes(fmt: str, w: int, h: int, rng):
    if fmt == "rgba_f32":  # an opaque 3-channel field: a frame, not planes
        return rng.random((3, h, w), dtype=np.float32)
    if fmt == "v210":
        return [random_words(rng, w, h)]
    if fmt == "rgba8":
        return jget_format("rgba8").fill_buf(w, h)
    hi = 1024 if fmt == "yuv422p10le" else 256
    return [rng.integers(0, hi, size=s, dtype=dt) for s, dt in jget_format(fmt).plane_shapes(w, h)]


# name -> (layers, out_format, emit_rgba): a layer is (src_format,
# src_b_format or None, src_size or None, matrix or None)
FRAMES = {
    # a v210 clip at half size: its own K1 call, resized, packed
    "v210_half_size": ([("v210", None, (96, 8), None)], "v210", False),
    # a channel-size v210 clip under an off-size nv12 clip with an odd
    # 4:2:0 height in a quadrant; yuv420p out
    "nv12_odd_height_quadrant": ([("v210", None, None, None), ("nv12", None, (100, 9), QUARTER)],
                                 "yuv420p", False),
    # two v210 sizes in one frame (two K1 calls) and a yuv422p10le clip
    # dissolving to an off-size v210 clip; emit_rgba
    "two_v210_sizes_emit_rgba": ([("v210", None, None, None), ("yuv422p10le", "v210", (96, 24), QUARTER)],
                                 "v210", True),
    # the multi-box stack with a 720p-style clip pair: every layer the
    # rgba kind, one packed composite with the top layer's alpha
    "multibox_src_size": ([
        ("yuv422p10le", None, None, transform_matrix(W, H, scale_x=0.5, scale_y=0.5, offset_x=0.25, offset_y=0.25)),
        ("yuv420p", "nv12", (128, 10), QUARTER),
        ("nv12", None, None, transform_matrix(W, H, scale_x=0.5, scale_y=0.5, offset_x=0.25, offset_y=-0.25)),
        ("rgba8", None, None, transform_matrix(W, H, scale_x=0.95, scale_y=0.95)),
    ], "v210", True),
    # opaque 3-channel fields, one off-size: both DVE dissolves join one
    # rgb3 run once _sources has resized the off-size pair
    "rgb3_field_off_size": ([
        ("rgba_f32", "rgba_f32", (96, 8), QUARTER),
        ("rgba_f32", "rgba_f32", None, transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02)),
    ], "v210", False),
}


def _frame_case(name: str):
    layers, out_format, emit_rgba = FRAMES[name]
    rng = np.random.default_rng(len(name))
    specs, lps = [], []
    for fmt, fmt_b, size, mat in layers:
        w, h = size or (W, H)
        lp = {"src": _planes(fmt, w, h, rng)}
        kw = dict(src_size=size)
        if fmt_b is not None:
            lp.update(src_b=_planes(fmt_b, w, h, rng), mix=np.float32(0.35))
            kw.update(transition="dissolve", src_b_format=fmt_b)
        if mat is not None:
            lp["matrix"] = mat
            kw.update(has_transform=True, axis_aligned=True)
        specs.append(jpipe.LayerSpec(fmt, **kw))
        lps.append(lp)
    spec = jpipe.ChannelSpec(W, H, out_format, layers=tuple(specs), emit_rgba=emit_rgba)
    return spec, {"layers": lps}


def _jax(params):
    return {"layers": [
        {k: ([jnp.asarray(p) for p in v] if isinstance(v, list) else jnp.asarray(v)) for k, v in lp.items()}
        for lp in params["layers"]
    ]}


def _delta(fmt: str, got, want) -> int:
    if fmt == "v210":
        return max_code_delta(words_to_numpy(got[0]), np.asarray(want[0]), W, H)
    return max(int(np.abs(g.numpy().astype(np.int64) - np.asarray(x).astype(np.int64)).max())
               for g, x in zip(got, want))


@pytest.mark.parametrize("name", sorted(FRAMES))
def test_src_size_frames_match_jax_xla(name):
    """Channel frames with off-geometry layers within 1 code of JAX's XLA
    path (which unpacks at src_size and resizes in _fit_channel), the
    emit_rgba frame within 2e-4 carrying the top layer's alpha; the
    plain program equals the wrappers on the CPU."""
    spec, params = _frame_case(name)
    tspec = spec_from_fields(spec._asdict())
    tparams = params_from_numpy(params, "cpu")
    out = tpipe.make_channel_program(tspec)(tparams)
    plain = tpipe.make_channel_program(tspec, plain=True)(tparams)
    want = jpipe.make_channel_program(spec)(_jax(params))
    got, ref, want_p = ((out["packed"], plain["packed"], want["packed"]) if spec.emit_rgba
                        else (out, plain, want))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert _delta(spec.out_format, got, want_p) <= 1
    if spec.emit_rgba:
        rgba = out["rgba"]
        assert tuple(rgba.shape) == (4, H, W) and bool(torch.isfinite(rgba).all())
        assert np.abs(rgba.numpy() - np.asarray(want["rgba"])).max() <= TOL_RGBA
        # the top layer's warped (and mixed) alpha plane, from its frames
        # at channel geometry
        n = len(spec.layers) - 1
        top, srcs = tparams["layers"][n], tpipe._sources(tspec, tparams, tpipe._PLAIN)
        if "src_b" in top:
            layer = warp_plain(srcs[(n, "src")], top["matrix"], srcs[(n, "src_b")], top["mix"])
        else:
            layer = warp_plain(srcs[(n, "src")], top["matrix"])
        assert torch.equal(rgba[3], layer[3])


def test_src_size_v210_slots_leave_the_channel_size_batch():
    """v210 slots unpack in one call per size: the channel-size slots
    together, a src_size layer's slots at their own size; a wipe mask at
    channel size (JAX unpacks it there)."""
    spec, params = _frame_case("two_v210_sizes_emit_rgba")
    spec = spec._replace(layers=spec.layers + (
        jpipe.LayerSpec("v210", transition="wipe", src_b_format="v210", mask_format="v210", src_size=(96, 8)),))
    rng = np.random.default_rng(3)
    params["layers"].append({"src": _planes("v210", 96, 8, rng), "src_b": _planes("v210", 96, 8, rng),
                             "mask": _planes("v210", W, H, rng)})
    calls = []

    def spy(words, width, height, *args):
        calls.append((len(words), width, height))
        return tpipe._PLAIN.v210_unpack(words, width, height, *args)

    tspec = spec_from_fields(spec._asdict())
    srcs = tpipe._sources(tspec, params_from_numpy(params, "cpu"), tpipe._PLAIN._replace(v210_unpack=spy))
    assert sorted(calls) == sorted([(2, W, H), (1, 96, 24), (2, 96, 8)])
    assert all(tuple(f.shape[-2:]) == (H, W) for f in srcs.values())
    assert tpipe._packed_composite_run(tspec, params_from_numpy(params, "cpu")) is None


def test_off_size_field_joins_the_rgb3_run():
    """A layer's kind is decided by its frames' channels: an off-size
    3-channel field is resized by _sources before the packed composite
    reads it, so its layer joins the rgb3 run, here the whole stack."""
    spec, params = _frame_case("rgb3_field_off_size")
    run = tpipe._packed_composite_run(spec_from_fields(spec._asdict()), params_from_numpy(params, "cpu"))
    assert run == (0, 2, "packed", "rgb3", "top")
