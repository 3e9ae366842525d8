"""Port parity for the interlaced default load (the reference's 4x1080i50
channels; bench.py interlaced_channels_step), cut to 256x64 on the CPU:
the 3-channel unpack and warp, the separable warp alpha, the field
interleaves, one frame period of one channel through both JAX paths, and
the in-program yadif ring route against the pair route.

Contracts: the 3-channel warp, the warp alpha, the yadif fields, the
interleaves and the packs of ramps are bit-exact against JAX; the unpack
is within one LUT step (4e-5, torch's and XLA's float32 pow); whole
frame periods are within 1 code, and exact between the port's own ring
and pair routes.  From random words the port's spread against JAX is no
larger than the spread between JAX's own XLA and Pallas paths (C2)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops import io as jio
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix, warp_axis_aligned
from phaneron_tpu.ops.pallas_kernels import make_v210_unpack_rgba_batch
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu.ops.pallas_warp import warp_alpha_vectors as jax_alpha_vectors
from phaneron_tpu.ops.yadif import yadif_frame
from phaneron_tpu.runtime.frame import RGBA_F32
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import io as tio
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops.warp import warp, warp_alpha_vectors
from torch_parity import max_code_delta, random_words, v210_codes, words_to_planes

torch.set_num_threads(1)

W, H = 256, 64
N_SRCS = 8  # sources per channel: 4 dissolve layers
# one LUT step at the top of the BT.709 curve (2.022 / 65535): the table
# equals JAX's transfer function, but XLA contracts the colour matrix's
# multiply-adds into FMAs, which moves a few LUT indices by one
TOL_UNPACK = 3.1e-5
V210 = jget_format("v210")
MATS = [
    transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i).astype(np.float32)
    for i in range(4)
]
MIXES = [0.4 + 0.05 * i for i in range(4)]
_jax_yadif = jax.jit(yadif_frame, static_argnums=(4, 5))


def _jax_unpack_batch():
    """The Pallas batch unpack (interpret) of two sources at W x H, one
    build shared by every test: the build is most of its cost."""
    return make_v210_unpack_rgba_batch(W, H, 2, channels=3, interpret=True)


def _t(a):
    return torch.from_numpy(np.array(a, copy=True))


# --------------------------------------------------- 3-channel stages


def test_v210_unpack_3ch_matches_batch_kernel():
    """K1 with channels=3 against make_v210_unpack_rgba_batch(channels=3),
    and equal to the RGB planes of the 4-channel unpack."""
    w, h = W, H
    rng = np.random.default_rng(2)
    srcs = [random_words(rng, w, h), V210.fill_buf(w, h)[0]]
    want = _jax_unpack_batch()(
        [jnp.asarray(words_to_planes(s)) for s in srcs]
    )
    words = [torch.from_numpy(s.view(np.int32).copy()) for s in srcs]
    got = K.v210_unpack(words, w, h, channels=3)
    four = K.v210_unpack(words, w, h)
    for a, b, c in zip(got, want, four):
        assert tuple(a.shape) == (3, h, w) and a.dtype == torch.float32
        assert np.abs(a.numpy() - np.asarray(b)).max() <= TOL_UNPACK
        assert torch.equal(a, c[:3])
    with pytest.raises(ValueError, match="channels"):
        K.v210_unpack(words, w, h, channels=2)


WARP_MATS = [
    dict(scale_x=0.9, scale_y=0.9, offset_x=0.02),
    dict(scale_x=0.5, scale_y=2.0, offset_y=-0.1),
    dict(flip_h=True, scale_x=1.3),
    dict(anchor_x=0.3, scale_x=1.5, scale_y=0.7, offset_y=0.1),
]


@pytest.mark.parametrize("kwargs", WARP_MATS)
def test_warp_3ch_and_alpha_vectors_equal_jax(kwargs):
    """K4's plain version on RGB frames, single and dissolve pair, equals
    JAX's XLA warp_axis_aligned bit for bit; warp_alpha_vectors equals
    JAX's."""
    rng = np.random.default_rng(13)
    a, b = (rng.random((3, H, W), dtype=np.float32) for _ in range(2))
    m = transform_matrix(W, H, **kwargs).astype(np.float32)
    mix = np.float32(0.35)
    wa = warp_axis_aligned(jnp.asarray(a), jnp.asarray(m))
    wb = warp_axis_aligned(jnp.asarray(b), jnp.asarray(m))
    np.testing.assert_array_equal(warp(_t(a), _t(m)).numpy(), np.asarray(wa))
    got = warp(_t(a), _t(m), _t(b), torch.tensor(mix)).numpy()
    np.testing.assert_array_equal(got, np.asarray(wa * mix + wb * (1.0 - mix)))
    wy, wx = warp_alpha_vectors(H, W, _t(m))
    jy, jx = jax_alpha_vectors(H, W, jnp.asarray(m))
    np.testing.assert_array_equal(wy.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(wx.numpy(), np.asarray(jx))


def _ramp_fields():
    """Two field-rate RGBA frames from the v210 ramp, one shifted a row
    (tests/test_interlace.py), unpacked by JAX: the same floats go to both
    packages."""
    up = jpipe.make_unpack_program("v210", W, H, "709", "709")
    fill = jnp.asarray(V210.fill_buf(W, H)[0])
    return np.asarray(up([fill])), np.asarray(up([jnp.roll(fill, 1, axis=0)]))


def test_interleave_and_interlaced_packs_equal_jax():
    top, bot = _ramp_fields()
    merged = tio.interleave_rgba_fields(_t(top), _t(bot))
    np.testing.assert_array_equal(
        merged.numpy(), np.asarray(jio.interleave_rgba_fields(jnp.asarray(top), jnp.asarray(bot)))
    )
    want = np.asarray(
        jpipe.make_interlaced_pack_program("v210", W, H, "709")(jnp.asarray(top), jnp.asarray(bot))[0]
    )
    (got,) = tpipe.make_interlaced_pack_program("v210", W, H, "709")(_t(top), _t(bot))
    np.testing.assert_array_equal(words_to_numpy(got), want)
    # the packed-domain select equals interleave + pack, and JAX's select
    pack = tpipe.make_pack_program("v210", W, H, "709")
    word_pair = tpipe.make_interlaced_word_pack_program("v210")
    (sel,) = word_pair(pack(_t(top)), pack(_t(bot)))
    assert torch.equal(sel, got)
    jpack = jpipe.make_pack_program("v210", W, H, "709")
    jsel = jpipe.make_interlaced_word_pack_program("v210")(
        jpack(jnp.asarray(top)), jpack(jnp.asarray(bot))
    )
    np.testing.assert_array_equal(words_to_numpy(sel), np.asarray(jsel[0]))
    # planar 4:2:2 takes the select too; the RGB planes of a 3-channel
    # frame pack like the RGBA frame
    y422 = tpipe.make_interlaced_word_pack_program("yuv422p8")
    planes = [(torch.arange(H * 8) % 251).to(torch.uint8).reshape(H, 8)] * 3
    out = y422(planes, [p.flip(0) for p in planes])
    assert torch.equal(out[0][1::2], planes[0].flip(0)[1::2])
    assert torch.equal(pack(_t(top[:3]))[0], pack(_t(top))[0])


# ------------------------------------------- one frame period, as bench.py


def _ramp_words(seed: int) -> list:
    """Per source, three distinct v210 frames: the ramp moved by whole
    rows and 6-pixel groups (bench.py rolls fill_buf the same way), so
    fields carry motion for the temporal predictor."""
    base = V210.fill_buf(W, H)[0]
    return [
        [np.roll(np.roll(base, 3 * s + 2 * a + seed, axis=0), 4 * (5 * s + 3 * a), axis=1)
         for a in range(3)]
        for s in range(N_SRCS)
    ]


def _layers_spec(pallas: bool, tff: bool, deinterlace: bool = False, n_layers: int = 4):
    layer = lambda i: jpipe.LayerSpec(
        RGBA_F32, transition="dissolve", has_transform=True, axis_aligned=True,
        src_b_format=RGBA_F32, src_opaque=True, deinterlace=deinterlace,
        warp_bucket=bucket_of(MATS[i]) if pallas else -1,
    )
    return jpipe.ChannelSpec(
        W, H, "v210", layers=tuple(layer(i) for i in range(n_layers)), tff=tff,
        pallas_stages=pallas,
    )


def _tick_params(fields, t: int, to):
    return {"layers": [
        {"src": fields[2 * i][t], "src_b": fields[2 * i + 1][t], "matrix": to(MATS[i]),
         "mix": to(np.float32(MIXES[i]))}
        for i in range(len(fields) // 2)
    ]}


def _jax_period(spec, rings):
    """JAX: pair deinterlace per source, two ticks, word interleave.  The
    Pallas pair kernel (interpret) with pallas_stages, else yadif_frame."""
    tff = spec.tff
    if spec.pallas_stages:
        pair = jpipe.make_yadif_pair_field_program(H, W, tff, channels=3)
        fields = [pair(*r) for r in rings]
    else:
        order = (0, 1) if tff else (1, 0)
        fields = [tuple(_jax_yadif(*r, jnp.int32(p), tff, False) for p in order) for r in rings]
    prog = jpipe.make_channel_program(spec)
    ticks = [prog(_tick_params(fields, t, jnp.asarray)) for t in (0, 1)]
    return np.asarray(jpipe.make_interlaced_word_pack_program("v210")(*ticks)[0])


def _port_period(spec, rings):
    tspec = spec_from_fields(spec._asdict())
    pair = tpipe.make_yadif_pair_field_program(H, W, spec.tff, channels=3)
    fields = [pair(*r) for r in rings]
    prog = tpipe.make_channel_program(tspec)
    ticks = [prog(_tick_params(fields, t, _t)) for t in (0, 1)]
    (out,) = tpipe.make_interlaced_word_pack_program("v210")(*ticks)
    assert out.dtype == torch.int32 and tuple(out.shape) == (H, V210.pitch_bytes(W) // 4)
    return words_to_numpy(out)


@pytest.mark.parametrize("pallas", [True, False])
@pytest.mark.parametrize("tff", [True, False])
def test_frame_period_matches_jax(pallas, tff):
    """One frame period of one 1080i-structured channel, from the v210
    words: 8 sources unpacked to 3 channels (K1: Pallas batch kernel or
    the XLA unpack), 8 pair deinterlaces (exact), 2 ticks of 4 rgb3
    dissolve DVE layers (JAX: the packed composite with pallas_stages,
    the padded 4-channel staged path without), word interleave.  <= 1
    code; the unpack's one-LUT-step difference is where it is not 0."""
    words = _ramp_words(0)
    if pallas:
        up = _jax_unpack_batch()
        jrings = [[] for _ in range(N_SRCS)]
        for a in range(3):
            for s in range(0, N_SRCS, 2):
                pair = up([jnp.asarray(words_to_planes(words[s + k][a])) for k in range(2)])
                jrings[s].append(pair[0])
                jrings[s + 1].append(pair[1])
    else:
        up = jpipe.make_unpack_program("v210", W, H, "709", "709", channels=3)
        jrings = [[up([jnp.asarray(w)]) for w in ws] for ws in words]
    tup = tpipe.make_unpack_program("v210", W, H, "709", "709", channels=3)
    trings = [[tup([_t(w.view(np.int32))]) for w in ws] for ws in words]
    assert all(f.shape == (3, H, W) for r in trings for f in r)
    spec = _layers_spec(pallas, tff)
    want = _jax_period(spec, jrings)
    got = _port_period(spec, trings)
    assert max_code_delta(got, want, W, H) <= 1


@pytest.mark.parametrize("pallas", [True, False])
def test_frame_period_from_identical_rings_matches_jax(pallas):
    """Full-range random RGB rings handed to both packages as the same
    floats: yadif is exact, so the period is within 1 code.  (From random
    v210 words the unpack's one-LUT-step difference can flip a yadif edge
    choice on noise: ROADMAP.md Queue C, C2.)"""
    rng = np.random.default_rng(41)
    rings = [[rng.random((3, H, W), dtype=np.float32) for _ in range(3)]
             for _ in range(N_SRCS)]
    spec = _layers_spec(pallas, True)
    want = _jax_period(spec, [[jnp.asarray(f) for f in r] for r in rings])
    got = _port_period(spec, [[_t(f) for f in r] for r in rings])
    assert max_code_delta(got, want, W, H) <= 1


def _code_deltas(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return np.concatenate([np.abs(x - y).ravel() for x, y in zip(v210_codes(a, W, H), v210_codes(b, W, H))])


def test_random_word_spread_is_the_references_own():
    """ROADMAP.md C2, closed: from full-range random v210 words (seed 0)
    JAX's own two unpacks, the XLA program (jitted to_rgba) and the
    Pallas batch kernel, differ by one LUT step in ~21 % of samples.  The
    port's unpack is no farther from either: from the Pallas kernel it
    differs in fewer samples than XLA does, from XLA in at most 3
    percentage points more (the margin: 22.6 % against 20.9 % measured on
    the CPU, all within one LUT step).  Through yadif's edge choice on
    noise, one frame period of the interlaced load is no farther from
    JAX's XLA path than JAX's Pallas path is: the same largest code delta
    at most, and a share of words off by more than one code at most 0.05
    percentage points above the Pallas path's (0.32 % both, measured)."""
    rng = np.random.default_rng(0)
    srcs = [random_words(rng, W, H) for _ in range(2)]
    xla_up = jpipe.make_unpack_program("v210", W, H, "709", "709", channels=3)
    xla = np.stack([np.asarray(xla_up([jnp.asarray(s)])) for s in srcs])
    pallas = np.stack([np.asarray(f) for f in _jax_unpack_batch()([jnp.asarray(words_to_planes(s)) for s in srcs])])
    port = np.stack([f.numpy() for f in K.v210_unpack([_t(s.view(np.int32)) for s in srcs], W, H, channels=3)])
    share = lambda a, b: float(np.mean(a != b))
    assert max(np.abs(port - xla).max(), np.abs(port - pallas).max()) <= TOL_UNPACK
    assert share(port, pallas) <= share(pallas, xla)
    assert share(port, xla) <= share(pallas, xla) + 0.03

    words = [[random_words(rng, W, H) for _ in range(3)] for _ in range(N_SRCS)]
    jrings_pallas = [[] for _ in range(N_SRCS)]
    for a in range(3):
        for s in range(0, N_SRCS, 2):
            pair = _jax_unpack_batch()([jnp.asarray(words_to_planes(words[s + k][a])) for k in range(2)])
            jrings_pallas[s].append(pair[0])
            jrings_pallas[s + 1].append(pair[1])
    want_pallas = _jax_period(_layers_spec(True, True), jrings_pallas)
    want_xla = _jax_period(_layers_spec(False, True), [[xla_up([jnp.asarray(w)]) for w in ws] for ws in words])
    tup = tpipe.make_unpack_program("v210", W, H, "709", "709", channels=3)
    got = _port_period(_layers_spec(False, True), [[tup([_t(w.view(np.int32))]) for w in ws] for ws in words])
    port_xla, pallas_xla = _code_deltas(got, want_xla), _code_deltas(want_pallas, want_xla)
    assert port_xla.max() <= pallas_xla.max()
    assert np.mean(port_xla > 1) <= np.mean(pallas_xla > 1) + 0.0005


# ----------------------------------------------- the in-program ring route


def test_ring_route_matches_jax_and_equals_pair_route():
    """deinterlace=True layers carrying (prev, cur, next) rings and a
    parity: <= 1 code against JAX at both parities, and bit-equal to the
    pair route (rgba_f32 fields) on the same rings."""
    rng = np.random.default_rng(43)
    rings = [tuple(rng.random((3, H, W), dtype=np.float32) for _ in range(3)) for _ in range(4)]
    spec = _layers_spec(False, True, deinterlace=True, n_layers=2)
    jprog = jpipe.make_channel_program(spec)
    tprog = tpipe.make_channel_program(spec_from_fields(spec._asdict()))
    pair_spec = spec_from_fields(_layers_spec(False, True, n_layers=2)._asdict())
    pair = tpipe.make_yadif_pair_field_program(H, W, True, channels=3)
    fields = [pair(*(_t(f) for f in r)) for r in rings]
    for parity in (0, 1):
        params = {"layers": [
            {"src_ring": rings[2 * i], "src_b_ring": rings[2 * i + 1], "parity": parity,
             "matrix": MATS[i], "mix": np.float32(MIXES[i])}
            for i in range(2)
        ]}
        jparams = {"layers": [
            {k: (tuple(jnp.asarray(f) for f in v) if isinstance(v, tuple) else jnp.asarray(v))
             for k, v in lp.items()}
            for lp in params["layers"]
        ]}
        want = np.asarray(jprog(jparams)[0])
        (got,) = tprog(params_from_numpy(params, "cpu"))
        assert max_code_delta(words_to_numpy(got), want, W, H) <= 1
        # parity p is the first field of a tff period when p == 0
        (via_pair,) = tpipe.make_channel_program(pair_spec)(_tick_params(fields, parity, _t))
        assert torch.equal(got, via_pair)


def test_params_from_numpy_carries_rings_parity_and_rgb_frames():
    rng = np.random.default_rng(47)
    ring = tuple(rng.random((3, 4, 8), dtype=np.float32) for _ in range(3))
    frame = rng.random((3, 4, 8), dtype=np.float32)
    port = params_from_numpy(
        {"layers": [{"src_ring": ring, "parity": 1, "src": frame, "mix": 0.5}]}, "cpu"
    )
    lp = port["layers"][0]
    assert isinstance(lp["src_ring"], tuple) and len(lp["src_ring"]) == 3
    assert all(np.array_equal(t.numpy(), f) for t, f in zip(lp["src_ring"], ring))
    assert lp["parity"].dtype == torch.int32 and lp["parity"].ndim == 0 and int(lp["parity"]) == 1
    assert lp["src"].dtype == torch.float32 and np.array_equal(lp["src"].numpy(), frame)
    assert lp["mix"].dtype == torch.float32
