"""Port parity for the v210 packed sources: the packed warp (B6,
ops/packed_warp.py packed_warp) against phaneron_tpu's
make_packed_warp_program / make_packed_warp_pair_program (Pallas,
interpret mode on the CPU) and its XLA staged path, the packed composite
with v210 word sources (B7, packed_composite(..., src_kind='packed'))
against make_packed_composite_program(src_kind='packed'), the whole
progressive 4-layer frame (bench.py composite_step) through both
programs, and which structures the channel program sends to each.

Geometries are those the TPU gates admit: 768x16 (packed_warp_fits and
packed_composite_fits need groups a multiple of 128 or the HD pad).
Contracts: <= 1 code after the pack (the TPU kernels premix a
shared-matrix pair before one warp, run the warps as bf16 hi/lo products
and the composite's decode with a polynomial gamma; the port decodes
exactly and mixes after the warp, as its staged path does)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.geometry import transform_matrix, warp_axis_aligned
from phaneron_tpu.ops.pallas_kernels import planes_to_words
from phaneron_tpu.ops.pallas_packed_warp import (
    make_packed_composite_program,
    make_packed_warp_pair_program,
    make_packed_warp_program,
    packed_composite_fits,
    packed_warp_fits,
)
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu.runtime.frame import RGBA_F32
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops import packed_warp as PW
from phaneron_tpu_torch.ops.warp import warp_plain
from torch_parity import max_code_delta, random_words, words_to_planes

torch.set_num_threads(1)

W, H = 768, 16
MATS = [
    transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i).astype(np.float32)
    for i in range(4)
]  # bench.py composite_step's four layer matrices
MAT_B = transform_matrix(W, H, scale_x=0.8, scale_y=0.85, offset_y=-0.05).astype(np.float32)
MIXES = [np.float32(0.4 + 0.05 * i) for i in range(4)]


def _t(a):
    a = np.array(a, copy=True)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


def _codes_delta(a, b) -> int:
    """Code delta of two (4, H, W) RGBA frames after the same v210 pack."""
    pack = lambda f: words_to_numpy(K.v210_pack_plain(torch.from_numpy(np.array(f))))
    return max_code_delta(pack(a), pack(b), W, H)


def _sources(seed, n):
    rng = np.random.default_rng(seed)
    return [random_words(rng, W, H) for _ in range(n)]


# ------------------------------------------------------------------ B6


def _jax_xla_warp(words, mats, mix):
    """JAX's staged path: XLA unpack (4 ch), warp_axis_aligned, mix."""
    up = jpipe.make_unpack_program("v210", W, H, "709", "709")
    frames = [warp_axis_aligned(up([jnp.asarray(w)]), jnp.asarray(m)) for w, m in zip(words, mats)]
    return np.asarray(frames[0] if mix is None else frames[0] * mix + frames[1] * (1.0 - mix))


@pytest.mark.parametrize("mode", ["single", "pair", "distinct"])
def test_packed_warp_within_one_code_of_jax(mode):
    """A single layer, a shared-matrix dissolve pair and a pair under two
    distinct matrices (n_mat 2), full-range random words."""
    a, b = _sources(len(mode), 2)
    m = MATS[0]
    if mode == "single":
        assert packed_warp_fits(H, W, bucket_of(m), 1)
        want = make_packed_warp_program(H, W, bucket_of(m), interpret=True)(
            jnp.asarray(words_to_planes(a)), jnp.asarray(m))
        got = PW.packed_warp(_t(a), _t(m), W, H)
        xla = _jax_xla_warp([a], [m], None)
    else:
        mb = m if mode == "pair" else MAT_B
        bucket = max(bucket_of(m), bucket_of(mb))
        assert packed_warp_fits(H, W, bucket, 1 if mode == "pair" else 2)
        pair = make_packed_warp_pair_program(H, W, bucket, same_mat=mode == "pair", interpret=True)
        want = pair(jnp.asarray(words_to_planes(a)), jnp.asarray(words_to_planes(b)),
                    jnp.asarray(m), jnp.asarray(mb), jnp.float32(0.35))
        got = PW.packed_warp(_t(a), _t(m), W, H, _t(b), torch.tensor(0.35),
                             None if mode == "pair" else _t(mb))
        xla = _jax_xla_warp([a, b], [m, mb], np.float32(0.35))
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, H, W)
    assert _codes_delta(got.numpy(), np.asarray(want)) <= 1
    assert _codes_delta(got.numpy(), xla) <= 1


def test_packed_plain_versions_are_unpack_then_warp_and_cpu_launches_nothing():
    a, b = (_t(w) for w in _sources(7, 2))
    m, mb, mix = _t(MATS[1]), _t(MAT_B), torch.tensor(0.6)
    before = (PW.packed_warp.launches, PW.packed_composite.launches)
    fa, fb = K.v210_unpack_plain([a, b], W, H)
    assert torch.equal(PW.packed_warp(a, m, W, H), warp_plain(fa, m))
    assert torch.equal(PW.packed_warp(a, m, W, H, b, mix), warp_plain(fa, m, fb, mix))
    distinct = warp_plain(fa, m) * mix + warp_plain(fb, mb) * (1.0 - mix)
    assert torch.equal(PW.packed_warp(a, m, W, H, b, mix, mb), distinct)
    cfg, mats, mixes = (2, 1), [m, mb], [mix, None]
    want = PW.packed_composite_plain(K.v210_unpack_plain([a, b, a], W, H, channels=3), cfg, mats, mixes)
    assert torch.equal(PW.packed_composite([a, b, a], cfg, mats, mixes, src_kind="packed", size=(W, H)),
                       want)
    assert (PW.packed_warp.launches, PW.packed_composite.launches) == before
    with pytest.raises(ValueError, match="go together"):
        PW.packed_warp(a, m, W, H, b)
    with pytest.raises(ValueError, match="size"):
        PW.packed_composite([a, b], (2,), [m], [mix], src_kind="packed")
    with pytest.raises(ValueError, match="src_kind"):
        PW.packed_composite([a, b], (2,), [m], [mix], src_kind="yuv")


# ------------------------------------------- B7 and the progressive frame


def _progressive(pallas: bool):
    layer = jpipe.LayerSpec(
        "v210", transition="dissolve", has_transform=True, axis_aligned=True,
        src_b_format="v210", warp_bucket=max(bucket_of(m) for m in MATS) if pallas else -1,
    )
    return jpipe.ChannelSpec(W, H, "v210", layers=(layer,) * 4, pallas_stages=pallas)


def _progressive_params(words, to_src):
    return {"layers": [
        {"src": [to_src(words[2 * i])], "src_b": [to_src(words[2 * i + 1])], "matrix": MATS[i],
         "mix": MIXES[i]}
        for i in range(4)
    ]}


def _jax_run(spec, params):
    jp = {"layers": [{k: ([jnp.asarray(p) for p in v] if isinstance(v, list) else jnp.asarray(v))
                      for k, v in lp.items()} for lp in params["layers"]]}
    return np.asarray(jpipe.make_channel_program(spec)(jp)[0])


def test_progressive_frame_and_packed_composite_within_one_code_of_jax():
    """bench.py composite_step's frame (4 DVE + dissolve layers, 8
    distinct v210 sources: rolled fill_buf ramps and random words) through
    the port's program (one packed composite over the words) and JAX's,
    with its Pallas stages (one make_packed_composite_program launch,
    src_kind 'packed', poly gamma, as its pipeline builds it) and on its
    XLA path; the port's kernel call gives the program's words."""
    from phaneron_tpu.ops.formats import get_format

    base = get_format("v210").fill_buf(W, H)[0]
    words = [np.roll(base, 11 * (k + 1), axis=1) for k in range(4)] + _sources(31, 4)
    spec = _progressive(True)
    bucket = spec.layers[0].warp_bucket
    assert packed_composite_fits(H, W, bucket, 4, src_kind="packed")
    tspec = spec_from_fields(_progressive(False)._asdict())
    tparams = params_from_numpy(_progressive_params(words, lambda w: w), "cpu")
    assert tpipe._packed_composite_run(tspec, tparams) == (0, 4, "packed", "packed", "top")
    (got,) = tpipe.make_channel_program(tspec)(tparams)
    got = words_to_numpy(got)
    want = _jax_run(spec, _progressive_params(words, words_to_planes))
    assert max_code_delta(got, want, W, H) <= 1
    xla = _jax_run(_progressive(False), _progressive_params(words, lambda w: w))
    assert max_code_delta(got, xla, W, H) <= 1
    # JAX's program built the TPU kernel for exactly this run
    assert make_packed_composite_program.cache_info().currsize >= 1
    kernel = PW.packed_composite([_t(w) for w in words], (2, 2, 2, 2), [_t(m) for m in MATS],
                                 [torch.tensor(x) for x in MIXES], src_kind="packed", size=(W, H))
    assert words_to_numpy(kernel).tobytes() == got.tobytes()


# Matrices whose decode windows (csrc/packed_composite.cu) have edges: a
# dissolve layer and a cut layer each
EDGE_MATS = {
    # a negative m00: the window spans both tile ends the other way round
    "flip": [transform_matrix(W, H, flip_h=True, scale_x=0.9, scale_y=0.9, offset_x=0.03),
             transform_matrix(W, H, flip_h=True, flip_v=True, scale_x=1.3, scale_y=0.8)],
    # minification: about 2x and 4x the tile per axis in the window
    "minify": [transform_matrix(W, H, scale_x=0.5, scale_y=0.5, offset_x=0.25, offset_y=0.25),
               transform_matrix(W, H, scale_x=0.25, scale_y=0.25, offset_x=-0.1)],
    # offsets that leave the frame: windows clipped to it
    "off_frame": [transform_matrix(W, H, scale_x=0.7, scale_y=0.6, offset_x=0.45),
                  transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=-0.3, offset_y=0.4)],
}


@pytest.mark.parametrize("case", sorted(EDGE_MATS))
def test_packed_composite_window_edges_within_one_code_of_jax(case):
    """The plain version chip_smoke.py holds K5's window and direct
    branches to, against make_packed_composite_program(src_kind='packed')
    in interpret mode, under a flip, minification and offsets past the
    frame edge: a dissolve under one matrix and a cut under the other,
    over random words."""
    mats = [m.astype(np.float32) for m in EDGE_MATS[case]]
    srcs = _sources(len(case), 3)
    bucket = bucket_of(*mats)
    assert packed_composite_fits(H, W, bucket, 2, src_kind="packed")
    prog = make_packed_composite_program(H, W, bucket, (2, 1), src_kind="packed", interpret=True,
                                         poly_gamma=jpipe.PACKED_POLY_GAMMA)
    want = planes_to_words(prog([jnp.asarray(words_to_planes(s)) for s in srcs],
                                jnp.stack([jnp.asarray(m) for m in mats]),
                                jnp.asarray([MIXES[0], 1.0], jnp.float32)))
    got = PW.packed_composite_plain([_t(s) for s in srcs], (2, 1), [_t(m) for m in mats],
                                    [torch.tensor(MIXES[0]), None], src_kind="packed", size=(W, H))
    assert max_code_delta(words_to_numpy(got), np.asarray(want), W, H) <= 1


@pytest.mark.parametrize("case", sorted(EDGE_MATS))
def test_packed_composite_rgb3_window_edges_within_one_code_of_jax(case):
    """The rgb3 kind's plain version, which chip_smoke.py holds its copied
    windows and direct branch to, against
    make_packed_composite_program(src_kind='rgb3') in interpret mode under
    the same edge matrices: a dissolve under one and a cut under the other,
    over random (3, H, W) frames."""
    mats = [m.astype(np.float32) for m in EDGE_MATS[case]]
    rng = np.random.default_rng(len(case) + 50)
    srcs = [rng.random((3, H, W), dtype=np.float32) for _ in range(3)]
    bucket = bucket_of(*mats)
    assert packed_composite_fits(H, W, bucket, 2, src_kind="rgb3")
    prog = make_packed_composite_program(H, W, bucket, (2, 1), src_kind="rgb3", interpret=True)
    want = planes_to_words(prog([jnp.asarray(s) for s in srcs], jnp.stack([jnp.asarray(m) for m in mats]),
                                jnp.asarray([MIXES[0], 1.0], jnp.float32)))
    got = PW.packed_composite_plain([_t(s) for s in srcs], (2, 1), [_t(m) for m in mats],
                                    [torch.tensor(MIXES[0]), None])
    assert max_code_delta(words_to_numpy(got), np.asarray(want), W, H) <= 1


# --------------------------------------------------------------- routes


def _dve(fmt="v210", **kw):
    return tpipe.LayerSpec(fmt, has_transform=True, axis_aligned=True, **kw)


V_DISSOLVE = _dve(transition="dissolve", src_b_format="v210")
V_DISTINCT = _dve(transition="dissolve", src_b_format="v210", warp_same_mat=False)
RGB3_DISSOLVE = _dve(RGBA_F32, transition="dissolve", src_b_format=RGBA_F32, src_opaque=True)


@pytest.mark.parametrize(
    "layers,kind,b6",
    [
        ((V_DISSOLVE,) * 4, "packed", ()),  # the progressive frame: one composite
        ((V_DISSOLVE, _dve()), "packed", ()),  # a dissolve and a cut
        ((V_DISSOLVE,), None, (0,)),  # a 1-layer stack: the packed warp
        ((V_DISSOLVE, V_DISTINCT), None, (0, 1)),  # distinct matrices: staged, both B6
        ((RGB3_DISSOLVE, V_DISSOLVE), None, (1,)),  # mixed kinds: staged
        ((V_DISSOLVE, tpipe.LayerSpec("yuv422p8")), None, (0,)),  # the entry() structure
        ((_dve(deinterlace=True), V_DISSOLVE), None, (1,)),  # a ring layer: no B6 for it
    ],
)
def test_channel_program_routes_v210_layers(layers, kind, b6):
    """A whole stack of >= 2 v210 DVE layers (cuts or same-matrix
    dissolves) runs as one packed composite; otherwise every v210 DVE
    layer, distinct-matrix pairs included, takes the packed warp and its
    slots are not unpacked; the output equals the plain program's."""
    spec = tpipe.ChannelSpec(W, H, "v210", layers=layers)
    rng = np.random.default_rng(len(layers) + 7 * len(b6))
    params = {"layers": []}
    for i, ls in enumerate(layers):
        lp = {"matrix": MATS[i], "matrix_b": MAT_B, "mix": MIXES[i]}
        for key, fmt in tpipe._slot_formats(ls):
            if ls.deinterlace:
                lp[f"{key}_ring"] = tuple(rng.random((3, H, W), dtype=np.float32) for _ in range(3))
                lp["parity"] = 1
            elif fmt == RGBA_F32:
                lp[key] = rng.random((3, H, W), dtype=np.float32)
            elif fmt == "v210":
                lp[key] = [random_words(rng, W, H)]
            else:
                lp[key] = [rng.integers(0, 256, size=s, dtype=np.uint8) for s in ((H, W), (H, W // 2), (H, W // 2))]
        params["layers"].append(lp)
    tp = params_from_numpy(params, "cpu")
    run = tpipe._packed_composite_run(spec, tp)
    assert (None if run is None else run.kind) == kind
    assert tuple(li for li, ls in enumerate(layers) if tpipe._packed_layer_ok(ls)) == (
        tuple(range(len(layers))) if kind == "packed" else b6)
    assert tpipe.missing_kernel(spec) is None
    (got,) = tpipe.make_channel_program(spec)(tp)
    (plain,) = tpipe.make_channel_program(spec, plain=True)(tp)
    assert torch.equal(got, plain)
    if kind == "packed":
        assert (run.start, run.end, run.emit) == (0, len(layers), "packed")
        args = tpipe._packed_composite_args(spec, tp, {}, run)
        want = PW.packed_composite_plain(*args, src_kind="packed", size=(W, H))
        assert torch.equal(got, want)
