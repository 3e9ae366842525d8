"""Port parity for the straggler channels (bench.py composite_variant_step):
the packed composite's rgba and both emits (B7, ops/packed_warp.py
``packed_composite``), its dispatch plan for runs that span part of the
stack (graph/pipeline.py ``_packed_composite_run``), and whole channel
frames with a rotated (B14), wiped (B4) or distinct-matrix rotated layer
on top of a packed run, and ``emit_rgba`` channels, against phaneron_tpu
on the CPU: its XLA path (``pallas_stages=False``) and its Pallas path
(interpret mode).

Geometry: 768x16, where every TPU gate on these paths passes
(packed_composite_fits for each emit and source kind, rotate_fits at
100 degrees, warp_fits with a mask, batch_unpack_fits, combine_pack_fits);
JAX's own emit tests run at 768x64, which costs four times the interpret
time.  Sources are bench.py's: the v210 ramp rolled by 17k+3 words.

Contracts: packed words within 1 code; the rgba emit within 2e-4 (the
Pallas composite's bf16 hi/lo warp and the FMA rounding of its feather
positions, tests/test_packed_warp.py:480-491); the emitted alpha is the
top layer's.  JAX's Pallas path rotates by a quarter turn and two shear
passes that differ from the direct gather at the rotated content's edges
(pallas_rotate.py:53-58), so against it a rotated frame is compared away
from those edges, as JAX's own tests do."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix
from phaneron_tpu.ops.pallas_kernels import planes_to_words
from phaneron_tpu.ops.pallas_rotate import make_rotate_program, rot_bucket_of
from phaneron_tpu.ops.pallas_warp import bucket_of
from phaneron_tpu.runtime.frame import RGBA_F32
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import kernels as K
from phaneron_tpu_torch.ops import packed_warp as PW
from phaneron_tpu_torch.ops.rotate import rotate
from phaneron_tpu_torch.ops.warp import warp_alpha_vectors, warp_plain
from torch_parity import graphic_rgba8, max_code_delta, v210_codes, words_to_planes

torch.set_num_threads(1)

W, H = 768, 16
TOL_RGBA = 2e-4
V210 = jget_format("v210")
MATS = [transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02 + 0.003 * i) for i in range(5)]
MIXES = [np.float32(0.4 + 0.05 * i) for i in range(5)]
ROT = transform_matrix(W, H, rotate=100 / 360.0, scale_x=0.9, scale_y=0.9)  # one_rotation
ROT_B = transform_matrix(W, H, rotate=95 / 360.0, scale_x=0.85, scale_y=0.85, offset_x=0.01)
TOP = transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.05)  # wipe and odd_cut
BUCKET = bucket_of(transform_matrix(W, H, scale_x=0.9, scale_y=0.9, offset_x=0.02))
BASE = V210.fill_buf(W, H)[0]


def _smooth_words() -> np.ndarray:
    """v210 words of a smooth opaque frame (tests/test_pallas_rotate.py
    _smooth): the rotated layers' content, where JAX's shear passes stay
    within their bounds of the direct gather."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    rgb = np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (x / W + 0.7 * y / H)),
        0.5 + 0.3 * np.cos(2 * np.pi * (0.5 * x / W + 1.3 * y / H)),
        0.25 + 0.5 * (x / W) * (y / H),
    ]).astype(np.float32)
    return words_to_numpy(K.v210_pack(torch.from_numpy(rgb)))


SMOOTH = _smooth_words()


def _layer(kind: str, pallas: bool) -> jpipe.LayerSpec:
    """A JAX LayerSpec of bench.py's variant shapes: 'diss' a v210 DVE
    dissolve, 'rot' a rotated v210 cut, 'wipe' a v210 wipe with DVE
    (src, src_b and mask v210), 'cut' an axis-aligned v210 cut, 'rotpair'
    a rotated dissolve under two distinct matrices, 'f32' an opaque
    (3, H, W) float32 dissolve (the rgb3 kind); and of the file-media
    multi-box channel (the rgba kind): 'y422' a yuv422p8 DVE dissolve to
    an nv12 clip, 'rgba8' the keyed rgba8 lower third as a DVE cut."""
    dve = dict(has_transform=True, axis_aligned=True)
    if kind == "y422":
        return jpipe.LayerSpec("yuv422p8", transition="dissolve", src_b_format="nv12",
                               warp_bucket=BUCKET if pallas else -1, **dve)
    if kind == "rgba8":
        return jpipe.LayerSpec("rgba8", warp_bucket=bucket_of(TOP) if pallas else -1, **dve)
    if kind == "diss":
        return jpipe.LayerSpec("v210", transition="dissolve", src_b_format="v210",
                               warp_bucket=BUCKET if pallas else -1, **dve)
    if kind == "f32":
        return jpipe.LayerSpec(RGBA_F32, transition="dissolve", src_b_format=RGBA_F32,
                               src_opaque=True, warp_bucket=BUCKET if pallas else -1, **dve)
    if kind == "cut":
        return jpipe.LayerSpec("v210", warp_bucket=bucket_of(TOP) if pallas else -1, **dve)
    if kind == "wipe":
        return jpipe.LayerSpec("v210", transition="wipe", src_b_format="v210", mask_format="v210",
                               warp_bucket=bucket_of(TOP) if pallas else -1, **dve)
    code = lambda m: rot_bucket_of(m, W, H) if pallas else -1
    if kind == "rot":
        return jpipe.LayerSpec("v210", has_transform=True, axis_aligned=False, rot_bucket=code(ROT))
    assert kind == "rotpair"
    return jpipe.LayerSpec("v210", transition="dissolve", src_b_format="v210", has_transform=True,
                           axis_aligned=False, warp_same_mat=False, rot_bucket=code(ROT),
                           rot_bucket_b=code(ROT_B))


def _spec(kinds, pallas: bool, emit_rgba: bool = False, out_format: str = "v210") -> jpipe.ChannelSpec:
    return jpipe.ChannelSpec(W, H, out_format, layers=tuple(_layer(k, pallas) for k in kinds),
                             pallas_stages=pallas, emit_rgba=emit_rgba)


def _params(kinds) -> dict:
    """numpy params: v210 slots as (H, G*4) uint32 words, bench.py's
    rolled ramps, one distinct roll per slot; rgb3 slots seeded frames."""
    rng = np.random.default_rng(len(kinds))
    n = iter(range(64))
    words = lambda: [np.roll(BASE, 17 * (next(n) + 1) + 3, axis=1)]
    layers = []
    for i, kind in enumerate(kinds):
        if kind in ("diss", "f32"):
            src = words if kind == "diss" else lambda: rng.random((3, H, W), dtype=np.float32)
            layers.append({"src": src(), "src_b": src(), "matrix": MATS[i], "mix": MIXES[i]})
        elif kind == "y422":
            layers.append({"src": jget_format("yuv422p8").fill_buf(W, H),
                           "src_b": jget_format("nv12").fill_buf(W, H), "matrix": MATS[i], "mix": MIXES[i]})
        elif kind == "rgba8":
            layers.append({"src": [graphic_rgba8(W, H)], "matrix": TOP})
        elif kind == "rot":
            layers.append({"src": [SMOOTH], "matrix": ROT})
        elif kind == "cut":
            layers.append({"src": words(), "matrix": TOP})
        elif kind == "wipe":
            layers.append({"src": words(), "src_b": words(), "mask": words(), "matrix": TOP})
        else:
            layers.append({"src": [SMOOTH], "src_b": [np.roll(SMOOTH, 4 * 9, axis=1)], "matrix": ROT,
                           "matrix_b": ROT_B, "mix": np.float32(0.6)})
    return {"layers": layers}


def _jax_params(params: dict, pallas: bool) -> dict:
    """The same inputs for JAX: v210 words as jnp arrays, host-split into
    (4, H, G) planes for the Pallas path (what its packed kinds read)."""
    def leaf(v):
        if isinstance(v, list):
            return [jnp.asarray(words_to_planes(p) if pallas and p.dtype == np.uint32 else p) for p in v]
        return jnp.asarray(v)

    return {"layers": [{k: leaf(v) for k, v in lp.items()} for lp in params["layers"]]}


def _port(kinds, emit_rgba: bool = False, out_format: str = "v210"):
    spec = spec_from_fields(_spec(kinds, False, emit_rgba, out_format)._asdict())
    return spec, params_from_numpy(_params(kinds), "cpu")


def _jax_frame(kinds, pallas: bool, emit_rgba: bool = False):
    spec = _spec(kinds, pallas, emit_rgba)
    for ls in spec.layers:
        for code in {ls.rot_bucket, ls.rot_bucket_b} - {-1}:
            # built outside the channel program's trace: the program caches
            # a constant made at build time (pallas_rotate.py:379)
            make_rotate_program(H, W, code)
    out = jpipe.make_channel_program(spec)(_jax_params(_params(kinds), pallas))
    if emit_rgba:
        return np.asarray(out["packed"][0]), np.asarray(out["rgba"])
    return np.asarray(out[0]), None


# ------------------------------------------------------- the dispatch plan


ONE_ROTATION = ("diss", "diss", "diss", "rot")
WIPE = ("diss", "diss", "diss", "wipe")
ROTATED_PAIR = ("diss", "diss", "diss", "rotpair")
ODD_CUT = ("diss", "diss", "diss", "cut")


@pytest.mark.parametrize("kinds,emit_rgba,want", [
    (ONE_ROTATION, False, (0, 3, "rgba", "packed", "coverage")),
    (WIPE, False, (0, 3, "rgba", "packed", "coverage")),
    (ROTATED_PAIR, False, (0, 3, "rgba", "packed", "coverage")),
    (("rot", "diss", "diss", "diss"), False, (1, 4, "rgba", "packed", "coverage")),  # straggler at the bottom
    (("diss", "diss", "rot", "diss", "diss"), False, (0, 2, "rgba", "packed", "coverage")),  # a tie keeps the first
    (ODD_CUT, False, (0, 4, "packed", "packed", "top")),
    (ODD_CUT, True, (0, 4, "both", "packed", "top")),  # emit_rgba over a whole stack
    (ONE_ROTATION, True, (0, 3, "rgba", "packed", "coverage")),
    (("f32", "f32", "diss", "diss", "diss"), False, (2, 5, "rgba", "packed", "coverage")),  # the longer run
    (("f32", "f32", "diss", "diss"), False, (0, 2, "rgba", "rgb3", "coverage")),  # a tie across kinds
    (("diss", "rot", "diss"), False, None),  # no run of two
    # the rgba kind (sources with their own alpha), held to _layers_combine_ok
    (("y422", "rgba8"), False, (0, 2, "packed", "rgba", "top")),
    (("y422", "y422", "rgba8"), True, (0, 3, "both", "rgba", "top")),
    # the rgba top over stragglers stays staged: its own alpha is the frame's
    (("rot", "y422", "rgba8"), False, None),
    (("rot", "y422", "y422", "rgba8"), False, (1, 3, "rgba", "rgba", "coverage")),
    (("diss", "y422", "rgba8"), True, None),
    (("y422", "rgba8", "rot"), False, (0, 2, "rgba", "rgba", "coverage")),
    (("diss", "diss", "y422", "y422"), False, (0, 2, "rgba", "packed", "coverage")),  # a tie across kinds
    (("y422", "y422", "diss", "diss", "diss"), False, (2, 5, "rgba", "packed", "coverage")),
])
def test_dispatch_plan_equals_jax(kinds, emit_rgba, want, monkeypatch):
    """The port's plan against JAX's (pallas_stages, every gate passing at
    this geometry): a 'packed' or 'rgb3' run equals _packed_composite_run;
    an 'rgba' run, which JAX has no kind for, is the whole stack exactly
    when JAX's _layers_combine_ok takes the stack (its all-layers combine,
    flag on).  The alpha is the top layer's exactly for a whole stack."""
    monkeypatch.setattr(jpipe, "ENABLE_LAYERS_COMBINE", True)
    spec, params = _port(kinds, emit_rgba)
    run = tpipe._packed_composite_run(spec, params)
    jspec = _spec(kinds, True, emit_rgba)
    jrun = jpipe._packed_composite_run(jspec, _jax_params(_params(kinds), True))
    assert (None if run is None else tuple(run)) == want
    if want is None or want[3] != "rgba":
        assert jrun == (None if want is None else want[:4])
    else:
        assert jrun is None
        assert jpipe._layers_combine_ok(jspec) == (want[:2] == (0, len(kinds)))
    if run is not None:
        assert (run.alpha == "top") == ((run.start, run.end) == (0, len(kinds)))


# ------------------------------------------------------- the B7 emits


# runs cut to two layers for the kernel and frame tests (bench.py runs
# three): the Pallas composite's interpret cost grows with its sources
RUN = ("diss", "cut")


@pytest.mark.parametrize("emit", ["rgba", "both"])
@pytest.mark.parametrize("kind", ["packed", "rgb3"])
def test_packed_composite_emits_match_jax(kind, emit):
    """B7's plain version with emit 'rgba' and 'both', over v210 words and
    over (3, H, W) frames, against make_packed_composite_program(emit=...)
    in interpret mode as JAX's pipeline builds it (_dispatch_packed_composite):
    RGB and the coverage alpha 1 - prod(1 - wy x wx) within 2e-4, words
    within 1 code; the frame's RGB packs to the 'packed' emit's words."""
    kinds = RUN if kind == "packed" else ("f32", "f32")
    spec, params = _port(kinds)
    run = tpipe._Run(0, 2, emit, kind, "coverage")
    srcs = {} if kind == "packed" else {
        (li, key): params["layers"][li][key] for li in range(2) for key in ("src", "src_b")}
    args = tpipe._packed_composite_args(spec, params, srcs, run)
    kw = dict(src_kind=kind, size=(W, H))
    before = PW.packed_composite.launches
    got = PW.packed_composite(*args, emit=emit, **kw)
    assert PW.packed_composite.launches == before
    jout = jpipe._dispatch_packed_composite(_spec(kinds, True), _jax_params(_params(kinds), True),
                                            0, 2, emit, kind)
    words, rgba = got if emit == "both" else (None, got)
    jrgba = np.asarray(jout[1] if emit == "both" else jout)
    assert rgba.dtype == torch.float32 and tuple(rgba.shape) == (4, H, W)
    assert np.abs(rgba.numpy() - jrgba).max() <= TOL_RGBA
    cover = PW.coverage([(None, *warp_alpha_vectors(H, W, m)) for m in args[2]])
    assert torch.equal(rgba[3], cover)
    packed = PW.packed_composite(*args, **kw)
    assert torch.equal(K.v210_pack(rgba[:3].contiguous()), packed)
    if emit == "both":
        assert torch.equal(words, packed)
        assert max_code_delta(words_to_numpy(words), np.asarray(planes_to_words(jout[0])), W, H) <= 1


# ------------------------------------------------------- channel frames


def _erode(mask: np.ndarray) -> np.ndarray:
    out = mask.copy()
    for dy in range(-2, 3):
        for dx in range(-2, 3):
            out &= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


def _rotated_regions(kinds):
    """(interior, exterior) of the top layer's rotated sources, each
    eroded by 2 pixels (tests/test_pallas_rotate.py): where every one
    covers opaquely, and where none shows.  None without a rotation."""
    mats = {"rot": [ROT], "rotpair": [ROT, ROT_B]}.get(kinds[-1])
    if mats is None:
        return None
    alphas = [rotate(torch.ones((4, H, W)), torch.from_numpy(m))[3].numpy() for m in mats]
    return _erode(np.minimum.reduce(alphas) > 0.999), _erode(np.maximum.reduce(alphas) < 1e-3)


def _code_deltas(a: np.ndarray, b: np.ndarray, where: np.ndarray) -> np.ndarray:
    """Y deltas at the pixels ``where`` holds, and chroma deltas (one
    sample per pixel pair, repeated to each pixel) at the pairs it holds
    for both."""
    (ya, ua, va), (yb, ub, vb) = v210_codes(a, W, H), v210_codes(b, W, H)
    pairs = np.repeat(where[:, 0::2] & where[:, 1::2], 2, axis=1)
    return np.concatenate([np.abs(ya - yb)[where], np.abs(ua - ub)[pairs], np.abs(va - vb)[pairs]])


@pytest.mark.parametrize("kinds,emit_rgba", [
    (RUN + ("rot",), False),  # one_rotation
    (RUN + ("wipe",), False),  # wipe
    (RUN + ("rotpair",), False),  # a rotated dissolve under two matrices
    (("diss", "cut"), True),  # emit_rgba over a whole stack: one 'both' launch
    (RUN + ("rot",), True),  # emit_rgba over a part-stack run and a rotation
])
def test_straggler_frame_matches_both_jax_paths(kinds, emit_rgba):
    """The channel frame through make_channel_program against JAX's XLA
    path (<= 1 code everywhere; the rgba emit within 2e-4) and its Pallas
    path (the same, but inside a rotated layer, where JAX rotates by shear
    passes, its own channel-program bound: codes <= 4 and a mean < 0.2,
    tests/test_pallas_rotate.py:230-235, and the rgba emit < 0.01; the
    band at the rotated edges is not compared).  The emitted alpha is the
    top layer's: wy x wx for an axis-aligned top, the rotated plane of
    ones for a rotated one."""
    spec, params = _port(kinds, emit_rgba)
    out = tpipe.make_channel_program(spec)(params)
    (got,), rgba = (out["packed"], out["rgba"]) if emit_rgba else (out, None)
    assert got.dtype == torch.int32 and tuple(got.shape) == (H, V210.pitch_bytes(W) // 4)
    got = words_to_numpy(got)
    everywhere = np.ones((H, W), bool)
    regions = _rotated_regions(kinds)
    for pallas in (False, True):
        want, want_rgba = _jax_frame(kinds, pallas, emit_rgba)
        if not pallas or regions is None:
            assert _code_deltas(got, want, everywhere).max() <= 1
            if emit_rgba:
                assert np.abs(rgba.numpy() - want_rgba).max() <= TOL_RGBA
            continue
        interior, exterior = regions
        assert interior.any() and exterior.mean() > 0.5
        assert _code_deltas(got, want, exterior).max() <= 1
        inside = _code_deltas(got, want, interior)
        assert inside.max() <= 4 and inside.mean() < 0.2
        if emit_rgba:
            assert np.abs(rgba.numpy() - want_rgba)[:, exterior].max() <= TOL_RGBA
            assert np.abs(rgba.numpy() - want_rgba)[:, interior].max() < 0.01
    if emit_rgba:
        top = params["layers"][-1]["matrix"]
        if spec.layers[-1].axis_aligned:
            wy, wx = warp_alpha_vectors(H, W, top)
            alpha = wy[:, None] * wx[None, :]
        else:
            alpha = rotate(torch.ones((4, H, W)), top)[3]
        assert torch.equal(rgba[3], alpha)
        assert torch.equal(K.v210_pack(rgba), out["packed"][0])


KEYED = [("rot", "y422", "rgba8"), ("diss", "y422", "rgba8"), ("rot", "y422", "y422", "rgba8")]


@pytest.mark.parametrize("out_format,emit_rgba", [("v210", True), ("rgba8", False)])
@pytest.mark.parametrize("kinds", KEYED)
def test_keyed_top_over_stragglers_keeps_its_alpha(kinds, out_format, emit_rgba):
    """The keyed rgba8 graphic on top of a stack with a straggler below (a
    rotation; a v210 DVE box, which the packed warp decodes) stays staged,
    whether an rgba-kind run composites the layers under it (coverage
    alpha) or none does: the emitted frame's alpha is the graphic's own
    warped alpha plane.  Against JAX's XLA path within 1 code (v210) or 1
    byte (rgba8 out, which writes alpha 255, rgba8.ts:94-97); the rgba
    emit within 2e-4, its alpha the graphic's warp to the bit."""
    spec, params = _port(kinds, emit_rgba, out_format)
    run = tpipe._packed_composite_run(spec, params)
    assert run is None or (run.end < len(kinds) and run.alpha == "coverage")
    out = tpipe.make_channel_program(spec)(params)
    want = jpipe.make_channel_program(_spec(kinds, False, emit_rgba, out_format))(
        _jax_params(_params(kinds), False))
    if out_format == "rgba8":
        (got,), (jwant,) = out, want
        assert tuple(got.shape) == (H, W, 4) and got.dtype == torch.uint8
        assert np.abs(got.numpy().astype(np.int64) - np.asarray(jwant).astype(np.int64)).max() <= 1
        return
    everywhere = np.ones((H, W), bool)
    assert _code_deltas(words_to_numpy(out["packed"][0]), np.asarray(want["packed"][0]), everywhere).max() <= 1
    assert np.abs(out["rgba"].numpy() - np.asarray(want["rgba"])).max() <= TOL_RGBA
    top = params["layers"][-1]
    graphic = tpipe.make_unpack_program("rgba8", W, H, "709", "709")(top["src"])
    assert torch.equal(out["rgba"][3], warp_plain(graphic, top["matrix"])[3])
