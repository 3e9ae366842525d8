"""Port parity for B16, the all-layers warp and combine over RGBA frames
that carry their own alpha: the packed composite with ``src_kind='rgba'``
(ops/packed_warp.py ``packed_composite``; csrc/packed_composite.cu kind
rgba) against phaneron_tpu's ``make_layers_combine_program`` (Pallas,
interpret mode on the CPU) and its XLA staged path (warp_axis_aligned ->
dissolve -> combine), and the file-media multi-box channel through
``make_channel_program`` against JAX's XLA path and its Pallas path with
``ENABLE_LAYERS_COMBINE`` on.

The multi-box channel (chip_smoke.py's multibox path without its 720p
clip, cut in size): four axis-aligned DVE layers, three boxes at scale
0.5 in three quadrants (top left a yuv422p10le clip, top right a yuv420p
clip dissolving to nv12, bottom left an nv12 clip) and the keyed rgba8
lower third under a title-safe DVE (scale 0.95, centred) on top.

Contracts: the kernel's plain version within 1e-4 of JAX's Pallas kernel
(its bf16 hi/lo products; JAX bounds the family at 4e-4,
tests/test_pallas_composite.py:78) and within 1e-6 of the XLA staged
path (expected 0); channel frames within 1 code, ``emit_rgba`` frames
within 2e-4 carrying the top layer's warped alpha."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.graph import pipeline as jpipe
from phaneron_tpu.ops.composite import combine, dissolve
from phaneron_tpu.ops.formats import get_format as jget_format
from phaneron_tpu.ops.geometry import transform_matrix, warp_axis_aligned
from phaneron_tpu.ops.pallas_warp import bucket_of, layers_combine_fits, make_layers_combine_program
from phaneron_tpu_torch.graph import pipeline as tpipe
from phaneron_tpu_torch.graph.convert import params_from_numpy, spec_from_fields, words_to_numpy
from phaneron_tpu_torch.ops import packed_warp as PW
from phaneron_tpu_torch.ops.warp import warp_plain
from torch_parity import graphic_rgba8, max_code_delta

torch.set_num_threads(1)

W, H = 256, 64
MATS = [transform_matrix(W, H, **kw) for kw in (
    dict(scale_x=0.9, scale_y=0.9, offset_x=0.02),
    dict(scale_x=0.5, scale_y=0.5, offset_x=-0.25, offset_y=0.25),
    dict(scale_x=1.3, flip_h=True),
)]
MIXES = [np.float32(0.35), np.float32(1.0), np.float32(0.6)]


def _rgba_frames(n: int, seed: int, w: int = W, h: int = H) -> list:
    """Seeded premultiplied RGBA frames: alpha in [0, 1], rgb <= alpha."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        a = rng.random((1, h, w), dtype=np.float32)
        out.append(np.concatenate([rng.random((3, h, w), dtype=np.float32) * a, a]))
    return out


def _case(layer_cfg):
    mats = MATS[:len(layer_cfg)]
    mixes = [MIXES[i] if n == 2 else None for i, n in enumerate(layer_cfg)]
    return _rgba_frames(sum(layer_cfg), seed=len(layer_cfg)), mats, mixes


def _staged_layers(srcs, layer_cfg, mats, mixes) -> list:
    """JAX's XLA staged layers: warp_axis_aligned, then dissolve."""
    it = iter(srcs)
    layers = []
    for n, mat, mix in zip(layer_cfg, mats, mixes):
        a = warp_axis_aligned(jnp.asarray(next(it)), jnp.asarray(mat))
        if n == 2:
            a = dissolve(a, warp_axis_aligned(jnp.asarray(next(it)), jnp.asarray(mat)), mix)
        layers.append(a)
    return layers


def _port(srcs, layer_cfg, mats, mixes, alpha):
    return PW.packed_composite_plain(
        [torch.from_numpy(s) for s in srcs], layer_cfg, [torch.from_numpy(m) for m in mats],
        [None if m is None else torch.tensor(m) for m in mixes], src_kind="rgba", emit="rgba", alpha=alpha,
    ).numpy()


@pytest.mark.parametrize("layer_cfg", [(2, 1, 2), (1, 1)])
def test_rgba_kind_top_alpha_matches_layers_combine_program(layer_cfg):
    """B16's counterpart: RGB and alpha within 1e-4 of the Pallas kernel,
    within 1e-6 of JAX's staged combine; the wrapper runs its plain
    version on CPU tensors and launches nothing."""
    srcs, mats, mixes = _case(layer_cfg)
    before = PW.packed_composite.launches
    got = _port(srcs, layer_cfg, mats, mixes, "top")
    wrapped = PW.packed_composite(
        [torch.from_numpy(s) for s in srcs], layer_cfg, [torch.from_numpy(m) for m in mats],
        [None if m is None else torch.tensor(m) for m in mixes], src_kind="rgba", emit="rgba", alpha="top",
    )
    assert PW.packed_composite.launches == before and np.array_equal(wrapped.numpy(), got)
    bucket = max(bucket_of(m) for m in mats)
    assert layers_combine_fits(H, W, bucket, layer_cfg)
    prog = make_layers_combine_program(H, W, bucket, layer_cfg, interpret=True)
    want = np.asarray(prog([jnp.asarray(s) for s in srcs], jnp.stack([jnp.asarray(m) for m in mats]),
                           jnp.asarray([1.0 if m is None else m for m in mixes], jnp.float32)))
    assert got.shape == want.shape == (4, H, W)
    assert np.abs(got - want).max() <= 1e-4
    staged = np.asarray(combine([jnp.zeros((4, H, W), jnp.float32)] + _staged_layers(srcs, layer_cfg, mats, mixes)))
    assert np.abs(got - staged).max() <= 1e-6


@pytest.mark.parametrize("layer_cfg", [(2, 1, 2), (1, 1)])
def test_rgba_kind_coverage_alpha_matches_the_staged_combine(layer_cfg):
    """The coverage mode (a run that spans part of the stack): RGB as the
    staged combine, alpha the 'over'-accumulated 1 - prod(1 - a_m) of the
    staged layers' alpha planes; 'packed' and 'both' emit the pack of that
    RGB."""
    srcs, mats, mixes = _case(layer_cfg)
    got = _port(srcs, layer_cfg, mats, mixes, "coverage")
    layers = [np.asarray(f) for f in _staged_layers(srcs, layer_cfg, mats, mixes)]
    staged = np.asarray(combine([jnp.zeros((4, H, W), jnp.float32)] + [jnp.asarray(f) for f in layers]))
    cover = layers[0][3]
    for f in layers[1:]:
        cover = cover * (1.0 - f[3]) + f[3]
    assert np.abs(got[:3] - staged[:3]).max() <= 1e-6
    assert np.abs(got[3] - cover).max() <= 1e-6
    args = ([torch.from_numpy(s) for s in srcs], layer_cfg, [torch.from_numpy(m) for m in mats],
            [None if m is None else torch.tensor(m) for m in mixes])
    words = PW.packed_composite(*args, src_kind="rgba")
    both = PW.packed_composite(*args, src_kind="rgba", emit="both")
    assert torch.equal(both[0], words) and np.array_equal(both[1].numpy(), got)
    with pytest.raises(ValueError, match="expected"):
        PW.packed_composite([torch.from_numpy(s[:3]) for s in srcs], *args[1:], src_kind="rgba")
    with pytest.raises(ValueError, match="alpha"):
        PW.packed_composite(*args, src_kind="rgba", alpha="max")


# ------------------------------------------------------- channel frames

MW, MH = 256, 16
QUADRANTS = {  # transform_matrix moves a box against the sign of its offset
    "top_left": dict(offset_x=0.25, offset_y=0.25),
    "top_right": dict(offset_x=-0.25, offset_y=0.25),
    "bottom_left": dict(offset_x=0.25, offset_y=-0.25),
}


def _quadrant(name: str) -> np.ndarray:
    return transform_matrix(MW, MH, scale_x=0.5, scale_y=0.5, **QUADRANTS[name])


def _planes(fmt: str, rng) -> list:
    hi = 1024 if fmt == "yuv422p10le" else 256
    return [rng.integers(0, hi, size=s, dtype=dt) for s, dt in jget_format(fmt).plane_shapes(MW, MH)]


def multibox(out_format: str, emit_rgba: bool, pallas: bool, mix: float = 0.4):
    """(JAX spec, numpy params) of the multi-box channel at MW x MH."""
    rng = np.random.default_rng(7)
    mats = [_quadrant("top_left"), _quadrant("top_right"), _quadrant("bottom_left"),
            transform_matrix(MW, MH, scale_x=0.95, scale_y=0.95)]
    dve = lambda fmt, m, **kw: jpipe.LayerSpec(fmt, has_transform=True, axis_aligned=True,
                                               warp_bucket=bucket_of(m) if pallas else -1, **kw)
    spec = jpipe.ChannelSpec(MW, MH, out_format, layers=(
        dve("yuv422p10le", mats[0]),
        dve("yuv420p", mats[1], transition="dissolve", src_b_format="nv12"),
        dve("nv12", mats[2]),
        dve("rgba8", mats[3]),
    ), emit_rgba=emit_rgba, pallas_stages=pallas)
    params = {"layers": [
        {"src": _planes("yuv422p10le", rng), "matrix": mats[0]},
        {"src": jget_format("yuv420p").fill_buf(MW, MH), "src_b": _planes("nv12", rng), "matrix": mats[1],
         "mix": np.float32(mix)},
        {"src": _planes("nv12", rng), "matrix": mats[2]},
        {"src": [graphic_rgba8(MW, MH)], "matrix": mats[3]},
    ]}
    return spec, params


def _jax(params):
    return {"layers": [
        {k: ([jnp.asarray(p) for p in v] if isinstance(v, list) else jnp.asarray(v)) for k, v in lp.items()}
        for lp in params["layers"]
    ]}


def _delta(fmt: str, got, want) -> int:
    if fmt == "v210":
        return max_code_delta(words_to_numpy(got[0]), np.asarray(want[0]), MW, MH)
    return max(int(np.abs(g.numpy().astype(np.int64) - np.asarray(x).astype(np.int64)).max())
               for g, x in zip(got, want))


def test_multibox_boxes_land_in_their_quadrants():
    """transform_matrix's sign convention: each box's warped alpha covers
    its own quadrant (1 inside its feather band) and is 0 in the others;
    the graphic takes the fourth."""
    ones = torch.ones((1, MH, MW))
    halves = {"top": slice(1, MH // 2 - 1), "bottom": slice(MH // 2 + 1, MH - 1),
              "left": slice(1, MW // 2 - 1), "right": slice(MW // 2 + 1, MW - 1)}
    quadrants = ("top_left", "top_right", "bottom_left", "bottom_right")
    for name in QUADRANTS:
        a = warp_plain(ones, torch.from_numpy(_quadrant(name)))[0].numpy()
        for q in quadrants:  # each quadrant less its one-pixel feather band
            inner = a[tuple(halves[p] for p in q.split("_"))]
            assert inner.min() == 1.0 if q == name else inner.max() == 0.0, (name, q)


@pytest.mark.parametrize("out_format,emit_rgba", [("v210", True), ("yuv422p10le", False)])
def test_multibox_frame_matches_both_jax_paths(out_format, emit_rgba, monkeypatch):
    """The whole stack is one rgba-kind run with the top layer's alpha (a
    'both' launch into v210 under emit_rgba, an 'rgba' launch packed by
    B11 into yuv422p10le): within 1 code of JAX's XLA path and of its
    Pallas path, where make_layers_combine_program composites the stack;
    the emit_rgba frame within 2e-4 of both and its alpha the graphic's
    warped alpha."""
    monkeypatch.setattr(jpipe, "ENABLE_LAYERS_COMBINE", True)
    spec, params = multibox(out_format, emit_rgba, pallas=False)
    tspec = spec_from_fields(spec._asdict())
    tparams = params_from_numpy(params, "cpu")
    run = tpipe._packed_composite_run(tspec, tparams)
    assert run == (0, 4, "both" if emit_rgba else "rgba", "rgba", "top")
    out = tpipe.make_channel_program(tspec)(tparams)
    got = out["packed"] if emit_rgba else out
    for pallas in (False, True):
        jspec, _ = multibox(out_format, emit_rgba, pallas)
        assert jpipe._layers_combine_ok(jspec) == pallas
        want = jpipe.make_channel_program(jspec)(_jax(params))
        assert _delta(out_format, got, want["packed"] if emit_rgba else want) <= 1
        if emit_rgba:
            assert np.abs(out["rgba"].numpy() - np.asarray(want["rgba"])).max() <= 2e-4
    if emit_rgba:
        top = tparams["layers"][3]
        graphic = tpipe.make_unpack_program("rgba8", MW, MH, "709", "709")(top["src"])
        assert torch.equal(out["rgba"][3], warp_plain(graphic, top["matrix"])[3])
