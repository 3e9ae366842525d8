"""The packed warp kernel's source windows (B6, csrc/packed_warp.cu) and
the axis-aligned warp's plain version (K4, csrc/warp.cu) at the windows'
edges.

Contracts:
- ``axis_window`` (ops/packed_warp.py), the plain version of a kernel
  tile's source window, holds every valid tap of every pixel of the tile,
  as warp_axis_aligned computes the taps, and is empty only where the tile
  has no valid tap (the kernel then takes the source as +0): 300 seeded
  draws of frame size, matrix (flips, the media picture in picture at
  scale 0.5, offsets past the frame, scales 0.1-4) and tile.
- ``warp_window_counts``, the plain version of the kernel's choice
  between a tile's window and decoding each tap from the words, equals
  that choice made one tile at a time; the entry frame's pair never
  leaves the window, and a box at scale 0.25 reaches the direct branch.
  chip_smoke.py holds every launch's counts to it on the card.
- The kernel is built with the tile and window sizes this mirror reads
  (ops/_build.py nvcc_flags), and a CPU call with ``branches`` runs the
  plain version and launches nothing.
- K4's plain version at the windows' edges (flips, the picture in
  picture, offsets past the frame, a box at scale 0.25), single, dissolve
  and wipe pairs, equals JAX's XLA expressions over warp_axis_aligned bit
  for bit and is within 5e-5 of JAX's Pallas programs in interpret mode,
  as tests/test_torch_rotate.py::test_warp_pair_modes_match_jax holds the
  main matrices."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import composite as jcomp
from phaneron_tpu.ops.geometry import warp_axis_aligned
from phaneron_tpu.ops.pallas_warp import bucket_of, make_warp_pair_program, make_warp_program, make_wipe_pair_program
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.ops import geometry as tgeom
from phaneron_tpu_torch.ops import packed_warp as PW
from phaneron_tpu_torch.ops import warp as K4

torch.set_num_threads(1)

W, H = 256, 64
# the windows' edges: label -> transform_matrix keywords
EDGE = {
    "flip_hv": dict(flip_h=True, flip_v=True, scale_x=1.3, scale_y=0.8),
    "pip_0.5": dict(scale_x=0.5, scale_y=0.5, offset_x=0.2, offset_y=-0.15),  # the media channel's box
    "off_frame_part": dict(scale_x=0.7, scale_y=0.6, offset_x=0.45, offset_y=-0.4),
    "minify_0.25": dict(scale_x=0.25, scale_y=0.25, offset_x=0.1),
}


def _mat(w: int, h: int, **kw) -> torch.Tensor:
    return torch.from_numpy(tgeom.transform_matrix(w, h, **kw))


def _tile_taps(m: torch.Tensor, w: int, h: int, x_lo: int, x_hi: int, y_lo: int, y_hi: int) -> tuple:
    """(x taps, y taps): the int64 taps (floor and floor + 1) of the tile's
    columns and rows that lie inside the frame, as warp_axis_aligned
    computes them."""
    x0, _ = tgeom._bilinear_setup(m[0, 0] * tgeom._out_coords(w, "cpu")[x_lo:x_hi + 1] + m[0, 2] + 0.5, w)
    y0, _ = tgeom._bilinear_setup(m[1, 1] * tgeom._out_coords(h, "cpu")[y_lo:y_hi + 1] + m[1, 2] + 0.5, h)
    xs, ys = torch.cat([x0, x0 + 1]), torch.cat([y0, y0 + 1])
    return xs[(xs >= 0) & (xs < w)], ys[(ys >= 0) & (ys < h)]


def _drawn(rng, w: int, h: int, kind: int) -> torch.Tensor:
    """A seeded DVE matrix: the picture in picture (scale 0.5, any
    offset), flips, offsets past the frame, or any scale 0.1-4."""
    kw = dict(flip_h=bool(rng.integers(0, 2)), flip_v=bool(rng.integers(0, 2)))
    if kind == 0:
        kw.update(scale_x=0.5, scale_y=0.5, offset_x=rng.uniform(-0.3, 0.3), offset_y=rng.uniform(-0.3, 0.3))
    elif kind == 1:
        kw.update(scale_x=rng.uniform(0.7, 1.4), scale_y=rng.uniform(0.7, 1.4), flip_h=True)
    elif kind == 2:
        sign = rng.choice([-1.0, 1.0], size=2)
        kw.update(scale_x=rng.uniform(0.3, 2.0), scale_y=rng.uniform(0.3, 2.0),
                  offset_x=sign[0] * rng.uniform(0.6, 2.5), offset_y=sign[1] * rng.uniform(0.6, 2.5))
    else:
        kw.update(scale_x=rng.uniform(0.1, 4.0), scale_y=rng.uniform(0.1, 4.0),
                  offset_x=rng.uniform(-1.0, 1.0), offset_y=rng.uniform(-1.0, 1.0))
    return _mat(w, h, **kw)


def test_axis_window_holds_every_valid_tap():
    """Taps are monotonic in the output index along each axis, so the
    window of the tile's end columns and rows (floors and floors + 1,
    clipped to the frame) holds every valid tap of every pixel of the
    tile; an empty window means the tile has no valid tap.  300 seeded
    draws of frame size, matrix and tile (on B6's grid of tiles, and on
    one of 32 x 16, another kernel's shape)."""
    rng = np.random.default_rng(20261017)
    for draw in range(300):
        w, h = int(rng.integers(1, 400)), int(rng.integers(1, 160))
        m = _drawn(rng, w, h, draw % 4)
        tw, th = ((PW.WARP_TILE_W, PW.WARP_TILE_ROWS), (32, 16))[draw % 2]
        x_lo = int(rng.integers(0, -(-w // tw))) * tw
        y_lo = int(rng.integers(0, -(-h // th))) * th
        x_hi, y_hi = min(x_lo + tw, w) - 1, min(y_lo + th, h) - 1
        x0, x1, y0, y1 = (int(v) for v in PW.axis_window(m, x_lo, x_hi, y_lo, y_hi, w, h))
        xs, ys = _tile_taps(m, w, h, x_lo, x_hi, y_lo, y_hi)
        where = f"draw {draw}: {w}x{h}, tile x {x_lo}-{x_hi} y {y_lo}-{y_hi}"
        if xs.numel():
            assert x0 <= int(xs.min()) and int(xs.max()) <= x1, where
        if ys.numel():
            assert y0 <= int(ys.min()) and int(ys.max()) <= y1, where
        if x0 > x1:
            assert xs.numel() == 0, where
        if y0 > y1:
            assert ys.numel() == 0, where


@pytest.mark.parametrize("case", sorted(EDGE))
def test_axis_window_of_tiles_in_a_tensor_equals_one_tile_at_a_time(case):
    """The tile bounds as tensors (one window a tile, as the mirror counts
    the kernel's branches) give each tile's own window."""
    w, h = 200, 72
    m = _mat(w, h, **EDGE[case])
    xl = torch.arange(0, w, 32)
    yl = torch.arange(0, h, 16)[:, None]
    xh, yh = torch.clamp(xl + 31, max=w - 1), torch.clamp(yl + 15, max=h - 1)
    wins = [v.expand(yl.numel(), xl.numel()) for v in PW.axis_window(m, xl, xh, yl, yh, w, h)]
    for j in range(yl.numel()):
        for i in range(xl.numel()):
            one = PW.axis_window(m, int(xl[i]), int(xh[i]), int(yl[j]), int(yh[j, 0]), w, h)
            assert [int(v[j, i]) for v in wins] == [int(v) for v in one]


@pytest.mark.parametrize("w,h,case", [(200, 72, "flip_hv"), (201, 73, "pip_0.5"), (256, 64, "minify_0.25"),
                                      (96, 40, "off_frame_part"), (1918, 40, "pip_0.5")])
def test_window_counts_equal_the_windows_of_each_tile(w, h, case):
    """warp_window_counts, the plain version of B6's choice between a
    decoded window and decoding each tap from the words, equals that
    choice made one tile at a time from axis_window, whole 6-texel groups
    and the window texels; every tile is counted once."""
    tw, th, limit, align = PW.WARP_TILE_W, PW.WARP_TILE_ROWS, PW.WARP_WINDOW_TEXELS, 6
    m = _mat(w, h, **EDGE[case])
    fits = direct = 0
    for y_lo in range(0, h, th):
        for x_lo in range(0, w, tw):
            x0, x1, y0, y1 = (int(v) for v in PW.axis_window(m, x_lo, min(x_lo + tw, w) - 1, y_lo,
                                                             min(y_lo + th, h) - 1, w, h))
            texels = 0 if x0 > x1 or y0 > y1 else (y1 - y0 + 1) * (x1 // align - x0 // align + 1) * align
            fits += texels <= limit
            direct += texels > limit
    assert PW.warp_window_counts(m, w, h) == [fits, direct]
    assert fits + direct == -(-w // tw) * -(-h // th)


@pytest.mark.parametrize("w,h", [(1920, 1080), (3840, 2160)])
def test_main_path_shapes_stay_on_the_window(w, h):
    """The main path's B6 launches sample every tile from its window: the
    entry frame's pair as its scale animates from 0.90 to 1.0, alone and
    beside a second matrix at 0.8 x 0.85."""
    for t in np.linspace(0.0, 1.0, 5):
        s = 0.9 + 0.1 * t
        assert PW.warp_window_counts(_mat(w, h, scale_x=s, scale_y=s, offset_x=0.05 * (1.0 - t)), w, h)[1] == 0
    assert PW.warp_window_counts(_mat(w, h, scale_x=0.8, scale_y=0.85, offset_y=-0.05), w, h)[1] == 0


def test_minifying_boxes_reach_the_direct_branch():
    """A box at scale 0.25 reaches four times the tile along each axis:
    its windows exceed the kernel's limit, and those tiles decode each tap
    from the words (chip_smoke.py holds both branches to the plain
    version)."""
    m = _mat(1920, 1080, scale_x=0.25, scale_y=0.25, offset_x=0.1)
    assert PW.warp_window_counts(m, 1920, 1080)[1] > 0


def test_kernels_are_built_with_the_plain_sides_tile_and_window_sizes():
    """csrc/packed_warp.cu takes its tile rows and window size from the -D
    defines that ops/packed_warp.py makes of them, and the build passes
    them (nothing is compiled here)."""
    flags = _build.nvcc_flags()
    defines = dict(f[2:].split("=") for f in flags if f.startswith("-DPHN_PACKED_WARP_"))
    assert defines == {"PHN_PACKED_WARP_TILE_ROWS": str(PW.WARP_TILE_ROWS),
                       "PHN_PACKED_WARP_WINDOW_TEXELS": str(PW.WARP_WINDOW_TEXELS)}
    pw_src = (_build.CSRC / "packed_warp.cu").read_text()
    for name in defines:
        assert f"= {name};" in pw_src
    assert PW.WARP_TILE_W == 6 * 32  # phn::kPixelsPerBlock: 32 v210 groups


def test_cpu_calls_with_branches_run_the_plain_versions_and_launch_nothing():
    """On CPU tensors the packed warp runs its plain version whatever
    ``branches`` is, and leaves it as it was; the warp runs its plain
    version too."""
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.random((4, H, W), dtype=np.float32)) for _ in range(2))
    mask = torch.from_numpy(rng.random((H, W), dtype=np.float32))
    m = _mat(W, H, **EDGE["pip_0.5"])
    counts = torch.zeros(2, dtype=torch.int64)
    before = (K4.warp.launches, PW.packed_warp.launches)
    assert torch.equal(K4.warp(a, m, b, mask=mask), K4.warp_plain(a, m, b, mask=mask))
    words = torch.from_numpy(rng.integers(0, 2**32, size=(8, 192), dtype=np.uint32).view(np.int32))
    assert torch.equal(PW.packed_warp(words, m, 768, 8, words, 0.5, branches=counts),
                       PW.packed_warp_plain(words, m, 768, 8, words, 0.5))
    assert counts.tolist() == [0, 0]
    assert (K4.warp.launches, PW.packed_warp.launches) == before


def _frames(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    a, b = (rng.random((4, H, W), dtype=np.float32) for _ in range(2))
    return a, b, rng.random((H, W), dtype=np.float32)


@pytest.mark.parametrize("case", sorted(EDGE))
@pytest.mark.parametrize("mode,same_mat", [("single", True), ("dissolve", False), ("wipe", True)])
def test_warp_at_window_edges_matches_jax(case, mode, same_mat):
    """K4's plain version (a CPU call) at the windows' edges against JAX's
    XLA expressions over warp_axis_aligned (bit for bit) and JAX's Pallas
    warp, dissolve-pair and wipe-pair programs in interpret mode (5e-5, the
    Pallas warp's bf16 hi/lo class); a pair's second matrix, where it has
    one, is the first at 1.2 times its x scale."""
    a, b, mask = _frames(len(case) + len(mode))
    kw = EDGE[case]
    m = tgeom.transform_matrix(W, H, **kw)
    mb = m if same_mat else tgeom.transform_matrix(W, H, **dict(kw, scale_x=1.2 * kw.get("scale_x", 1.0)))
    mix = np.float32(0.3)
    wa = warp_axis_aligned(jnp.asarray(a), jnp.asarray(m))
    wb = warp_axis_aligned(jnp.asarray(b), jnp.asarray(mb))
    bucket = bucket_of(m, mb)
    if mode == "single":
        xla = np.asarray(wa)
        pallas = make_warp_program(H, W, bucket_of(m), interpret=True)(jnp.asarray(a), jnp.asarray(m))
        got = K4.warp(torch.from_numpy(a), torch.from_numpy(m))
    elif mode == "dissolve":
        xla = np.asarray(wa * mix + wb * (1.0 - mix))
        prog = make_warp_pair_program(H, W, bucket, same_mat=same_mat, interpret=True)
        pallas = prog(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), jnp.asarray(mb), jnp.float32(mix))
        got = K4.warp(torch.from_numpy(a), torch.from_numpy(m), torch.from_numpy(b), torch.tensor(mix),
                      None if same_mat else torch.from_numpy(mb))
    else:
        xla = np.asarray(jcomp.wipe_mask(wa, wb, jnp.asarray(mask)[None]))
        prog = make_wipe_pair_program(H, W, bucket, same_mat=same_mat, interpret=True)
        pallas = prog(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), jnp.asarray(mb), jnp.asarray(mask))
        got = K4.warp(torch.from_numpy(a), torch.from_numpy(m), torch.from_numpy(b),
                      mat_b=None if same_mat else torch.from_numpy(mb), mask=torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), xla)
    assert np.abs(got.numpy() - np.asarray(pallas)).max() <= 5e-5
