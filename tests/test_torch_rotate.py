"""Port parity for the affine DVE (B14, ops/rotate.py ``rotate``), the
axis-aligned warp's wipe and distinct-matrix pair modes (B4, ops/warp.py
``warp``) and the wipe compositing ops (ops/composite.py) against
phaneron_tpu on the CPU at 256x64, the geometry of JAX's own rotate
tests (tests/test_pallas_rotate.py).

Contracts:
- ``rotate``'s plain version is ``warp_affine`` (then the dissolve mix or
  the wipe blend), the direct bilinear gather the Hopper kernel computes.
  It equals JAX's ``warp_affine`` and its XLA mix / ``wipe_mask`` to
  ``TOL_AFFINE``: the port divides x / W by a tensor and evaluates the
  texel position without contraction, as JAX's eager CPU ops do.
- JAX's rotate kernel (``make_rotate_program``, interpret mode) is a
  quarter turn and two shear passes that approximate that gather; it is
  held to JAX's own bounds (tests/test_pallas_rotate.py:50-73, 136-149):
  interior rms < 2e-3 and pointwise < 0.01 inside the eroded opaque
  region (JAX allows 0.03 past 45 degrees; the port holds 0.01), < 1e-3 on the far exterior, < 1e-4
  for an axis-aligned matrix.
- K4's wipe and distinct-matrix pairs equal JAX's XLA expressions
  (pipeline.py:466-476) bit for bit, and are within 5e-5 of the Pallas
  pair programs (the Pallas warp's bf16 hi/lo class against the gather,
  tests/test_pallas_warp.py:38; 1e-6 separates the Pallas pair from its
  own two single warps only).
- ``wipe_mask``, ``wipe_h`` and ``combine_masked`` equal JAX's bit for
  bit.
- ``affine_window``, the plain version of the rotate kernel's source
  window of an output tile, holds every valid tap of every pixel of the
  tile for any affine matrix (300 seeded draws), and its tensor form
  equals its form one tile at a time.
- The band form (a row-sharded channel): ``rotate_plain(..., rows=)``
  from the window graph/pipeline.py ``_warp_rows`` gives a band (the
  band's ``affine_window``) equals the full frame's rows bit for bit,
  NaN where it is NaN, in every mode; the band's window holds every valid
  tap of every band pixel (300 seeded draws); ``window_counts`` of a band
  equals the kernel's choice made one band tile at a time."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from phaneron_tpu.ops import composite as jcomp
from phaneron_tpu.ops.geometry import transform_matrix, warp_affine, warp_axis_aligned
from phaneron_tpu.ops.pallas_rotate import make_rotate_program, rot_bucket_of, rotate_fits
from phaneron_tpu.ops.pallas_warp import bucket_of, make_warp_pair_program, make_wipe_pair_program
from phaneron_tpu_torch.graph.pipeline import _warp_rows
from phaneron_tpu_torch.ops import composite as tcomp
from phaneron_tpu_torch.ops import geometry as tgeom
from phaneron_tpu_torch.ops.kernels import Rows
from phaneron_tpu_torch.ops.rotate import affine_window, rotate, rotate_plain
from phaneron_tpu_torch.ops.warp import warp, warp_plain

torch.set_num_threads(1)

W, H = 256, 64
ANGLES = (25, 100, -7)  # degrees; 100 is bench.py's one_rotation
TOL_AFFINE = 0.0
MODES = ("single", "dissolve", "wipe")


def _smooth(phase: float = 0.0) -> np.ndarray:
    """A smooth opaque RGBA frame (tests/test_pallas_rotate.py _smooth)."""
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    return np.stack([
        0.5 + 0.4 * np.sin(2 * np.pi * (x / W + 0.7 * y / H + phase)),
        0.5 + 0.3 * np.cos(2 * np.pi * (0.5 * x / W + 1.3 * y / H + phase)),
        0.25 + 0.5 * (x / W) * (y / H),
        np.ones((H, W), np.float32),
    ]).astype(np.float32)


def _frames(content: str, seed: int) -> tuple:
    """(a, b, mask): two (4, H, W) frames and an (H, W) wipe mask."""
    rng = np.random.default_rng(seed)
    if content == "smooth":
        y, x = np.mgrid[0:H, 0:W].astype(np.float32)
        mask = (0.5 + 0.5 * np.sin(2 * np.pi * (x / W - 0.3 * y / H))).astype(np.float32)
        return _smooth(), _smooth(0.37), mask
    a, b = (rng.random((4, H, W), dtype=np.float32) for _ in range(2))
    return a, b, rng.random((H, W), dtype=np.float32)


def _mats(angle: float) -> tuple:
    """The layer's matrix and a distinct one for src_b (another angle)."""
    m = transform_matrix(W, H, rotate=angle / 360.0, scale_x=0.9, scale_y=0.9)
    mb = transform_matrix(W, H, rotate=(angle + 30) / 360.0, scale_x=0.8, scale_y=0.85,
                          offset_x=0.05)
    return m.astype(np.float32), mb.astype(np.float32)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _jax_pair(mode: str, wa, wb, mix, mask):
    """JAX's XLA pair step after two warps (pipeline.py:466-476)."""
    if mode == "dissolve":
        return wa * mix + wb * (1.0 - mix)
    return jcomp.wipe_mask(wa, wb, jnp.asarray(mask)[None])


def _port_call(fn, mode: str, a, b, m, mb, mix, mask):
    """fn in ``mode``; ``mb`` None shares ``m``."""
    if mode == "single":
        return fn(_t(a), _t(m))
    mat_b = None if mb is None else _t(mb)
    if mode == "dissolve":
        return fn(_t(a), _t(m), _t(b), torch.tensor(mix), mat_b)
    return fn(_t(a), _t(m), _t(b), mat_b=mat_b, mask=_t(mask))


# ----------------------------------------------------------------- B14


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("content", ["smooth", "random"])
@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_plain_matches_jax_warp_affine(angle, content, mode):
    """rotate (its plain version on CPU tensors) against JAX's
    warp_affine, then the dissolve mix or the wipe blend, with two
    distinct matrices for a pair; CPU tensors launch nothing."""
    a, b, mask = _frames(content, 3 + len(mode))
    m, mb = _mats(angle)
    mix = np.float32(0.35)
    wa = warp_affine(jnp.asarray(a), jnp.asarray(m))
    want = wa if mode == "single" else _jax_pair(
        mode, wa, warp_affine(jnp.asarray(b), jnp.asarray(mb)), mix, mask)
    before = rotate.launches
    got = _port_call(rotate, mode, a, b, m, mb, mix, mask)
    assert rotate.launches == before
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, H, W)
    assert np.abs(got.numpy() - np.asarray(want)).max() <= TOL_AFFINE
    assert torch.equal(got, _port_call(rotate_plain, mode, a, b, m, mb, mix, mask))


def _erode(mask: np.ndarray, r: int) -> np.ndarray:
    out = mask.copy()
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            out &= np.roll(np.roll(mask, dy, 0), dx, 1)
    return out


def _jax_rotate(src: np.ndarray, m: np.ndarray) -> np.ndarray:
    code = rot_bucket_of(m, W, H)
    assert code >= 0 and rotate_fits(H, W, code)
    return np.asarray(make_rotate_program(H, W, code, interpret=True)(jnp.asarray(src), jnp.asarray(m)))


def _within_shear_bounds(got: np.ndarray, want: np.ndarray, alphas: list) -> None:
    """JAX's bounds for its shear rotation against the direct gather, on
    the [4:-4, 8:-8] crop: rms and pointwise inside the eroded region
    where every rotated source is opaque, near zero on the eroded region
    that no rotated source covers."""
    gi, wi = got[:, 4:-4, 8:-8], want[:, 4:-4, 8:-8]
    interior = _erode(np.minimum.reduce(alphas) > 0.999, 2)[4:-4, 8:-8]
    exterior = _erode(np.maximum.reduce(alphas) < 1e-3, 2)[4:-4, 8:-8]
    err = np.abs(gi - wi).max(axis=0)
    assert interior.any()
    assert float(np.sqrt(np.mean((gi - wi)[:, interior] ** 2))) < 2e-3
    assert float(err[interior].max()) < 0.01
    if exterior.any():
        assert float(err[exterior].max()) < 1e-3


@pytest.mark.parametrize("angle", ANGLES)
def test_rotate_within_jax_rotate_kernel_bounds(angle):
    """rotate against make_rotate_program (interpret), single and as the
    distinct-matrix dissolve that JAX's Pallas route runs as two rotate
    launches and an XLA mix (pipeline.py:445-468)."""
    a, b, _ = _frames("smooth", 0)
    m, mb = _mats(angle)
    got = rotate(_t(a), _t(m)).numpy()
    _within_shear_bounds(got, _jax_rotate(a, m), [got[3]])
    mix = np.float32(0.6)
    pair = rotate(_t(a), _t(m), _t(b), torch.tensor(mix), _t(mb)).numpy()
    want = _jax_rotate(a, m) * mix + _jax_rotate(b, mb) * (np.float32(1.0) - mix)
    alphas = [got[3], rotate(_t(b), _t(mb)).numpy()[3]]
    _within_shear_bounds(pair, want, alphas)


def test_rotate_axis_aligned_matrix_matches_jax_kernel_and_the_separable_warp():
    """An axis-aligned matrix: JAX's shear passes degenerate to the
    separable taps (< 1e-4, tests/test_pallas_rotate.py:50-56); the
    direct gather equals the separable warp up to lerp order (1e-6)."""
    a, _, _ = _frames("random", 9)
    m = transform_matrix(W, H, scale_x=0.9, scale_y=1.1, offset_x=0.03).astype(np.float32)
    got = rotate(_t(a), _t(m)).numpy()
    assert np.abs(got - _jax_rotate(a, m)).max() < 1e-4
    assert np.abs(got - warp(_t(a), _t(m)).numpy()).max() <= 1e-6


def _drawn_matrix(w, h, angle, sx, sy, shear, flip_h, flip_v, ox, oy) -> np.ndarray:
    """A DVE matrix (rotation, scale, flips, offsets) followed by a shear
    of the output coordinates, float32."""
    m = tgeom.transform_matrix(w, h, flip_h=flip_h, flip_v=flip_v, scale_x=sx, scale_y=sy,
                               offset_x=ox, offset_y=oy, rotate=angle / 360.0)
    return (m @ np.array([[1.0, shear, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])).astype(np.float32)


def _tile_taps(m: torch.Tensor, w: int, h: int, x_lo: int, x_hi: int, y_lo: int, y_hi: int) -> list:
    """(x, y) int64 tensors of the tile's four taps a pixel, each tap where
    it lies inside the frame, as warp_affine computes them."""
    ix = tgeom._out_coords(w, "cpu")[x_lo:x_hi + 1][None, :]
    iy = tgeom._out_coords(h, "cpu")[y_lo:y_hi + 1][:, None]
    x0, _ = tgeom._bilinear_setup(m[0, 0] * ix + m[0, 1] * iy + m[0, 2] + 0.5, w)
    y0, _ = tgeom._bilinear_setup(m[1, 0] * ix + m[1, 1] * iy + m[1, 2] + 0.5, h)
    taps = []
    for dy in (0, 1):
        for dx in (0, 1):
            x, y = x0 + dx, y0 + dy
            valid = (x >= 0) & (x < w) & (y >= 0) & (y < h)
            taps.append((x[valid], y[valid]))
    return taps


def test_affine_window_holds_every_valid_tap():
    """Taps are monotonic in x for fixed y and in y for fixed x, so the
    window of the tile's four corner pixels (floors and floors + 1,
    clipped to the frame) holds every valid tap of every pixel of the tile,
    under rotations, scales 0.1-4, shears, flips and offsets past the
    frame; a tile with a valid tap has a window that is not empty.  300
    seeded draws of frame size, matrix and tile."""
    rng = np.random.default_rng(20261017)
    for draw in range(300):
        w, h = int(rng.integers(1, 97)), int(rng.integers(1, 65))
        angle, shear = rng.uniform(-360.0, 360.0), rng.uniform(-2.0, 2.0)
        sx, sy = rng.uniform(0.1, 4.0, size=2)
        flip_h, flip_v = (bool(f) for f in rng.integers(0, 2, size=2))
        ox, oy = rng.uniform(-2.0, 2.0, size=2)
        m = torch.from_numpy(_drawn_matrix(w, h, angle, sx, sy, shear, flip_h, flip_v, ox, oy))
        x_lo, y_lo = int(rng.uniform() * (w - 1)), int(rng.uniform() * (h - 1))
        x_hi, y_hi = min(x_lo + int(rng.integers(1, 49)), w) - 1, min(y_lo + int(rng.integers(1, 33)), h) - 1
        x_first, x_last, y_first, y_last = (int(v) for v in affine_window(m, x_lo, x_hi, y_lo, y_hi, w, h))
        for x, y in _tile_taps(m, w, h, x_lo, x_hi, y_lo, y_hi):
            if x.numel():
                where = f"draw {draw}: {w}x{h}, tile x {x_lo}-{x_hi} y {y_lo}-{y_hi}"
                assert x_first <= int(x.min()) and int(x.max()) <= x_last, where
                assert y_first <= int(y.min()) and int(y.max()) <= y_last, where


@pytest.mark.parametrize("angle,scale", [(100, 0.9), (45, 0.25), (0, 2.0), (270, 0.9)])
def test_affine_window_of_tiles_in_a_tensor_equals_one_tile_at_a_time(angle, scale):
    """The tile bounds as tensors (one window a tile, as chip_smoke counts
    the kernel's window and direct tiles) give each tile's own window;
    the windows of the 32x16 tiles of a frame cover every valid tap."""
    w, h = 200, 72
    m = torch.from_numpy(_drawn_matrix(w, h, angle, scale, scale, 0.0, False, False, 0.1, -0.05))
    xl = torch.arange(0, w, 32)
    yl = torch.arange(0, h, 16)[:, None]
    xh, yh = torch.clamp(xl + 31, max=w - 1), torch.clamp(yl + 15, max=h - 1)
    wins = affine_window(m, xl, xh, yl, yh, w, h)
    assert all(tuple(v.shape) == (yl.numel(), xl.numel()) for v in wins)
    for j in range(yl.numel()):
        for i in range(xl.numel()):
            one = affine_window(m, int(xl[i]), int(xh[i]), int(yl[j]), int(yh[j, 0]), w, h)
            assert [int(v[j, i]) for v in wins] == [int(v) for v in one]
            for x, y in _tile_taps(m, w, h, int(xl[i]), int(xh[i]), int(yl[j]), int(yh[j, 0])):
                if x.numel():
                    assert int(one[0]) <= int(x.min()) and int(x.max()) <= int(one[1])
                    assert int(one[2]) <= int(y.min()) and int(y.max()) <= int(one[3])


def test_rotate_kernel_is_built_with_the_plain_sides_tile_and_window_sizes():
    """csrc/rotate.cu takes its tile and window sizes from the -D defines
    that ops/rotate.py makes of TILE_H, WINDOW_TEXELS and COPY_TEXELS, and
    the build passes them (nothing is compiled here)."""
    from phaneron_tpu_torch.ops import _build
    from phaneron_tpu_torch.ops import rotate as R

    defines = dict(f[2:].split("=") for f in _build.nvcc_flags() if f.startswith("-DPHN_ROTATE_"))
    assert defines == {"PHN_ROTATE_TILE_H": str(R.TILE_H[False]), "PHN_ROTATE_PAIR_TILE_H": str(R.TILE_H[True]),
                       "PHN_ROTATE_WINDOW_TEXELS": str(R.WINDOW_TEXELS[False]),
                       "PHN_ROTATE_PAIR_WINDOW_TEXELS": str(R.WINDOW_TEXELS[True]),
                       "PHN_ROTATE_COPY_TEXELS": str(R.COPY_TEXELS)}
    src = (_build.CSRC / "rotate.cu").read_text()
    for name in defines:
        assert f"= {name};" in src


@pytest.mark.parametrize("w,h,angle,scale,pair", [
    (200, 72, 100, 0.9, False), (200, 72, 100, 0.9, True), (201, 73, 45, 0.25, False),
    (64, 48, 0, 2.0, True), (96, 40, 270, 0.1, False),
])
def test_window_counts_equal_the_windows_of_each_tile(w, h, angle, scale, pair):
    """window_counts, the plain version of the kernel's choice between a
    tile's window and the direct gather, equals that choice made one tile
    at a time from affine_window and the pitch rule; every tile is
    counted once."""
    from phaneron_tpu_torch.ops import rotate as R

    m = torch.from_numpy(_drawn_matrix(w, h, angle, scale, scale, 0.0, False, False, 0.1, -0.05))
    th = R.TILE_H[pair]
    fits = direct = 0
    for y_lo in range(0, h, th):
        for x_lo in range(0, w, R.TILE_W):
            x0, x1, y0, y1 = (int(v) for v in affine_window(m, x_lo, min(x_lo + R.TILE_W, w) - 1, y_lo,
                                                            min(y_lo + th, h) - 1, w, h))
            if x0 > x1 or y0 > y1:
                texels = 0
            elif w % 2 == 0 and R.COPY_TEXELS == 2:
                cols = x1 + 1 - (x0 & ~1)
                cols += cols & 1
                texels = (y1 - y0 + 1) * (cols if cols % 4 == 2 else cols + 2)
            else:
                texels = (y1 - y0 + 1) * ((x1 - x0 + 1) | 1)
            fits += texels <= R.WINDOW_TEXELS[pair]
            direct += texels > R.WINDOW_TEXELS[pair]
    assert R.window_counts(m, w, h, pair) == [fits, direct]
    assert fits + direct == -(-w // R.TILE_W) * -(-h // th)


# ------------------------------------------------------ B14's band form

# matrices for the band sweeps: angles at and near 0, 45, 90, 100 and 180
# degrees; scales and offsets that put taps just outside the frame
BAND_MATS = [dict(rotate=d / 360.0, scale_x=s, scale_y=s) for d in (0, 0.3, 44.7, 45, 89.9, 90, 100, 180, -179.6)
             for s in (0.9, 2.0)] + [
    dict(rotate=0.25, offset_y=1.01), dict(rotate=0.25, offset_y=-1.49, scale_x=1.1),
    dict(rotate=100 / 360.0, offset_x=0.5, offset_y=0.52, scale_x=0.3, scale_y=0.3),
    dict(rotate=45 / 360.0, offset_y=1.2, scale_x=0.25, scale_y=0.25)]


def _band_frames(w: int, h: int, seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return (_t(rng.random((4, h, w), dtype=np.float32)), _t(rng.random((4, h, w), dtype=np.float32)),
            _t(rng.random((h, w), dtype=np.float32)))


def _same(got: torch.Tensor, want: torch.Tensor) -> bool:
    """Bit for bit, a NaN equal to a NaN."""
    return got.shape == want.shape and torch.allclose(got, want, rtol=0.0, atol=0.0, equal_nan=True)


@pytest.mark.parametrize("mode", ["single", "dissolve", "dissolve, two matrices", "wipe", "wipe, two matrices"])
@pytest.mark.parametrize("w,h", [(96, 64), (37, 27)])
def test_rotate_band_rows_equal_the_full_frame(mode, w, h):
    """rotate (its plain version) on each band of sp 2, 3, 4 and 8, its
    sources the window rows graph/pipeline.py _warp_rows gives (one window
    for both sources of a pair, the union over two matrices), equals those
    rows of the full-frame rotate bit for bit, under the BAND_MATS sweep
    and a matrix of scale 0 (non-finite: every pixel NaN, its window one
    row)."""
    a, b, mask = _band_frames(w, h, 40 + len(mode))
    mats = [tgeom.transform_matrix(w, h, **kw) for kw in BAND_MATS]
    inf = np.float32(np.inf)
    mats.append(np.array([[inf, -inf, 0.0], [inf, inf, 0.0], [0.0, 0.0, 1.0]], np.float32))  # scale 0
    mix = torch.tensor(0.35)
    for i, m in enumerate(mats):
        mb = mats[(i + 3) % len(mats)] if "two" in mode else None
        used = [m] + ([mb] if mb is not None else [])
        args = lambda sa, sb: (sa, _t(m)) if mode == "single" else (sa, _t(m), sb)
        kw = lambda mk: {} if mode == "single" else dict(
            mat_b=None if mb is None else _t(mb), **(dict(mask=mk) if mode.startswith("wipe") else dict(mix=mix)))
        full = rotate(*args(a, b), **kw(mask))
        for sp in (2, 3, 4, 8):
            bounds = [(h * k // sp, h * (k + 1) // sp) for k in range(sp)]
            for (r0, r1), (lo, hi) in zip(bounds, _warp_rows(used, bounds, w, h, rotated=True)):
                rows = Rows(r0, r1, h, lo)
                got = rotate(*args(a[:, lo:hi], b[:, lo:hi]), **kw(mask[r0:r1]), rows=rows)
                assert _same(got, full[:, r0:r1]), f"matrix {i} sp={sp} rows {r0}-{r1}, window {lo}-{hi}"
                plain = rotate_plain(*args(a[:, lo:hi], b[:, lo:hi]), **kw(mask[r0:r1]), rows=rows)
                assert _same(plain, got)
        if not np.isfinite(m).all():
            assert torch.isnan(full).all()
            assert _warp_rows(used[:1], [(5, 9)], w, h, rotated=True) == [(5, 6)]


def test_band_affine_window_holds_every_valid_tap():
    """A band of rows is a tile of the frame's width: affine_window of the
    band (columns [0, W-1], its rows), and the window _warp_rows gives it,
    hold every valid tap of every pixel of the band, under rotations,
    scales 0.1-4, shears, flips and offsets past the frame; a band with a
    valid tap has a window that is not empty.  300 seeded draws of frame
    size, matrix and band."""
    rng = np.random.default_rng(20261018)
    for draw in range(300):
        w, h = int(rng.integers(1, 97)), int(rng.integers(1, 65))
        angle, shear = rng.uniform(-360.0, 360.0), rng.uniform(-2.0, 2.0)
        sx, sy = rng.uniform(0.1, 4.0, size=2)
        flip_h, flip_v = (bool(f) for f in rng.integers(0, 2, size=2))
        ox, oy = rng.uniform(-2.0, 2.0, size=2)
        m = _drawn_matrix(w, h, angle, sx, sy, shear, flip_h, flip_v, ox, oy)
        r0 = int(rng.integers(0, h))
        r1 = min(h, r0 + int(rng.integers(1, h + 1)))
        x_first, x_last, y_first, y_last = (
            int(v) for v in affine_window(torch.from_numpy(m), 0, w - 1, r0, r1 - 1, w, h))
        (lo, hi), = _warp_rows([m], [(r0, r1)], w, h, rotated=True)
        assert 0 <= lo < hi <= h
        for x, y in _tile_taps(torch.from_numpy(m), w, h, 0, w - 1, r0, r1 - 1):
            if x.numel():
                where = f"draw {draw}: {w}x{h}, band rows {r0}-{r1}"
                assert x_first <= int(x.min()) and int(x.max()) <= x_last, where
                assert y_first <= int(y.min()) and int(y.max()) <= y_last, where
                assert (y_first, y_last + 1) == (lo, hi), where


@pytest.mark.parametrize("w,h,angle,scale,pair,sp", [
    (200, 72, 100, 0.9, False, 8), (200, 72, 100, 0.9, True, 3), (201, 73, 45, 0.25, False, 4),
    (64, 48, 0, 2.0, True, 2), (96, 40, 270, 0.1, False, 8),
])
def test_window_counts_of_a_band_equal_the_windows_of_each_tile(w, h, angle, scale, pair, sp):
    """window_counts with ``rows`` (a band, its sources the rows _warp_rows
    gives): the tiles start at the band's first row, the last is clipped
    to its last, each window's rows are clipped to the sources', and the
    choice equals the one made tile by tile from affine_window and the
    pitch rule; every band tile is counted once."""
    from phaneron_tpu_torch.ops import rotate as R

    m = _drawn_matrix(w, h, angle, scale, scale, 0.0, False, False, 0.1, -0.05)
    th = R.TILE_H[pair]
    bounds = [(h * k // sp, h * (k + 1) // sp) for k in range(sp)]
    for (r0, r1), (lo, hi) in zip(bounds, _warp_rows([m], bounds, w, h, rotated=True)):
        fits = direct = 0
        for y_lo in range(r0, r1, th):
            for x_lo in range(0, w, R.TILE_W):
                x0, x1, y0, y1 = (int(v) for v in affine_window(torch.from_numpy(m), x_lo, min(x_lo + R.TILE_W, w) - 1,
                                                                y_lo, min(y_lo + th, r1) - 1, w, h))
                y0, y1 = max(y0, lo), min(y1, hi - 1)
                if x0 > x1 or y0 > y1:
                    texels = 0
                elif w % 2 == 0 and R.COPY_TEXELS == 2:
                    cols = x1 + 1 - (x0 & ~1)
                    cols += cols & 1
                    texels = (y1 - y0 + 1) * (cols if cols % 4 == 2 else cols + 2)
                else:
                    texels = (y1 - y0 + 1) * ((x1 - x0 + 1) | 1)
                fits += texels <= R.WINDOW_TEXELS[pair]
                direct += texels > R.WINDOW_TEXELS[pair]
        assert R.window_counts(m, w, h, pair, Rows(r0, r1, h, lo), hi - lo) == [fits, direct]
        assert fits + direct == -(-w // R.TILE_W) * -(-(r1 - r0) // th)


def test_rotate_band_rows_are_checked():
    """A band outside the frame, or a source window that leaves it, raises
    before anything runs."""
    a, _, _ = _band_frames(32, 16, 1)
    m = _t(tgeom.transform_matrix(32, 16, rotate=0.1))
    with pytest.raises(ValueError, match="outside"):
        rotate(a[:, :8], m, rows=Rows(10, 20, 16, 0))
    with pytest.raises(ValueError, match="leaves"):
        rotate(a[:, :8], m, rows=Rows(0, 4, 16, 10))


# ------------------------------------------------------------------- B4


@pytest.mark.parametrize("mode,same_mat", [("wipe", True), ("wipe", False), ("dissolve", False)])
def test_warp_pair_modes_match_jax(mode, same_mat):
    """K4's wipe pair (one shared matrix or two) and distinct-matrix
    dissolve pair against JAX's XLA expressions over warp_axis_aligned,
    and against make_wipe_pair_program / make_warp_pair_program
    (same_mat=False) in interpret mode."""
    a, b, mask = _frames("random", 21 + same_mat)
    m = transform_matrix(W, H, scale_x=0.9, scale_y=0.8, offset_x=0.05).astype(np.float32)
    mb = m if same_mat else transform_matrix(W, H, scale_x=1.2, offset_y=-0.1).astype(np.float32)
    mix = np.float32(0.3)
    wa = warp_axis_aligned(jnp.asarray(a), jnp.asarray(m))
    wb = warp_axis_aligned(jnp.asarray(b), jnp.asarray(mb))
    xla = np.asarray(_jax_pair(mode, wa, wb, mix, mask))
    bucket = bucket_of(m, mb)
    if mode == "wipe":
        prog = make_wipe_pair_program(H, W, bucket, same_mat=same_mat, interpret=True)
        pallas = prog(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), jnp.asarray(mb), jnp.asarray(mask))
    else:
        prog = make_warp_pair_program(H, W, bucket, same_mat=False, interpret=True)
        pallas = prog(jnp.asarray(a), jnp.asarray(b), jnp.asarray(m), jnp.asarray(mb), jnp.float32(mix))
    before = warp.launches
    got = _port_call(warp, mode, a, b, m, None if same_mat else mb, mix, mask)
    assert warp.launches == before
    np.testing.assert_array_equal(got.numpy(), xla)
    assert np.abs(got.numpy() - np.asarray(pallas)).max() <= 5e-5
    assert torch.equal(got, _port_call(warp_plain, mode, a, b, m, None if same_mat else mb, mix, mask))


@pytest.mark.parametrize("fn", [warp, rotate])
def test_pair_argument_rules(fn):
    """A pair takes src_b and exactly one of mix (dissolve) or mask
    (wipe); mat_b, mix and mask need src_b; frames are (3|4, H, W)."""
    a, b, mask = (_t(x) for x in _frames("random", 5))
    m = _t(transform_matrix(W, H, scale_x=0.9))
    with pytest.raises(ValueError, match="either mix"):
        fn(a, m, b)
    with pytest.raises(ValueError, match="either mix"):
        fn(a, m, b, torch.tensor(0.5), mask=mask)
    with pytest.raises(ValueError, match="need src_b"):
        fn(a, m, mat_b=m)
    with pytest.raises(ValueError, match="expected"):
        fn(a[0], m)
    # a 3-channel frame warps its RGB planes alone
    assert torch.equal(fn(a[:3].contiguous(), m), fn(a, m)[:3])


# ---------------------------------------------------- A3 compositing ops


def test_wipe_mask_and_wipe_h_equal_jax():
    a, b, mask = _frames("random", 31)
    frame = np.stack([mask] * 4)
    np.testing.assert_array_equal(
        tcomp.wipe_mask(_t(a), _t(b), _t(frame)).numpy(),
        np.asarray(jcomp.wipe_mask(jnp.asarray(a), jnp.asarray(b), jnp.asarray(frame))),
    )
    for wipe in (0.0, 0.3, 0.71, 1.0):
        want = np.asarray(jcomp.wipe_h(jnp.asarray(a), jnp.asarray(b), jnp.float32(wipe)))
        np.testing.assert_array_equal(tcomp.wipe_h(_t(a), _t(b), wipe).numpy(), want)
        np.testing.assert_array_equal(tcomp.wipe_h(_t(a), _t(b), torch.tensor(wipe)).numpy(), want)


def test_combine_masked_equals_jax_and_combine_of_enabled_layers():
    rng = np.random.default_rng(37)
    layers = [rng.random((4, H, W), dtype=np.float32) for _ in range(4)]
    for enables in ((True, True, False, True), (True, False, False, False), (False,) * 4):
        en = np.array(enables)
        got = tcomp.combine_masked([_t(f) for f in layers], torch.from_numpy(en))
        want = jcomp.combine_masked([jnp.asarray(f) for f in layers], jnp.asarray(en))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        live = [layers[0]] + [f for f, e in zip(layers[1:], en[1:]) if e]
        assert torch.equal(got, tcomp.combine([_t(f) for f in live]))
