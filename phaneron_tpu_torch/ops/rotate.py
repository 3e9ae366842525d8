"""The general affine DVE warp kernel (MIXER ROTATION at any angle).

Counterpart of phaneron_tpu/ops/pallas_rotate.py (``make_rotate_program``
and its ``_make_pass``).  The TPU kernel approximates the direct bilinear
gather by a quarter turn and two shear passes, because Mosaic has no
gather; it differs from the gather at content step edges.  The CUDA
kernel (csrc/rotate.cu) computes the gather itself, ops/geometry.py
``warp_affine``, for any matrix, so the TPU's rotation codes
(``rot_bucket``, ``rot_bucket_b``) are not read.

``rotate`` has the modes and the C interface of the axis-aligned warp
(ops/warp.py): a single source, a dissolve pair and a wipe pair, each
pair under one shared matrix or two, for (C, H, W) float32 frames with
C = 3 or 4.  It launches the kernel for CUDA tensors and runs
``rotate_plain`` (warp_affine, then mix_frames or wipe_mask) for CPU
tensors; ``rotate.launches`` counts kernel launches.

Band form (``rows``, ops/kernels.py Rows; a row-sharded channel,
parallel/bands.py): the sources are windows of the rows the band's taps
reach (``affine_window`` of the band as one tile) and the result is the
band's output rows, each equal to that row of the full-frame rotate;
``rotate_plain`` computes from the windows alone.

The kernel samples each output tile from a shared-memory window of the
source texels its taps reach; ``affine_window`` is the plain version of
that window and ``window_counts`` of the kernel's choice between a
window and the direct gather.  The tile and window sizes live here
(TILE_H, WINDOW_TEXELS, COPY_TEXELS): ops/_build.py passes them to nvcc
as -D defines (``nvcc_defines``), so the kernel and its plain version
read the same values.
"""

from __future__ import annotations

import torch

from .geometry import warp_affine
from .kernels import Rows, check_arg, is_cpu, launched
from .warp import launch_pair, mix_pair, pair_args

__all__ = ["rotate", "rotate_plain", "affine_window", "window_counts", "nvcc_defines"]

# csrc/rotate.cu's output tiles are TILE_W columns (a warp's row) by
# TILE_H[pair] rows, a single warp's (False) or a pair's (True), whose
# tiles hold two windows; a window fits in shared memory when its rows
# times its row pitch are at most WINDOW_TEXELS[pair]; where frame rows
# have an even width, a copy moves COPY_TEXELS texels (2: 8-byte cp.async)
TILE_W = 32
TILE_H = {False: 24, True: 16}
WINDOW_TEXELS = {False: 2048, True: 1536}
COPY_TEXELS = 2


def nvcc_defines() -> tuple:
    """The constants above as the -D flags csrc/rotate.cu is built with."""
    return (f"-DPHN_ROTATE_TILE_H={TILE_H[False]}", f"-DPHN_ROTATE_PAIR_TILE_H={TILE_H[True]}",
            f"-DPHN_ROTATE_WINDOW_TEXELS={WINDOW_TEXELS[False]}",
            f"-DPHN_ROTATE_PAIR_WINDOW_TEXELS={WINDOW_TEXELS[True]}",
            f"-DPHN_ROTATE_COPY_TEXELS={COPY_TEXELS}")


def affine_window(mat, x_lo, x_hi, y_lo, y_hi, width: int, height: int) -> tuple:
    """The source window of the output tile of columns [x_lo, x_hi] by rows
    [y_lo, y_hi] under the affine matrix ``mat`` (3, 3) (csrc/rotate.cu
    tile_window): (x_first, x_last, y_first, y_last) as int64 tensors, the
    texels the taps of the tile's four corner pixels span, floors and
    floors + 1, clipped to the frame; empty where first > last.  The tile
    bounds may be tensors (one tile each, broadcast together).

    Each tap floor is computed in float32 torch ops in the kernel's order
    (affine_taps, and ops/geometry.py warp_affine and _bilinear_setup), and
    every step rounds monotonically in x for fixed y and in y for fixed x,
    so the corners bound every floor of the tile: the window holds every
    valid tap of every pixel in it (tests/test_torch_rotate.py).  A band
    of rows is a tile of the frame's width.  The clamp of a floor ignores
    NaN, as the kernel's fmaxf and fminf do."""
    mat = torch.as_tensor(mat, dtype=torch.float32)
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=mat.device)
    fw, fh = f32(float(width)), f32(float(height))

    def floors(x, y):
        ix = f32(x) / fw - 0.5
        iy = f32(y) / fh - 0.5
        px = mat[0, 0] * ix + mat[0, 1] * iy + mat[0, 2] + 0.5
        py = mat[1, 0] * ix + mat[1, 1] * iy + mat[1, 2] + 0.5
        u = torch.floor(px * fw - 0.5)
        v = torch.floor(py * fh - 0.5)
        lo = f32(-2.0)
        return torch.fmin(torch.fmax(u, lo), fw), torch.fmin(torch.fmax(v, lo), fh)

    corners = [floors(x, y) for x in (x_lo, x_hi) for y in (y_lo, y_hi)]
    us = torch.stack(torch.broadcast_tensors(*(u for u, _ in corners)))
    vs = torch.stack(torch.broadcast_tensors(*(v for _, v in corners)))
    first = lambda f: torch.clamp(f.amin(0), min=0.0).to(torch.int64)
    last = lambda f, size: torch.clamp(f.amax(0) + 1.0, max=float(size - 1)).to(torch.int64)
    return first(us), last(us, width), first(vs), last(vs, height)


def window_counts(mat, width: int, height: int, pair: bool, rows: Rows | None = None,
                  src_rows: int | None = None) -> list:
    """[window, direct]: the tiles in which the rotate kernel samples one
    source under ``mat`` from a shared-memory window and straight from
    the frame, for a single warp or (``pair``) each source of a pair.  A
    tile's window (``affine_window``) fits when its rows times its row
    pitch are at most WINDOW_TEXELS[pair], as csrc/rotate.cu tile_window
    decides: the pitch is cols | 1 (odd); or, where the frame width is
    even and copies move texel pairs, the columns from an even start to
    an even end, plus 2 where that is a multiple of 4.  An empty window
    fits.  With ``rows`` (a band form, its sources ``src_rows`` rows from
    ``rows.src_row0``) the tiles start at the band's first row, the last
    is clipped to its last, and each window's rows to the sources'."""
    mat = torch.as_tensor(mat, dtype=torch.float32)
    th = TILE_H[pair]
    row0, row1 = (0, height) if rows is None else (rows.row0, rows.row1)
    xl = torch.arange(0, width, TILE_W, device=mat.device)
    yl = torch.arange(row0, row1, th, device=mat.device)[:, None]
    x0, x1, y0, y1 = affine_window(mat, xl, torch.clamp(xl + TILE_W - 1, max=width - 1), yl,
                                   torch.clamp(yl + th - 1, max=row1 - 1), width, height)
    if rows is not None:
        y0 = torch.clamp(y0, min=rows.src_row0)
        y1 = torch.clamp(y1, max=rows.src_row0 + src_rows - 1)
    if COPY_TEXELS == 2 and width % 2 == 0:
        cols = (x1 + 2 - (x0 - x0 % 2)) // 2 * 2
        pitch = torch.where(cols % 4 == 2, cols, cols + 2)
    else:
        pitch = (x1 - x0 + 1) | 1
    texels = torch.where((x0 > x1) | (y0 > y1), 0, (y1 - y0 + 1) * pitch)
    fits = int((texels <= WINDOW_TEXELS[pair]).sum())
    return [fits, texels.numel() - fits]


def rotate_plain(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
    mat_b: torch.Tensor | None = None, mask: torch.Tensor | None = None,
    rows: Rows | None = None,
) -> torch.Tensor:
    """Plain version of rotate: warp_affine(src), or the pair step
    (ops/warp.py mix_pair) over warp_affine(src, mat) and
    warp_affine(src_b, mat_b); a band form with ``rows``."""
    out = warp_affine(src, mat, rows)
    if src_b is None:
        return out
    return mix_pair(out, warp_affine(src_b, mat if mat_b is None else mat_b, rows), mix, mask)


def rotate(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
    mat_b: torch.Tensor | None = None, mask: torch.Tensor | None = None,
    branches: torch.Tensor | None = None, rows: Rows | None = None,
) -> torch.Tensor:
    """Affine bilinear DVE warp of a (C, H, W) float32 frame, C = 3 or 4,
    by the (3, 3) matrix ``mat`` (the top two rows are read), border
    zero.  With ``src_b``, under ``mat_b`` (default: ``mat``): the
    dissolve pair warp(src)*mix + warp(src_b)*(1-mix), or with an (H, W)
    float32 ``mask`` in place of ``mix`` the wipe pair
    warp(src_b)*m + warp(src)*(1-m).

    ``branches``, a (2,) int64 tensor on the sources' device, gets the
    (tile, source) pairs the kernel sampled from a shared-memory window
    and straight from device memory added: [window, direct] (a
    measurement hook, read by chip_smoke.py).

    Band form: with ``rows`` (ops/kernels.py Rows) ``src`` and ``src_b``
    hold frame rows from ``rows.src_row0`` on (each row contiguous, the
    planes any stride apart: a view of a taller frame), ``mask`` is the
    band's (rows, W), and the result is (C, rows, W), output rows
    [rows.row0, rows.row1) of the ``rows.height``-row frame.  The windows
    must hold every valid tap of the band (``affine_window`` of the band):
    a tap row outside them reads 0."""
    pair_args("rotate", src, src_b, mix, mat_b, mask)
    if rows is not None:
        rows.check("rotate", src.shape[1])
    if is_cpu(src, "rotate"):
        return rotate_plain(src, mat, src_b, mix, mat_b, mask, rows)
    if branches is not None:
        check_arg(branches, "rotate branches", src.device, torch.int64, (2,), align=8)
    out = launch_pair("rotate", "phn_rotate", src, mat, src_b, mix, mat_b, mask,
                      Rows.full(src.shape[1]) if rows is None else rows,
                      extra=(None if branches is None else branches.data_ptr(),))
    launched(rotate)
    return out


rotate.launches = 0
