"""Geometric transforms: the 2-D DVE (anchor/fill/rotate/flip) and resize.

Counterpart of phaneron_tpu/ops/geometry.py.  The reference samples with
normalized coordinates, bilinear filtering and transparent-black borders
(transform.ts:26-59, resize.ts:24-60):

- the 3x3 homogeneous matrix is built on the host exactly as the
  reference does (transform.ts:119-175);
- output pixel (x, y) samples the input at texel coordinates
  ``(m @ (x/W - 0.5, y/H - 0.5, 1) + 0.5) * size - 0.5``, from the taps
  floor and floor+1 with weight frac; a tap outside the frame reads 0.

These are the plain tensor versions.  ``warp_axis_aligned`` is the
plain version of the CUDA warp kernel in ops/warp.py.  ``resize_frame``
(the stretch-fit of an off-geometry source) has no TPU kernel: JAX runs
it as two separable XLA passes, and so does the port, in torch ops.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "transform_matrix",
    "is_axis_aligned",
    "warp_affine",
    "warp_axis_aligned",
    "resize_frame",
    "fit_window",
    "fit_rows",
    "flip_vals",
]


# ----------------------------------------------------------- host-side


def transform_matrix(
    width: int,
    height: int,
    flip_h: bool = False,
    flip_v: bool = False,
    anchor_x: float = 0.0,
    anchor_y: float = 0.0,
    scale_x: float = 1.0,
    scale_y: float = 1.0,
    offset_x: float = 0.0,
    offset_y: float = 0.0,
    rotate: float = 0.0,
) -> np.ndarray:
    """Build the 3x3 output->input mapping matrix (transform.ts:119-175).

    ``rotate`` is in turns.  The matrix maps centred normalized output
    coords (x/w-0.5, y/h-0.5, 1) to centred normalized input coords.
    """
    aspect = width / height
    fx = -1.0 if flip_h else 1.0
    fy = -1.0 if flip_v else 1.0
    sx = scale_x * fx
    sy = scale_y * fy
    rot = rotate * 2.0 * math.pi

    anchor_in = np.array(
        [[1, 0, anchor_x], [0, 1, anchor_y], [0, 0, 1]], dtype=np.float64
    )
    scale_m = np.array(
        [[1.0 / (sx * aspect), 0, 0], [0, 1.0 / sy, 0], [0, 0, 1]], dtype=np.float64
    )
    rot_m = np.array(
        [
            [math.cos(rot), -math.sin(rot), 0],
            [math.sin(rot), math.cos(rot), 0],
            [0, 0, 1],
        ],
        dtype=np.float64,
    )
    translate = np.array(
        [[1, 0, offset_x * aspect], [0, 1, offset_y], [0, 0, 1]], dtype=np.float64
    )
    anchor_out = np.array(
        [[1, 0, -anchor_x * aspect], [0, 1, -anchor_y], [0, 0, 1]], dtype=np.float64
    )
    project = np.array([[aspect, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=np.float64)

    m = anchor_in @ scale_m @ rot_m @ translate @ anchor_out @ project
    return m.astype(np.float32)


def is_axis_aligned(mat: np.ndarray, eps: float = 1e-12) -> bool:
    """True when the warp has no rotation/shear term (separable path)."""
    return abs(float(mat[0, 1])) <= eps and abs(float(mat[1, 0])) <= eps


def flip_vals(flip_h: bool, flip_v: bool) -> np.ndarray:
    """The resize kernel's 4-float flip buffer (resize.ts:85-90)."""
    return np.array(
        [
            1.0 if flip_h else 0.0,
            -1.0 if flip_h else 1.0,
            1.0 if flip_v else 0.0,
            -1.0 if flip_v else 1.0,
        ],
        dtype=np.float32,
    )


# --------------------------------------------------------- tensor-side


def _bilinear_setup(pos: torch.Tensor, size: int):
    """Normalized coords -> (i0, frac) per OpenCL CLK_FILTER_LINEAR:
    u = pos*size - 0.5; texels floor(u), floor(u)+1 with weight frac."""
    u = pos * size - 0.5
    i0 = torch.floor(u)
    return i0.to(torch.int64), u - i0


def _gather2d(src: torch.Tensor, xi: torch.Tensor, yi: torch.Tensor, row0: int = 0) -> torch.Tensor:
    """Border-zero 2-D texel fetch from (C, H, W) at integer coords; ``src``
    may be a window of a frame's rows whose first is frame row ``row0``
    (a band form), and a row outside it reads 0."""
    h, w = src.shape[-2], src.shape[-1]
    valid = (xi >= 0) & (xi < w) & (yi >= row0) & (yi < row0 + h)
    idx = torch.clamp(yi - row0, 0, h - 1) * w + torch.clamp(xi, 0, w - 1)
    flat = src.reshape(src.shape[0], -1)
    vals = flat[:, idx.reshape(-1)].reshape(src.shape[0], *idx.shape)
    return vals * valid[None].to(src.dtype)


def _sample_bilinear(src: torch.Tensor, px: torch.Tensor, py: torch.Tensor, height: int | None = None,
                     row0: int = 0) -> torch.Tensor:
    """Bilinear samples of ``src`` at normalized (px, py), border zero;
    ``src`` may hold the rows of a ``height``-row frame from ``row0`` on."""
    h, w = src.shape[-2] if height is None else height, src.shape[-1]
    x0, fx = _bilinear_setup(px, w)
    y0, fy = _bilinear_setup(py, h)
    v00 = _gather2d(src, x0, y0, row0)
    v10 = _gather2d(src, x0 + 1, y0, row0)
    v01 = _gather2d(src, x0, y0 + 1, row0)
    v11 = _gather2d(src, x0 + 1, y0 + 1, row0)
    fx = fx[None]
    fy = fy[None]
    top = v00 * (1.0 - fx) + v10 * fx
    bot = v01 * (1.0 - fx) + v11 * fx
    return top * (1.0 - fy) + bot * fy


def _out_coords(size: int, device, lo: int = 0, hi: int | None = None) -> torch.Tensor:
    """x / size - 0.5 for x in [lo, hi) (default [0, size)).  The divisor is
    a tensor: PyTorch divides a CUDA tensor by a Python scalar as a
    multiply by its reciprocal, which is not the IEEE quotient the kernel
    and the JAX package use and moves texel positions by an ulp."""
    x = torch.arange(lo, size if hi is None else hi, dtype=torch.float32, device=device)
    return x / torch.full_like(x, float(size)) - 0.5


def warp_affine(src: torch.Tensor, mat: torch.Tensor, rows=None) -> torch.Tensor:
    """General DVE warp (transform.ts:36-59): output pixel (x, y) samples
    the input at mat @ (x/w-0.5, y/h-0.5, 1) + 0.5, bilinear, border 0.

    Band form (``rows``, ops/kernels.py Rows): ``src`` holds frame rows from
    ``rows.src_row0`` on (the rows the band's taps reach, ops/rotate.py
    affine_window of the band) and the result is output rows [rows.row0,
    rows.row1) of the ``rows.height``-row frame, sampled from the window
    alone in frame coordinates: each row equals that row of the full
    frame's warp."""
    w = src.shape[-1]
    row0, row1, h, src_row0 = (0, src.shape[-2], src.shape[-2], 0) if rows is None else rows
    ix = _out_coords(w, src.device)[None, :]
    iy = _out_coords(h, src.device, row0, row1)[:, None]
    px = mat[0, 0] * ix + mat[0, 1] * iy + mat[0, 2] + 0.5
    py = mat[1, 0] * ix + mat[1, 1] * iy + mat[1, 2] + 0.5
    n = row1 - row0
    return _sample_bilinear(src, px.expand(n, w), py.expand(n, w), h, src_row0)


def _interp_1d(src: torch.Tensor, pos: torch.Tensor, dim: int, size: int | None = None,
               offset: int = 0) -> torch.Tensor:
    """Bilinear interpolation along one dim: two gathers + lerp, border 0.
    ``src`` may be a window of a frame ``size`` texels long along ``dim``
    whose first texel is ``offset`` (a band form): taps are the frame's,
    and a tap indexes the window at its texel less ``offset``."""
    size = src.shape[dim] if size is None else size
    held = src.shape[dim]
    i0, frac = _bilinear_setup(pos, size)
    shape = [1] * src.ndim
    shape[dim] = -1

    def tap(idx):
        valid = ((idx >= 0) & (idx < size)).to(src.dtype).reshape(shape)
        local = torch.clamp(torch.clamp(idx, 0, size - 1) - offset, 0, held - 1)
        return torch.index_select(src, dim, local) * valid

    f = frac.reshape(shape)
    return tap(i0) * (1.0 - f) + tap(i0 + 1) * f


def warp_axis_aligned(src: torch.Tensor, mat: torch.Tensor, rows=None) -> torch.Tensor:
    """Axis-aligned warp (scale/translate/flip, mat[0,1] == mat[1,0] == 0)
    as separable row then column interpolation.  Same indices and
    weights as warp_affine.

    Band form (``rows``, ops/kernels.py Rows): ``src`` holds frame rows from
    ``rows.src_row0`` on (the rows the band's taps reach, ops/packed_warp.py
    axis_window) and the result is output rows [rows.row0, rows.row1) of
    the ``rows.height``-row frame, each equal to that row of the full
    frame's warp."""
    w = src.shape[-1]
    row0, row1, h, src_row0 = (0, src.shape[-2], src.shape[-2], 0) if rows is None else rows
    px = mat[0, 0] * _out_coords(w, src.device) + mat[0, 2] + 0.5  # (W,)
    py = mat[1, 1] * _out_coords(h, src.device, row0, row1) + mat[1, 2] + 0.5  # (rows,)
    out_rows = _interp_1d(src, py, dim=1, size=h, offset=src_row0)
    return _interp_1d(out_rows, px, dim=2)


def resize_frame(
    src: torch.Tensor,
    out_height: int,
    out_width: int,
    scale=1.0,
    offset_x=0.0,
    offset_y=0.0,
    flip=None,
) -> torch.Tensor:
    """Resize/scale/flip of a (C, H, W) frame (resize.ts:35-59): posIn =
    inPos * mul + off, mul and off from ``scale``, the offsets and the
    4-float ``flip`` buffer (``flip_vals``; default no flip).  The map is
    axis-aligned, so the sample runs as two separable passes, horizontal
    then vertical, border zero.  Every quotient divides by a tensor, as
    ``_out_coords`` does, so the result equals the JAX package's
    ``resize_frame`` to the bit."""
    dev = src.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    flip = f32(flip_vals(False, False) if flip is None else flip)
    scale, offset_x, offset_y = f32(scale), f32(offset_x), f32(offset_y)

    def coords(size: int) -> torch.Tensor:
        x = torch.arange(size, dtype=torch.float32, device=dev)
        return x / torch.full_like(x, float(size))

    centre_x = (-0.5 - offset_x) / scale + 0.5
    centre_y = (-0.5 - offset_y) / scale + 0.5
    off_x = centre_x * flip[1] + flip[0]
    off_y = centre_y * flip[3] + flip[2]
    px = coords(out_width) * (flip[1] / scale) + off_x  # (W_out,)
    py = coords(out_height) * (flip[3] / scale) + off_y  # (H_out,)
    cols = _interp_1d(src, px, dim=2)
    return _interp_1d(cols, py, dim=1)


def _fit_rows_pos(out_height: int, lo: int, hi: int, device) -> torch.Tensor:
    """The source positions of output rows [lo, hi) of the default stretch
    fit (``resize_frame`` with no scale, offset or flip), computed as it
    computes them: the centre, offset and flip terms on tensors, then
    y / out_height * (flip / scale) + off."""
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=device)
    flip = f32(flip_vals(False, False))
    scale, off = f32(1.0), f32(0.0)
    off_y = ((-0.5 - off) / scale + 0.5) * flip[3] + flip[2]
    y = torch.arange(out_height, dtype=torch.float32, device=device)[lo:hi]
    return y / torch.full_like(y, float(out_height)) * (flip[3] / scale) + off_y


def fit_window(out_height: int, src_height: int, lo: int, hi: int) -> tuple[int, int]:
    """[first, last + 1) of the source rows that output rows [lo, hi) of the
    default stretch fit read, clipped to the source (a band's window; at
    least one row)."""
    u = _fit_rows_pos(out_height, lo, hi, "cpu") * src_height - 0.5
    first = int(torch.floor(u.min()))
    last = int(torch.floor(u.max())) + 1
    first, last = max(first, 0), min(last, src_height - 1)
    if first > last:  # no tap inside the source: any one row
        first = last = min(max(lo, 0), src_height - 1)
    return first, last + 1


def fit_rows(src: torch.Tensor, src_row0: int, src_height: int, out_height: int, out_width: int,
             lo: int, hi: int) -> torch.Tensor:
    """Band form of the default stretch fit, ``resize_frame(frame,
    out_height, out_width)``: ``src`` holds the source frame's rows from
    ``src_row0`` on (``fit_window``), the result is output rows [lo, hi),
    each equal to that row of the full frame's fit."""
    dev = src.device
    f32 = lambda v: torch.as_tensor(v, dtype=torch.float32, device=dev)
    flip = f32(flip_vals(False, False))
    scale, off = f32(1.0), f32(0.0)
    off_x = ((-0.5 - off) / scale + 0.5) * flip[1] + flip[0]
    x = torch.arange(out_width, dtype=torch.float32, device=dev)
    px = x / torch.full_like(x, float(out_width)) * (flip[1] / scale) + off_x
    cols = _interp_1d(src, px, dim=2)
    return _interp_1d(cols, _fit_rows_pos(out_height, lo, hi, dev), dim=1, size=src_height, offset=src_row0)
