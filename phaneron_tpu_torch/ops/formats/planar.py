"""Shared implementation for planar YUV formats (counterpart of
phaneron_tpu/ops/formats/planar.py; its 4:2:2 half, the 4:2:0 half
comes with yuv420p/nv12, ROADMAP.md A2).

Pitch is the width rounded up to 8 samples (yuv422p10.ts:222); pitch
padding packs as black (luma_black / chroma null), as the write
kernels' tail defaults do (yuv422p10.ts:180-182).  Code planes are
int32 tensors; packed planes keep the format's sample dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import FormatInfo, even_pixels, pad_axis1, upsample_422


def pitch(width: int) -> int:
    return width + 7 - ((width - 1) % 8)


def chroma_null(info: FormatInfo) -> int:
    return 128 << (info.num_bits - 8)


# ---------------------------------------------------------------- 4:2:2


def unpack_422(planes, width: int, height: int):
    y_plane, u_plane, v_plane = planes
    n_chroma = (width + 1) // 2
    y = y_plane[:, :width].to(torch.int32)
    cb = upsample_422(u_plane[:, :n_chroma].to(torch.int32), width)
    cr = upsample_422(v_plane[:, :n_chroma].to(torch.int32), width)
    return y, cb, cr


def pack_422(info: FormatInfo, dtype: torch.dtype, y, cb, cr, width: int, height: int):
    p = pitch(width)
    cnull = chroma_null(info)
    yp = pad_axis1(y, p, info.luma_black).to(dtype)
    up = pad_axis1(even_pixels(cb), p // 2, cnull).to(dtype)
    vp = pad_axis1(even_pixels(cr), p // 2, cnull).to(dtype)
    return [yp, up, vp]


# ------------------------------------------------------------ black fills


def black_422(info: FormatInfo, np_dtype, width: int, height: int):
    """True-black planes: luma at luma_black, chroma at null (zeros would
    decode to a sub-black green excursion, blackSilence.ts)."""
    p = pitch(width)
    y = np.full((height, p), info.luma_black, dtype=np_dtype)
    c = np.full((height, p // 2), chroma_null(info), dtype=np_dtype)
    return [y, c, c.copy()]


# ------------------------------------------------------- test-ramp fills


def fill_422(info: FormatInfo, np_dtype, width: int, height: int):
    """Reference fillBuf ramp for 4:2:2 planar (yuv422p10.ts:225-255,
    yuv422p8 variant): luma pairs (Y, Y+1) stepping 2 per pair across
    lines, constant null chroma, black padding."""
    p = pitch(width)
    black, cnull = info.luma_black, chroma_null(info)
    # the ramp wraps after writing 938 (10-bit) / 234 (8-bit)
    wrap = 938 if info.num_bits == 10 else 234
    period = (wrap - black) // 2 + 1
    # the reference writes whole pixel pairs; for odd widths the final
    # pair spills one sample into the pitch padding, as it does there
    n_pairs = (width + 1) // 2

    y = np.full((height, p), black, dtype=np_dtype)
    u = np.full((height, p // 2), cnull, dtype=np_dtype)
    v = np.full((height, p // 2), cnull, dtype=np_dtype)

    counter = 0
    for line in range(height):
        starts = black + 2 * ((counter + np.arange(n_pairs)) % period)
        counter += n_pairs
        y[line, 0 : 2 * n_pairs : 2] = starts
        y[line, 1 : 2 * n_pairs : 2] = starts + 1
    return [y, u, v]
