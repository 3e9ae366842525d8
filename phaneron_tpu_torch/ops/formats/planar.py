"""Shared implementation for planar and semi-planar YUV formats
(counterpart of phaneron_tpu/ops/formats/planar.py): yuv422p10le,
yuv422p8, yuv420p and nv12 differ only in sample dtype, chroma geometry
and plane layout.

Pitch is the width rounded up to 8 samples (yuv422p10.ts:222,
yuv420p.ts:252, nv12.ts:244); pitch padding packs as black (luma_black /
chroma null), as the write kernels' tail defaults do
(yuv422p10.ts:180-182, yuv420p.ts:207-209).  Code planes are int32
tensors; packed planes keep the format's sample dtype.
"""

from __future__ import annotations

import numpy as np
import torch

from .common import (
    FormatInfo,
    even_lines_even_pixels,
    even_pixels,
    pad_axis1,
    upsample_420,
    upsample_422,
)


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


# ---------------------------------------------------------------- 4:2:0


def unpack_420(planes, width: int, height: int):
    y_plane, u_plane, v_plane = planes
    n_chroma = (width + 1) // 2
    y = y_plane[:, :width].to(torch.int32)
    cb = upsample_420(u_plane[:, :n_chroma].to(torch.int32), width, height)
    cr = upsample_420(v_plane[:, :n_chroma].to(torch.int32), width, height)
    return y, cb, cr


def pack_420(info: FormatInfo, dtype: torch.dtype, y, cb, cr, width: int, height: int):
    p = pitch(width)
    cnull = chroma_null(info)
    yp = pad_axis1(y, p, info.luma_black).to(dtype)
    up = pad_axis1(even_lines_even_pixels(cb), p // 2, cnull).to(dtype)
    vp = pad_axis1(even_lines_even_pixels(cr), p // 2, cnull).to(dtype)
    return [yp, up, vp]


# ------------------------------------------------------------ black fills


def black_422(info: FormatInfo, np_dtype, width: int, height: int):
    """True-black planes: luma at luma_black, chroma at null (zeros would
    decode to a sub-black green excursion, blackSilence.ts)."""
    p = pitch(width)
    y = np.full((height, p), info.luma_black, dtype=np_dtype)
    c = np.full((height, p // 2), chroma_null(info), dtype=np_dtype)
    return [y, c, c.copy()]


def black_420(info: FormatInfo, np_dtype, width: int, height: int, interleaved: bool):
    p = pitch(width)
    h2 = (height + 1) // 2
    y = np.full((height, p), info.luma_black, dtype=np_dtype)
    if interleaved:
        return [y, np.full((h2, p), chroma_null(info), dtype=np_dtype)]
    c = np.full((h2, p // 2), chroma_null(info), dtype=np_dtype)
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


def fill_420(info: FormatInfo, np_dtype, width: int, height: int, interleaved: bool):
    """Reference fillBuf ramp for 4:2:0 (yuv420p.ts:255-289, nv12 variant):
    line pairs with an up-ramp on even lines and a counter-ramp on odd
    ones, constant null chroma, black padding."""
    p = pitch(width)
    black, cnull = info.luma_black, chroma_null(info)
    period = (234 - 16) // 2 + 1
    n_pairs = width // 2

    y = np.full((height, p), black, dtype=np_dtype)
    y0c, y1c = 0, 0  # pair counters of the two ramps
    for line in range(0, height, 2):
        idx = np.arange(n_pairs)
        y0 = 16 + 2 * ((y0c + idx) % period)
        y1 = 234 - 2 * ((y1c + idx) % period)
        y[line, 0 : 2 * n_pairs : 2] = y0
        y[line, 1 : 2 * n_pairs : 2] = y0 + 1
        if line + 1 < height:
            y[line + 1, 0 : 2 * n_pairs : 2] = y1 + 1
            y[line + 1, 1 : 2 * n_pairs : 2] = y1
        y0c += n_pairs
        y1c += n_pairs

    h2 = (height + 1) // 2
    if interleaved:
        return [y, np.full((h2, p), cnull, dtype=np_dtype)]
    u = np.full((h2, p // 2), cnull, dtype=np_dtype)
    v = np.full((h2, p // 2), cnull, dtype=np_dtype)
    return [y, u, v]
