"""Pixel formats of the plain reference: the code planes of v210,
yuv422p10le, yuv420p, nv12 and rgba8, and the packs of v210 and
yuv422p10le.

The layouts are the CasparCG / phaneron ones (v210.ts, yuv422p10.ts,
yuv420p.ts, nv12.ts, rgba8.ts): v210 packs 6 pixels in four 32-bit
words (carried as int32 bit patterns) on a 48-pixel pitch; the planar
formats sit on an 8-sample pitch, chroma held across a pixel pair (and a
row pair for 4:2:0) on read and taken from even pixels (and even rows)
on write; the pitch pad of a write is black luma and null chroma.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = ["INFO", "Info", "v210_pitch", "planar_pitch", "codes", "rgba8_codes", "pack_codes",
           "v210_fields", "plane_shapes"]


@dataclass(frozen=True)
class Info:
    bits: int
    black: int
    white: int
    chroma_range: int
    rgb: bool = False


INFO = {
    "v210": Info(10, 64, 940, 896),
    "yuv422p10le": Info(10, 64, 940, 896),
    "yuv420p": Info(8, 16, 235, 224),
    "nv12": Info(8, 16, 235, 224),
    "rgba8": Info(8, 16, 235, 224, rgb=True),
}


def v210_pitch(width: int) -> int:
    """Pixels a v210 line holds: the width rounded up to 48."""
    return width + 47 - ((width - 1) % 48)


def planar_pitch(width: int) -> int:
    """Samples a planar luma line holds: the width rounded up to 8."""
    return width + 7 - ((width - 1) % 8)


def plane_shapes(fmt: str, width: int, height: int) -> list:
    """[(shape, torch dtype)] of a frame's planes as the program carries them."""
    p, h2 = planar_pitch(width), (height + 1) // 2
    return {
        "v210": [((height, v210_pitch(width) * 8 // 3 // 4), torch.int32)],
        "yuv422p10le": [((height, p), torch.uint16), ((height, p // 2), torch.uint16),
                        ((height, p // 2), torch.uint16)],
        "yuv420p": [((height, p), torch.uint8), ((h2, p // 2), torch.uint8), ((h2, p // 2), torch.uint8)],
        "nv12": [((height, p), torch.uint8), ((h2, p), torch.uint8)],
        "rgba8": [((height, width, 4), torch.uint8)],
    }[fmt]


def _hold(c: torch.Tensor, width: int, height: int | None = None) -> torch.Tensor:
    c = torch.repeat_interleave(c, 2, dim=-1)[..., :width]
    if height is None:
        return c
    return torch.repeat_interleave(c, 2, dim=-2)[..., :height, :]


def v210_fields(words: torch.Tensor, width: int) -> tuple:
    """int32 words (H, G*4) -> (Y (H, W), Cb (H, (W+1)/2), Cr) int32 codes
    as stored, chroma not held."""
    h = words.shape[0]
    g = words.reshape(h, -1, 4)
    w0, w1, w2, w3 = g[..., 0], g[..., 1], g[..., 2], g[..., 3]
    m = 0x3FF
    y = torch.stack([w0 >> 10, w1, w1 >> 20, w2 >> 10, w3, w3 >> 20], dim=-1) & m
    cb = torch.stack([w0, w1 >> 10, w2 >> 20], dim=-1) & m
    cr = torch.stack([w0 >> 20, w2, w3 >> 10], dim=-1) & m
    n = (width + 1) // 2
    return y.reshape(h, -1)[:, :width], cb.reshape(h, -1)[:, :n], cr.reshape(h, -1)[:, :n]


def codes(fmt: str, planes, width: int, height: int) -> tuple:
    """A YCbCr frame's planes -> full-resolution (Y, Cb, Cr) int32 codes."""
    n = (width + 1) // 2
    if fmt == "v210":
        y, cb, cr = v210_fields(planes[0], width)
        return y, _hold(cb, width), _hold(cr, width)
    if fmt == "yuv422p10le":
        y, u, v = (p.to(torch.int32) for p in planes)
        return y[:, :width], _hold(u[:, :n], width), _hold(v[:, :n], width)
    if fmt == "yuv420p":
        y, u, v = (p.to(torch.int32) for p in planes)
        return y[:, :width], _hold(u[:, :n], width, height), _hold(v[:, :n], width, height)
    if fmt == "nv12":
        y, c = (p.to(torch.int32) for p in planes)
        return (y[:, :width], _hold(c[:, 0:2 * n:2], width, height),
                _hold(c[:, 1:2 * n:2], width, height))
    raise KeyError(fmt)


def rgba8_codes(planes) -> torch.Tensor:
    """(H, W, 4) bytes -> (4, H, W) int32 codes, R, G, B, A."""
    return planes[0].to(torch.int32).permute(2, 0, 1)


def _pad(x: torch.Tensor, target: int, value: int) -> torch.Tensor:
    pad = target - x.shape[-1]
    return F.pad(x, (0, pad), value=value) if pad > 0 else x


def pack_codes(fmt: str, y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor, width: int) -> list:
    """Full-resolution int32 codes -> the format's planes (chroma from even
    pixels)."""
    info = INFO[fmt]
    mask = (1 << info.bits) - 1
    y, cb, cr = y & mask, cb & mask, cr & mask
    if fmt == "yuv422p10le":
        p, null = planar_pitch(width), 128 << (info.bits - 8)
        return [_pad(y, p, info.black).to(torch.uint16), _pad(cb[:, 0::2], p // 2, null).to(torch.uint16),
                _pad(cr[:, 0::2], p // 2, null).to(torch.uint16)]
    if fmt == "v210":
        p, h = v210_pitch(width), y.shape[0]
        yg = _pad(y, p, 0).reshape(h, -1, 6)
        cbg = _pad(cb[:, 0::2], p // 2, 0).reshape(h, -1, 3)
        crg = _pad(cr[:, 0::2], p // 2, 0).reshape(h, -1, 3)
        w0 = (crg[..., 0] << 20) | (yg[..., 0] << 10) | cbg[..., 0]
        w1 = (yg[..., 2] << 20) | (cbg[..., 1] << 10) | yg[..., 1]
        w2 = (cbg[..., 2] << 20) | (yg[..., 3] << 10) | crg[..., 1]
        w3 = (yg[..., 5] << 20) | (crg[..., 2] << 10) | yg[..., 4]
        return [torch.stack([w0, w1, w2, w3], dim=-1).reshape(h, -1).to(torch.int32)]
    raise KeyError(fmt)
