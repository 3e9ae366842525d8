"""Shared helpers for pixel-format modules (counterpart of
phaneron_tpu/ops/formats/common.py)."""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn.functional as F

__all__ = [
    "FormatInfo",
    "upsample_422",
    "upsample_420",
    "even_pixels",
    "even_lines_even_pixels",
    "pad_axis1",
]


@dataclass(frozen=True)
class FormatInfo:
    """Static format description (mirrors PackImpl fields, packer.ts:30-52)."""

    name: str
    num_bits: int
    luma_black: int
    luma_white: int
    chroma_range: int
    is_rgb: bool
    # chroma subsampling factors (x, y); (1, 1) for RGB formats
    sub_x: int = 1
    sub_y: int = 1


def upsample_422(c: torch.Tensor, width: int) -> torch.Tensor:
    """Chroma (H, Wc) -> (H, W) by horizontal sample-and-hold
    (the read kernels' per-pixel-pair chroma reuse, yuv422p10.ts:62-69)."""
    return torch.repeat_interleave(c, 2, dim=-1)[..., :width]


def upsample_420(c: torch.Tensor, width: int, height: int) -> torch.Tensor:
    """Chroma ((H+1)/2, Wc) -> (H, W): hold across the line pair and the
    pixel pair (yuv420p.ts:62-99 reads one chroma row per line pair)."""
    c = torch.repeat_interleave(c, 2, dim=-1)[..., :width]
    return torch.repeat_interleave(c, 2, dim=-2)[..., :height, :]


def even_pixels(c: torch.Tensor) -> torch.Tensor:
    """4:2:2 chroma downsample: chroma of even pixels, no filtering
    (yuv422p10.ts:169-170)."""
    return c[..., 0::2]


def even_lines_even_pixels(c: torch.Tensor) -> torch.Tensor:
    """4:2:0 chroma downsample: even lines, even pixels (yuv420p.ts:191-201
    writes chroma only for the first line of each pair)."""
    return c[..., 0::2, 0::2]


def pad_axis1(x: torch.Tensor, target: int, value: int | float = 0) -> torch.Tensor:
    """Pad the last axis up to ``target`` with a constant (pitch padding)."""
    pad = target - x.shape[-1]
    if pad <= 0:
        return x
    return F.pad(x, (0, pad), value=value)
