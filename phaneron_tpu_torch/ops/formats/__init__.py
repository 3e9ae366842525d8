"""Pixel-format pack/unpack library (counterpart of
phaneron_tpu/ops/formats).  The port carries the formats of its first
slice; the rest stay in ROADMAP.md Queue A (A2)."""

from __future__ import annotations

from . import v210, yuv422p8

FORMATS = {
    "v210": v210,
    "yuv422p": yuv422p8,
    "yuv422p8": yuv422p8,
}


def get_format(name: str):
    if name not in FORMATS:
        raise KeyError(f"unsupported pixel format '{name}'")
    return FORMATS[name]
