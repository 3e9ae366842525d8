"""Pixel-format pack/unpack library (counterpart of
phaneron_tpu/ops/formats): one module per reference kernel pair
(src/process/{v210,yuv422p10,yuv422p8,yuv420p,nv12,rgba8,bgra8}.ts).
The registry maps a format name, aliases included, to its module."""

from __future__ import annotations

from . import bgra8, nv12, rgba8, v210, yuv420p, yuv422p8, yuv422p10

FORMATS = {
    "v210": v210,
    "yuv422p10le": yuv422p10,
    "yuv422p10": yuv422p10,
    "yuv422p": yuv422p8,
    "yuv422p8": yuv422p8,
    "yuv420p": yuv420p,
    "nv12": nv12,
    "rgba8": rgba8,
    "rgba": rgba8,
    "bgra8": bgra8,
    "bgra": bgra8,
}


def get_format(name: str):
    if name not in FORMATS:
        raise KeyError(f"unsupported pixel format '{name}'")
    return FORMATS[name]
