"""Prewarm of channel programs (counterpart of
phaneron_tpu/graph/warmup.py).

The reference compiles its OpenCL kernels during loadSource, so PLAY
starts clean.  The JAX package predicts the frame program a layer will
need at LOADBG/LOAD and compiles it ahead of time.  The port has nothing
to compile per structure: its kernels are one library, built once a
process (ops/_build.py).  So ``prewarm(spec)`` builds the library (the
counterpart of JAX's ``prewarm_jit`` too) and runs the structure's
``prepare(device)``, the one-time device work its first frame would
otherwise do (transfer correction tables, each with a host wait), on a
worker thread off the event loop.

``dummy_params(spec)`` gives the shapes and types of the params a
structure's frame program takes, as the layers deliver them
(``TensorSpec`` leaves in the params' structure), from the port's format
``plane_shapes``.
"""

from __future__ import annotations

import asyncio
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _build
from ..ops.formats import get_format
from ..runtime.frame import RGBA_F32
from .pipeline import ChannelSpec, LayerSpec, make_channel_program
from .replay import capture_lock

__all__ = ["TensorSpec", "dummy_params", "prewarm"]


class TensorSpec(NamedTuple):
    """The shape and type of one params tensor."""

    shape: tuple
    dtype: torch.dtype


def _plane_specs(fmt_name: str, width: int, height: int) -> list[TensorSpec]:
    """A format's planes as the port carries them: v210 words as int32
    (graph/convert.py to_tensor), every other sample type as it is."""
    out = []
    for shape, dtype in get_format(fmt_name).plane_shapes(width, height):
        dtype = np.dtype(np.int32) if np.dtype(dtype) == np.uint32 else np.dtype(dtype)
        out.append(TensorSpec(tuple(shape), torch.from_numpy(np.empty(0, dtype)).dtype))
    return out


def _frame(nc: int, h: int, w: int) -> TensorSpec:
    return TensorSpec((nc, h, w), torch.float32)


def _layer_struct(ls: LayerSpec, spec: ChannelSpec) -> dict:
    w, h = ls.src_size if ls.src_size else (spec.width, spec.height)
    nc = 3 if ls.src_opaque else 4  # opaque sources ring and field as (3, H, W)
    params: dict = {}
    if ls.deinterlace:
        params["src_ring"] = tuple(_frame(nc, h, w) for _ in range(3))
        params["parity"] = TensorSpec((), torch.int32)
    elif ls.src_format == RGBA_F32:
        # a field of the slot's pair deinterlace (runtime/layer.py)
        params["src"] = _frame(nc, h, w)
    else:
        params["src"] = _plane_specs(ls.src_format, w, h)
    if ls.has_transform:
        params["matrix"] = TensorSpec((3, 3), torch.float32)
        if ls.transition != "none":
            params["matrix_b"] = TensorSpec((3, 3), torch.float32)
    if ls.transition == "dissolve":
        params["mix"] = TensorSpec((), torch.float32)
        if ls.deinterlace:
            params["src_b_ring"] = tuple(_frame(nc, h, w) for _ in range(3))
        elif (ls.src_b_format or ls.src_format) == RGBA_F32:
            params["src_b"] = _frame(nc, h, w)
        else:
            params["src_b"] = _plane_specs(ls.src_b_format or ls.src_format, w, h)
    elif ls.transition == "wipe":
        params["src_b"] = _plane_specs(ls.src_b_format or ls.src_format, w, h)
        params["mask"] = _plane_specs(ls.mask_format or ls.src_format, w, h)
    return params


def dummy_params(spec: ChannelSpec) -> dict:
    return {"layers": [_layer_struct(ls, spec) for ls in spec.layers]}


def _prepare(spec: ChannelSpec, device: torch.device, plain: bool) -> None:
    if device.type == "cuda" and not plain:
        _build.library()
    with capture_lock:  # no CUDA graph capture while it launches
        make_channel_program(spec, plain=plain).prepare(device)


async def prewarm(spec: ChannelSpec, device: torch.device | str = "cuda", plain: bool = False) -> None:
    """Build the kernel library and prepare a channel program on a worker
    thread; failures are logged, never raised (prediction is
    best-effort, and the structure's first frame raises the same
    error)."""
    try:
        await asyncio.to_thread(_prepare, spec, torch.device(device), plain)
    except Exception as err:
        print(f"prewarm failed for {spec}: {err}")
