"""Carry a JAX channel spec and its params into the port.

The params pytree is this system's "weights": the parity tests and the
chip check feed the JAX program and the port identical inputs, made on
the host with numpy.

- ``params_from_numpy(params, device)``: ``{"layers": [{"src": [...],
  "src_b": [...], "matrix": (3, 3), "mix": scalar}, ...]}`` with numpy
  leaves (the caller ``np.asarray``-s JAX arrays) -> the same structure
  of tensors on ``device``.  uint32 planes (v210 words) become int32
  bit-views; uint16 planes (yuv422p10le) stay torch.uint16 and uint8
  planes (yuv422p8, yuv420p, nv12, and the (H, W, 4) rgba8 and bgra8
  pixels) stay uint8; float64 leaves become float32; a (C, H, W) float
  source (``rgba_f32``) stays one tensor.  Deinterlace rings (``src_ring``,
  ``src_b_ring``: three (C, H, W) frames) stay tuples, and an integer
  ``parity`` becomes a 0-d int32 tensor.
- ``words_to_numpy(t)``: the inverse for word tensors, -> uint32 numpy.
- ``spec_from_fields(d)``: a JAX ``ChannelSpec._asdict()`` (layers as
  LayerSpec tuples or dicts) -> the port's ChannelSpec.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .pipeline import ChannelSpec, LayerSpec

__all__ = ["params_from_numpy", "spec_from_fields", "words_to_numpy", "to_tensor"]


def to_tensor(value: Any, device: torch.device | str) -> torch.Tensor:
    """One numpy leaf -> a tensor on ``device`` (uint32 -> int32 bit-view,
    float64 -> float32, int64 -> int32; uint16 and uint8 keep their
    type)."""
    a = np.asarray(value)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    elif a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == np.int64:
        a = a.astype(np.int32)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(params: Mapping, device: torch.device | str) -> dict:
    def leaf(value):
        if isinstance(value, tuple):
            return tuple(to_tensor(v, device) for v in value)
        if isinstance(value, list):
            return [to_tensor(v, device) for v in value]
        return to_tensor(value, device)

    return {
        "layers": [
            {key: leaf(value) for key, value in layer.items()}
            for layer in params["layers"]
        ]
    }


def words_to_numpy(words: torch.Tensor) -> np.ndarray:
    """int32 word tensor -> uint32 numpy array (the v210 wire form)."""
    return words.detach().cpu().numpy().view(np.uint32)


def spec_from_fields(fields: Mapping) -> ChannelSpec:
    d = dict(fields._asdict() if hasattr(fields, "_asdict") else fields)
    layers = []
    for ls in d["layers"]:
        ld = dict(ls._asdict() if hasattr(ls, "_asdict") else ls)
        if ld.get("src_size") is not None:
            ld["src_size"] = tuple(ld["src_size"])
        layers.append(LayerSpec(**ld))
    d["layers"] = tuple(layers)
    return ChannelSpec(**d)
