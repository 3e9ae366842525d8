"""The packed composite kernel: a run of DVE layers warped, 'over'
composited and packed to v210 in one launch.

Counterpart of phaneron_tpu/ops/pallas_packed_warp.py
``make_packed_composite_program`` in its ``src_kind='rgb3'``,
``emit='packed'`` mode: opaque alpha-free (3, H, W) float32 sources (the
deinterlaced fields of the interlaced default load), each layer a cut or
a same-matrix dissolve pair under an axis-aligned matrix.
``packed_composite`` launches csrc/packed_composite.cu for CUDA tensors
and runs ``packed_composite_plain`` for CPU tensors;
``packed_composite.launches`` counts kernel launches.

The plain version is the staged path it fuses: per layer the warp (a
dissolve pair mixed after the warp) with its separable alpha
``warp_alpha_vectors``, ``combine_rgb`` and the v210 pack.  The TPU
kernel premixes the pair before one warp, in bf16 hi/lo products; the
port keeps the staged order, within 1 code of it (tests/
test_torch_packed_warp.py).  Packed v210 word sources decoded inside the
warp window, the RGBA emit and the packed warp are still to port
(ROADMAP.md Queue B, B6 and B7).
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from ._build import library
from .composite import combine_rgb
from .formats import v210 as v210fmt
from .kernels import _encode_coeffs, check_arg, check_launch, is_cpu, stream_handle, v210_pack_plain
from .warp import warp_alpha_vectors, warp_plain

__all__ = ["packed_composite", "packed_composite_plain", "MAX_LAYERS"]

MAX_LAYERS = 8  # layers per launch (kMaxLayers in csrc/packed_composite.cu)


def _check_layers(srcs: Sequence[torch.Tensor], layer_cfg: Sequence[int], mats, mixes) -> None:
    if not layer_cfg or any(n not in (1, 2) for n in layer_cfg):
        raise ValueError(f"packed_composite: layer_cfg entries must be 1 or 2, got {layer_cfg}")
    if len(srcs) != sum(layer_cfg):
        raise ValueError(f"packed_composite: {len(srcs)} sources for layer_cfg {layer_cfg}")
    if len(mats) != len(layer_cfg) or len(mixes) != len(layer_cfg):
        raise ValueError("packed_composite: one matrix and one mix per layer")
    shape = tuple(srcs[0].shape)
    if len(shape) != 3 or shape[0] != 3:
        raise ValueError(f"packed_composite: expected (3, H, W) sources, got {shape}")
    for n, mix in zip(layer_cfg, mixes):
        if n == 2 and mix is None:
            raise ValueError("packed_composite: a dissolve layer needs its mix")


def packed_composite_plain(
    srcs: Sequence[torch.Tensor], layer_cfg: Sequence[int], mats, mixes,
    out_col_spec: str = "709",
) -> torch.Tensor:
    """Plain version of packed_composite: the staged warp -> combine_rgb
    -> v210 pack path."""
    _check_layers(srcs, layer_cfg, mats, mixes)
    _, h, w = srcs[0].shape
    layers, s = [], 0
    for n, mat, mix in zip(layer_cfg, mats, mixes):
        rgb = warp_plain(srcs[s], mat) if n == 1 else warp_plain(srcs[s], mat, srcs[s + 1], mix)
        layers.append((rgb, *warp_alpha_vectors(h, w, mat)))
        s += n
    return v210_pack_plain(combine_rgb(layers), out_col_spec)


def packed_composite(
    srcs: Sequence[torch.Tensor], layer_cfg: Sequence[int], mats, mixes,
    out_col_spec: str = "709",
) -> torch.Tensor:
    """Layers bottom to top over opaque (3, H, W) float32 sources -> v210
    words (H, pitch_bytes/4) int32.

    ``layer_cfg[m]`` is layer m's source count (1 a cut, 2 a dissolve
    pair); ``srcs`` lists them flat.  ``mats[m]`` is its (3, 3) matrix
    (only m00, m02, m11, m12 are read), ``mixes[m]`` its mix (a 0-d
    tensor or float; None for a cut).  Each layer's alpha is its separable
    warp alpha; the bottom layer composites over black."""
    _check_layers(srcs, layer_cfg, mats, mixes)
    if is_cpu(srcs[0], "packed_composite"):
        return packed_composite_plain(srcs, layer_cfg, mats, mixes, out_col_spec)
    if len(layer_cfg) > MAX_LAYERS:
        raise ValueError(f"packed_composite: at most {MAX_LAYERS} layers per launch")
    dev = srcs[0].device
    _, h, w = srcs[0].shape
    for s in srcs:
        check_arg(s, "packed_composite src", dev, torch.float32, (3, h, w))
    mats = [torch.as_tensor(m, dtype=torch.float32, device=dev) for m in mats]
    for m in mats:
        check_arg(m, "packed_composite mat", dev, torch.float32, (3, 3))
    mixes = [
        None if n == 1 else torch.as_tensor(x, dtype=torch.float32, device=dev).reshape(1)
        for n, x in zip(layer_cfg, mixes)
    ]
    groups = v210fmt.pitch(w) // 6
    out = torch.empty((h, groups * 4), dtype=torch.int32, device=dev)
    ptrs = lambda ts: (ctypes.c_void_p * len(ts))(*(None if t is None else t.data_ptr() for t in ts))
    src_p, mat_p, mix_p = ptrs(srcs), ptrs(mats), ptrs(mixes)
    n_src = (ctypes.c_int * len(layer_cfg))(*layer_cfg)
    with torch.cuda.device(dev):
        rc = library().phn_packed_composite(
            ctypes.addressof(src_p), ctypes.addressof(mat_p), ctypes.addressof(mix_p),
            ctypes.addressof(n_src), len(layer_cfg), out.data_ptr(), w, h, groups,
            ctypes.addressof(_encode_coeffs(out_col_spec)), stream_handle(dev),
        )
    check_launch(rc, "packed_composite")
    packed_composite.launches += 1
    return out


packed_composite.launches = 0
