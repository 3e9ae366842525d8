"""The axis-aligned DVE warp kernel (single source or dissolve pair).

Counterpart of phaneron_tpu/ops/pallas_warp.py (``_make_program`` in its
single and dissolve-pair modes).  ``warp`` launches csrc/warp.cu for CUDA
tensors and runs ``warp_plain`` (ops/geometry.py warp_axis_aligned) for
CPU tensors; ``warp.launches`` counts kernel launches.

The TPU kernel's scale buckets, DMA windows and one-hot weights exist
for VMEM; the CUDA kernel gathers its taps directly, so it takes any
geometry and any axis-aligned matrix.  The wipe and 3-channel modes are
still to port (ROADMAP.md Queue B, B4).
"""

from __future__ import annotations

import torch

from ._build import library
from .composite import mix_frames
from .geometry import warp_axis_aligned
from .kernels import check_arg, check_launch, is_cpu, stream_handle

__all__ = ["warp", "warp_plain"]


def warp_plain(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Plain version of warp: warp(src) or warp(src)*mix + warp(src_b)*(1-mix)."""
    out = warp_axis_aligned(src, mat)
    if src_b is None:
        return out
    return mix_frames(out, warp_axis_aligned(src_b, mat), mix)


def warp(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
) -> torch.Tensor:
    """Axis-aligned bilinear DVE warp of a (4, H, W) float32 frame by the
    (3, 3) matrix ``mat`` (only m00, m02, m11, m12 are read), border zero.
    With ``src_b`` and ``mix``: the dissolve pair warp(src)*mix +
    warp(src_b)*(1-mix), both sources under the same matrix."""
    if (src_b is None) != (mix is None):
        raise ValueError("warp: src_b and mix go together")
    if is_cpu(src, "warp"):
        return warp_plain(src, mat, src_b, mix)
    dev = src.device
    c, h, w = src.shape
    check_arg(src, "warp src", dev, torch.float32, (4, h, w))
    mat = torch.as_tensor(mat, dtype=torch.float32, device=dev)
    check_arg(mat, "warp mat", dev, torch.float32, (3, 3))
    b_ptr = mix_ptr = None
    if src_b is not None:
        check_arg(src_b, "warp src_b", dev, torch.float32, (c, h, w))
        mix = torch.as_tensor(mix, dtype=torch.float32, device=dev).reshape(1)
        b_ptr, mix_ptr = src_b.data_ptr(), mix.data_ptr()
    out = torch.empty_like(src)
    with torch.cuda.device(dev):
        rc = library().phn_warp(
            src.data_ptr(), b_ptr, mat.data_ptr(), mix_ptr, out.data_ptr(),
            c, h, w, stream_handle(dev),
        )
    check_launch(rc, "warp")
    warp.launches += 1
    return out


warp.launches = 0
