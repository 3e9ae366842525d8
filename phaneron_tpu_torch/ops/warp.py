"""The axis-aligned DVE warp kernel (single source or dissolve pair).

Counterpart of phaneron_tpu/ops/pallas_warp.py (``_make_program`` in its
single and dissolve-pair modes, ``n_ch`` 4 and 3).  ``warp`` launches
csrc/warp.cu for CUDA tensors and runs ``warp_plain`` (ops/geometry.py
warp_axis_aligned) for CPU tensors; ``warp.launches`` counts kernel
launches.  Frames are (C, H, W) float32 with C = 4 (RGBA) or 3 (opaque
alpha-free frames, whose warped alpha is ``warp_alpha_vectors``).

The TPU kernel's scale buckets, DMA windows and one-hot weights exist
for VMEM; the CUDA kernel gathers its taps directly, so it takes any
geometry and any axis-aligned matrix.  The wipe mode and dissolve pairs
with distinct matrices are still to port (ROADMAP.md Queue B, B4).
"""

from __future__ import annotations

import torch

from ._build import library
from .composite import mix_frames
from .geometry import _bilinear_setup, _out_coords, warp_axis_aligned
from .kernels import check_arg, check_launch, is_cpu, stream_handle

__all__ = ["warp", "warp_plain", "warp_alpha_vectors"]


def warp_alpha_vectors(height: int, width: int, mat: torch.Tensor) -> tuple:
    """(wy (H,), wx (W,)) float32 with warp(ones)(y, x) == wy[y] * wx[x]
    (pallas_warp.py warp_alpha_vectors).

    An axis-aligned bilinear warp of the constant-1 plane is separable:
    each output pixel's alpha is (row-weight sum) x (column-weight sum),
    1 in the projected interior, a bilinear feather at the edge, 0
    outside (border zero).  Opaque sources therefore never carry an alpha
    plane through yadif or the warp; the combine rebuilds alpha as this
    outer product.  Plain tensor code on ``mat``'s device."""
    mat = torch.as_tensor(mat, dtype=torch.float32)

    def weight_sum(pos, size):
        p0, f = _bilinear_setup(pos, size)
        w0 = torch.where((p0 >= 0) & (p0 < size), 1.0 - f, 0.0)
        w1 = torch.where((p0 + 1 >= 0) & (p0 + 1 < size), f, 0.0)
        return w0 + w1

    px = mat[0, 0] * _out_coords(width, mat.device) + mat[0, 2] + 0.5
    py = mat[1, 1] * _out_coords(height, mat.device) + mat[1, 2] + 0.5
    return weight_sum(py, height), weight_sum(px, width)


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
    """Axis-aligned bilinear DVE warp of a (C, H, W) float32 frame, C = 3
    or 4, by the (3, 3) matrix ``mat`` (only m00, m02, m11, m12 are
    read), border zero.  With ``src_b`` and ``mix``: the dissolve pair
    warp(src)*mix + warp(src_b)*(1-mix), both sources under the same
    matrix."""
    if (src_b is None) != (mix is None):
        raise ValueError("warp: src_b and mix go together")
    if src.ndim != 3 or src.shape[0] not in (3, 4):
        raise ValueError(f"warp: expected (3|4, H, W), got {tuple(src.shape)}")
    if is_cpu(src, "warp"):
        return warp_plain(src, mat, src_b, mix)
    dev = src.device
    c, h, w = src.shape
    check_arg(src, "warp src", dev, torch.float32, (c, h, w))
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
