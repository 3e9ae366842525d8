"""The general affine DVE warp kernel (MIXER ROTATION at any angle).

Counterpart of phaneron_tpu/ops/pallas_rotate.py (``make_rotate_program``
and its ``_make_pass``).  The TPU kernel approximates the direct bilinear
gather by a quarter turn and two shear passes, because Mosaic has no
gather; it differs from the gather at content step edges.  The CUDA
kernel (csrc/rotate.cu) computes the gather itself, ops/geometry.py
``warp_affine``, for any matrix, so the TPU's rotation codes
(``rot_bucket``, ``rot_bucket_b``) are not read.

``rotate`` has the modes and the C interface of the axis-aligned warp
(ops/warp.py): a single source, a dissolve pair and a wipe pair, each
pair under one shared matrix or two, for (C, H, W) float32 frames with
C = 3 or 4.  It launches the kernel for CUDA tensors and runs
``rotate_plain`` (warp_affine, then mix_frames or wipe_mask) for CPU
tensors; ``rotate.launches`` counts kernel launches.
"""

from __future__ import annotations

import torch

from .geometry import warp_affine
from .kernels import is_cpu
from .warp import launch_pair, mix_pair, pair_args

__all__ = ["rotate", "rotate_plain"]


def rotate_plain(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
    mat_b: torch.Tensor | None = None, mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Plain version of rotate: warp_affine(src), or the pair step
    (ops/warp.py mix_pair) over warp_affine(src, mat) and
    warp_affine(src_b, mat_b)."""
    out = warp_affine(src, mat)
    if src_b is None:
        return out
    return mix_pair(out, warp_affine(src_b, mat if mat_b is None else mat_b), mix, mask)


def rotate(
    src: torch.Tensor, mat: torch.Tensor,
    src_b: torch.Tensor | None = None, mix: torch.Tensor | float | None = None,
    mat_b: torch.Tensor | None = None, mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Affine bilinear DVE warp of a (C, H, W) float32 frame, C = 3 or 4,
    by the (3, 3) matrix ``mat`` (the top two rows are read), border
    zero.  With ``src_b``, under ``mat_b`` (default: ``mat``): the
    dissolve pair warp(src)*mix + warp(src_b)*(1-mix), or with an (H, W)
    float32 ``mask`` in place of ``mix`` the wipe pair
    warp(src_b)*m + warp(src)*(1-m)."""
    pair_args("rotate", src, src_b, mix, mat_b, mask)
    if is_cpu(src, "rotate"):
        return rotate_plain(src, mat, src_b, mix, mat_b, mask)
    out = launch_pair("rotate", "phn_rotate", src, mat, src_b, mix, mat_b, mask)
    rotate.launches += 1
    return out


rotate.launches = 0
