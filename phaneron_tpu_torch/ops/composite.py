"""Compositing ops: N-layer combine, transitions, mix and wipe
(counterpart of phaneron_tpu/ops/composite.py; combine.ts, transition.ts,
mix.ts, wipe.ts) over planar (4, H, W) linear premultiplied RGBA frames.
``mix``, ``wipe`` and ``enables`` may be Python values or tensors on the
frames' device, so animating them needs no host round trip.
"""

from __future__ import annotations

import torch

__all__ = [
    "combine",
    "combine_rgb",
    "combine_masked",
    "dissolve",
    "wipe_mask",
    "mix_frames",
    "wipe_h",
    "transparent",
]


def transparent(height: int, width: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """Transparent black (4, H, W): the identity of the 'over' operator."""
    return torch.zeros((4, height, width), dtype=torch.float32, device=device)


def _over(out: torch.Tensor, layer: torch.Tensor) -> torch.Tensor:
    """One 'over' step.  k4 = (k, k, k, 0) with k = 1 - alpha_layer: RGB
    is out*k + layer; alpha is 0*out + layer, i.e. the layer's alpha
    (combine.ts:47-59)."""
    ch = torch.arange(4, device=out.device)[:, None, None]
    k4 = torch.where(ch < 3, 1.0 - layer[3:4], 0.0)
    return out * k4 + layer


def combine(layers: list[torch.Tensor]) -> torch.Tensor:
    """Premultiplied-alpha 'over' accumulation, bottom to top.  The alpha
    channel takes the top layer's alpha."""
    if not layers:
        raise ValueError("combine requires at least one layer")
    out = layers[0]
    for layer in layers[1:]:
        out = _over(out, layer)
    return out


def combine_rgb(layers: list) -> torch.Tensor:
    """Premultiplied 'over' accumulation -> (3, H, W) RGB only.

    Each layer is a (4, H, W) RGBA frame or an ``(rgb (3, H, W), wy (H,),
    wx (W,))`` tuple whose alpha is the separable outer product
    wy[:, None] * wx.  The black base is implicit."""
    if not layers:
        raise ValueError("combine_rgb requires at least one layer")

    def split(entry):
        if isinstance(entry, tuple):
            rgb, wy, wx = entry
            return rgb, wy[:, None] * wx[None, :]
        return entry[:3], entry[3]

    out, _ = split(layers[0])
    for entry in layers[1:]:
        rgb, a = split(entry)
        out = out * (1.0 - a)[None, :, :] + rgb
    return out


def combine_masked(layers: list[torch.Tensor], enables) -> torch.Tensor:
    """Fixed-arity combine with per-layer enable flags: equal to
    combine(the enabled layers), alpha included.  ``enables`` is an
    (N,) bool tensor; enables[0] is ignored (the base layer is always
    present)."""
    out = layers[0]
    for i, layer in enumerate(layers[1:], start=1):
        out = torch.where(enables[i], _over(out, layer), out)
    return out


def dissolve(in0: torch.Tensor, in1: torch.Tensor, mix) -> torch.Tensor:
    """transition_dissolve: out = in0 * mix + in1 * (1 - mix)
    (transition.ts:60-65)."""
    return in0 * mix + in1 * (1.0 - mix)


def wipe_mask(in0: torch.Tensor, in1: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """transition_wipe: per-pixel blend by the mask frame's R channel
    (transition.ts:66-74): out = in1 * m + in0 * (1 - m), m = mask[0]."""
    m = mask[0]
    return in1 * m + in0 * (1.0 - m)


def mix_frames(in0: torch.Tensor, in1: torch.Tensor, mix) -> torch.Tensor:
    """Plain linear mix (mix.ts:24-46)."""
    return in0 * mix + in1 * (1.0 - mix)


def wipe_h(in0: torch.Tensor, in1: torch.Tensor, wipe) -> torch.Tensor:
    """Hard-edge horizontal wipe: x > w * wipe ? in1 : in0 (wipe.ts:24-48)."""
    w = in0.shape[-1]
    x = torch.arange(w, dtype=torch.float32, device=in0.device)[None, None, :]
    return torch.where(x > w * torch.as_tensor(wipe, dtype=torch.float32), in1, in0)
