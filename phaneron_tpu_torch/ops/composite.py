"""Compositing ops: N-layer combine, transitions and mix (counterpart of
phaneron_tpu/ops/composite.py; combine.ts, transition.ts, mix.ts) over
planar (4, H, W) linear premultiplied RGBA frames.  ``mix`` may be a
Python float or a 0-d tensor on the frames' device, so animating it
needs no host round trip.
"""

from __future__ import annotations

import torch

__all__ = ["combine", "combine_rgb", "dissolve", "mix_frames"]


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


def dissolve(in0: torch.Tensor, in1: torch.Tensor, mix) -> torch.Tensor:
    """transition_dissolve: out = in0 * mix + in1 * (1 - mix)
    (transition.ts:60-65)."""
    return in0 * mix + in1 * (1.0 - mix)


def mix_frames(in0: torch.Tensor, in1: torch.Tensor, mix) -> torch.Tensor:
    """Plain linear mix (mix.ts:24-46)."""
    return in0 * mix + in1 * (1.0 - mix)
