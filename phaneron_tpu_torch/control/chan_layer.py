"""Channel-layer address parsing (reference src/chanLayer.ts:52-66).

A copy of phaneron_tpu/control/chan_layer.py: the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from dataclasses import dataclass

__all__ = ["ChanLayer", "chan_layer_from_string"]

_RE = re.compile(r"(?P<channel>\d+)-?(?P<layer>\d*)")


@dataclass(frozen=True)
class ChanLayer:
    valid: bool
    channel: int
    layer: int


def chan_layer_from_string(s: str | None) -> ChanLayer:
    if not s:
        return ChanLayer(False, 0, 0)
    m = _RE.match(s)
    if not m:
        return ChanLayer(False, 0, 0)
    channel = int(m.group("channel"))
    layer = int(m.group("layer")) if m.group("layer") else 0
    return ChanLayer(True, channel, layer)
