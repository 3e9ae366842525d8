"""Frame value types flowing through runtime pipes (counterpart of
phaneron_tpu/runtime/frame.py).

Payloads are device tensors; timestamps ride on every frame like the
reference's OpenCLBuffer.timestamp.  ``loadstamp`` carries the host
wall-clock at ingest for end-to-end latency metrics."""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any

__all__ = ["VideoFrame", "AudioFrame", "RGBA_F32"]

# pseudo-format name for frames that are already unpacked linear RGBA
RGBA_F32 = "rgba_f32"


@dataclass
class VideoFrame:
    timestamp: int
    format: str  # pixel format name or RGBA_F32
    payload: Any  # list of packed plane tensors, or a (4, H, W) rgba tensor
    width: int
    height: int
    interlaced: bool = False
    tff: bool = True
    loadstamp: float = field(default_factory=time.monotonic)


@dataclass
class AudioFrame:
    timestamp: int
    samples: Any  # (channels, n) float32 numpy array (planar, like fltp)
    sample_rate: int = 48000
    loadstamp: float = field(default_factory=time.monotonic)
