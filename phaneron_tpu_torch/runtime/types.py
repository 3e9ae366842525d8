"""Shared runtime value types (counterpart of phaneron_tpu/runtime/types.py,
over the port's LayerSpec)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np

from ..graph.pipeline import LayerSpec

__all__ = ["TransitionSpec", "LayerContribution"]


@dataclass
class TransitionSpec:
    """PLAY transition parameters (layer.ts:32-40)."""

    type: str = "cut"  # 'cut' | 'dissolve' | 'wipe'
    length: int = 0  # frames
    mask_url: Optional[str] = None  # wipe mask source


@dataclass
class LayerContribution:
    """What one layer hands the channel for one tick."""

    spec: LayerSpec
    params: dict[str, Any]
    audio: np.ndarray
    loadstamp: Optional[float] = None  # source frame ingest wall-clock
