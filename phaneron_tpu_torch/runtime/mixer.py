"""Per-source mixer: DVE params + audio chain state (counterpart of
phaneron_tpu/runtime/mixer.py).

Parity with the reference Mixer (producer/mixer.ts:127-269): every
loaded source owns one; MIXER ANCHOR/FILL/ROTATION update the video
transform, MIXER VOLUME the audio gain.  Here the video side just
maintains the host 3x3 matrix and its copy on the channel's device, which
the frame program reads by pointer: live updates never touch a kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.geometry import is_axis_aligned, transform_matrix

__all__ = ["Mixer"]

_DEFAULTS = dict(
    anchor_x=0.0,
    anchor_y=0.0,
    scale_x=1.0,
    scale_y=1.0,
    offset_x=0.0,
    offset_y=0.0,
    rotate=0.0,
    flip_h=False,
    flip_v=False,
)


class Mixer:
    def __init__(self, width: int, height: int):
        self.width = width
        self.height = height
        self.params = dict(_DEFAULTS)
        self.volume = 1.0
        self.muted = False
        # per-channel pan levels (mixer.ts srcLevels, default unity)
        self.src_levels: np.ndarray | None = None
        self.audio_filters = None  # FilterChain once a filter enables
        self._matrix: np.ndarray | None = None
        self._matrix_on: torch.Tensor | None = None
        self._matrix_src: np.ndarray | None = None  # the matrix _matrix_on holds

    # ------------------------------------------------ video (DVE) params

    def set_anchor(self, x: float, y: float) -> bool:
        self.params["anchor_x"] = x
        self.params["anchor_y"] = y
        self._matrix = None
        return True

    def set_fill(self, x: float, y: float, sx: float, sy: float) -> bool:
        """MIXER FILL: offset + scale (mixerCmds.ts / mixer.ts setMixParams)."""
        self.params["offset_x"] = x
        self.params["offset_y"] = y
        self.params["scale_x"] = sx
        self.params["scale_y"] = sy
        self._matrix = None
        return True

    def set_rotation(self, turns: float) -> bool:
        self.params["rotate"] = turns
        self._matrix = None
        return True

    def set_flip(self, flip_h: bool, flip_v: bool) -> bool:
        self.params["flip_h"] = flip_h
        self.params["flip_v"] = flip_v
        self._matrix = None
        return True

    @property
    def anchor(self) -> tuple[float, float]:
        return self.params["anchor_x"], self.params["anchor_y"]

    @property
    def fill(self) -> tuple[float, float, float, float]:
        p = self.params
        return p["offset_x"], p["offset_y"], p["scale_x"], p["scale_y"]

    @property
    def rotation(self) -> float:
        return self.params["rotate"]

    @property
    def is_identity(self) -> bool:
        """Default params -> the channel graph skips the warp entirely
        (unlike the reference, which always runs its transform kernel —
        SURVEY.md §7.1; skipping is both faster and sharper)."""
        return self.params == _DEFAULTS

    @property
    def axis_aligned(self) -> bool:
        return is_axis_aligned(self.matrix)

    @property
    def matrix(self) -> np.ndarray:
        if self._matrix is None:
            self._matrix = transform_matrix(self.width, self.height, **self.params)
        return self._matrix

    def matrix_on(self, device: torch.device) -> torch.Tensor:
        """``matrix`` as a (3, 3) float32 tensor on ``device``, uploaded
        once a change: from pinned memory without a host wait on a CUDA
        device (a copy from pageable memory would wait for every kernel
        queued before it).  The tensor is never written: a change makes a
        new one.  It carries ``matrix`` as its ``host`` attribute: a
        row-sharded channel works its bands' source windows out from it
        on the host (parallel/mesh.py ``host_copy``)."""
        mat = self.matrix
        if self._matrix_src is not mat or self._matrix_on.device != device:
            host = torch.from_numpy(mat)
            if device.type == "cuda":
                host = host.pin_memory()
            self._matrix_on = host.to(device, non_blocking=True)
            self._matrix_on.host = mat
            self._matrix_src = mat
        return self._matrix_on

    # --------------------------------------------------------- audio

    def set_volume(self, volume: float) -> bool:
        self.volume = volume
        return True

    def set_levels(self, levels) -> bool:
        """Per-channel pan levels (the reference's pan=Nc|ck=level*ck)."""
        self.src_levels = np.asarray(levels, dtype=np.float32)
        return True

    def audio_gain(self) -> float:
        return 0.0 if self.muted else self.volume

    def set_audio_filter(self, name: str, **params) -> bool:
        """Enable/replace one of the reference graph's filters
        (highpass / adelay / acompressor) with real parameters — the
        reference ships the surface permanently disabled (mixer.ts:146);
        here CALL/API can switch it on.  Lazy import keeps the DSP off
        the frame path for sources that never enable a filter."""
        from ..audio.filters import FilterChain

        if self.audio_filters is None:
            self.audio_filters = FilterChain()
        self.audio_filters.set(name, **params)
        return True

    def clear_audio_filter(self, name: str | None = None) -> bool:
        if self.audio_filters is not None:
            self.audio_filters.clear(name)
        return True

    def apply_audio(self, samples: np.ndarray) -> np.ndarray:
        """Full per-source audio chain: pan -> [highpass -> adelay ->
        acompressor] -> volume (the reference's graph order, mixer.ts:146;
        the bracketed filters default OFF exactly as the reference
        builds them disabled, but set_audio_filter can enable them)."""
        if self.src_levels is not None:
            n = min(len(self.src_levels), samples.shape[0])
            samples = samples.copy()
            samples[:n] *= self.src_levels[:n, None]
        if self.audio_filters is not None and self.audio_filters.active:
            samples = self.audio_filters.process(samples)
        gain = self.audio_gain()
        return samples if gain == 1.0 else samples * np.float32(gain)
