"""Host-side audio DSP (a copy of phaneron_tpu/audio/engine.py).

The reference routes all audio through libavfilter graphs: producer
`amerge`, mixer `pan/volume` (mixer.ts:140-169), transitioner/combiner
`amix` (transitioner.ts:83-121, combiner.ts:281-314) and consumer
`asetnsamples` re-chunking (macadamConsumer.ts:207-218).  Audio rates
are tiny next to video (8ch x 48kHz f32 = 1.5 MB/s), so the build
keeps this on the host in numpy with the same quantum (1024 samples,
blackSilence.ts:40-49).

Samples are planar float32 arrays shaped (channels, n) — fltp layout.
"""

from __future__ import annotations

import numpy as np

__all__ = [
    "silence",
    "apply_volume",
    "pan",
    "amix",
    "crossfade",
    "adapt_channels",
    "LinearResampler",
    "Rechunker",
    "interleave_s32",
]

QUANTUM = 1024  # samples per silence/source frame (blackSilence.ts:40)


def silence(channels: int, n: int = QUANTUM) -> np.ndarray:
    return np.zeros((channels, n), dtype=np.float32)


def apply_volume(samples: np.ndarray, gain: float) -> np.ndarray:
    """The volume filter (mixer.ts volume=...)."""
    if gain == 1.0:
        return samples
    return samples * np.float32(gain)


def pan(samples: np.ndarray, matrix: np.ndarray) -> np.ndarray:
    """Channel-mapping mix: out[o] = sum_i matrix[o, i] * in[i]
    (the ffmpeg pan=Nc|... filter the Mixer builds, mixer.ts:140-152)."""
    return (matrix.astype(np.float32) @ samples).astype(np.float32)


def adapt_channels(samples: np.ndarray, out_channels: int) -> np.ndarray:
    """Map a source channel count onto the consumer layout: identity when
    equal, truncate when wider, cycle-duplicate when narrower (the
    reference's pan=Nc|c{k%N}=... wraps source channels the same way,
    mixer.ts:140-145)."""
    in_channels = samples.shape[0]
    if in_channels == out_channels:
        return samples
    idx = np.arange(out_channels) % in_channels
    return samples[idx]


def crossfade(
    cur: np.ndarray, nxt: np.ndarray, mix: float, constant_power: bool = False
) -> np.ndarray:
    """Transition audio: gain cur by ``mix`` and next by ``1-mix`` (the
    same weights the video dissolve uses, transition.ts:60-65), instead
    of the reference's amix/2 which ducks both sources 6 dB for the
    whole transition (transitioner.ts:83-121 — a known defect, not
    carried forward).  ``constant_power`` uses sqrt gains so uncorrelated
    sources keep constant loudness through the midpoint."""
    n = min(cur.shape[1], nxt.shape[1])
    g_cur, g_nxt = float(mix), 1.0 - float(mix)
    if constant_power:
        g_cur, g_nxt = g_cur**0.5, g_nxt**0.5
    return (
        cur[:, :n] * np.float32(g_cur) + nxt[:, :n] * np.float32(g_nxt)
    ).astype(np.float32)


def amix(inputs: list[np.ndarray], normalize: bool = True) -> np.ndarray:
    """Mix N inputs (ffmpeg amix semantics: inputs summed, scaled by the
    active input count when normalize is on)."""
    if not inputs:
        raise ValueError("amix requires at least one input")
    n = min(s.shape[1] for s in inputs)
    acc = np.zeros((inputs[0].shape[0], n), dtype=np.float32)
    for s in inputs:
        acc += s[:, :n]
    if normalize and len(inputs) > 1:
        acc /= np.float32(len(inputs))
    return acc


class LinearResampler:
    """Stateful linear-interpolation sample-rate converter.

    The reference's per-source filter graph converts the source rate to
    the consumer rate inside libavfilter (mixer.ts inputParams
    srcSampleRate -> outputParams dstSampleRate); here a phase-carrying
    linear resampler does the same on the host.  Chunks stream in any
    size; phase is continuous across chunks."""

    def __init__(self, src_rate: int, dst_rate: int, channels: int):
        self.ratio = src_rate / dst_rate
        self.channels = channels
        self._buf = np.zeros((channels, 0), dtype=np.float32)
        self._pos = 0.0  # source-sample position of the next output

    def push(self, samples: np.ndarray) -> np.ndarray:
        self._buf = np.concatenate([self._buf, samples.astype(np.float32)], axis=1)
        avail = self._buf.shape[1]
        if avail < 2:
            return np.zeros((self.channels, 0), dtype=np.float32)
        # outputs whose interpolation interval [i0, i0+1] is in-buffer
        n_out = int(np.floor((avail - 1 - self._pos) / self.ratio)) + 1
        if n_out <= 0:
            return np.zeros((self.channels, 0), dtype=np.float32)
        pos = self._pos + np.arange(n_out) * self.ratio
        i0 = np.floor(pos).astype(np.int64)
        frac = (pos - i0).astype(np.float32)
        # the last output can land exactly on the final sample (frac 0):
        # clamp its (zero-weighted) second tap in-buffer
        i1 = np.minimum(i0 + 1, avail - 1)
        out = self._buf[:, i0] * (1.0 - frac) + self._buf[:, i1] * frac
        consumed = int(i0[-1])  # keep the last interval's first sample
        self._buf = self._buf[:, consumed:]
        self._pos = float(pos[-1] - consumed + self.ratio)
        return out


class Rechunker:
    """asetnsamples: arbitrary-size input chunks -> fixed-size frames."""

    def __init__(self, channels: int, frame_samples: int):
        self.channels = channels
        self.frame_samples = frame_samples
        self._pending = np.zeros((channels, 0), dtype=np.float32)

    def push(self, samples: np.ndarray) -> list[np.ndarray]:
        self._pending = np.concatenate([self._pending, samples], axis=1)
        out = []
        while self._pending.shape[1] >= self.frame_samples:
            out.append(self._pending[:, : self.frame_samples].copy())
            self._pending = self._pending[:, self.frame_samples :]
        return out

    def flush(self) -> np.ndarray | None:
        """Remaining samples zero-padded to one frame (end of stream)."""
        if self._pending.shape[1] == 0:
            return None
        pad = self.frame_samples - self._pending.shape[1]
        out = np.pad(self._pending, ((0, 0), (0, pad)))
        self._pending = np.zeros((self.channels, 0), dtype=np.float32)
        return out


def interleave_s32(samples: np.ndarray) -> np.ndarray:
    """Planar float -> interleaved signed 32-bit (the SDI consumer's
    fltp->s32 conversion, macadamConsumer.ts:135-158).  The positive
    clip bound must be representable in f32 (1 - 2^-24 is the largest
    float32 below 1.0), else full-scale samples overflow int32."""
    bound = np.float32(1.0) - np.float32(2.0**-24)
    clipped = np.clip(samples, -1.0, bound)
    return (clipped.T.reshape(-1).astype(np.float64) * (2.0**31)).astype(np.int32)
