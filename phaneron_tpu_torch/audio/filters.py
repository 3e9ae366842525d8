"""Per-source audio filters: the reference's mixer chain, enable-able (a
copy of phaneron_tpu/audio/filters.py).

The reference builds pan -> highpass -> adelay -> acompressor ->
aformat -> volume into every source's filter graph (mixer.ts:146) but
constructs highpass with mix=0, adelay with delays='' and acompressor
with threshold=1:mix=0 — shipped surface, disabled effect.  This
module supplies working implementations of that surface so a control
layer can actually enable them: an RBJ biquad highpass, an integer
sample delay, and a feed-forward compressor, each carrying streaming
state across QUANTUM chunks (planar float32 (channels, n)).

CPU-side on purpose: audio is ~10^4 samples/frame against ~10^7 pixels;
the reference runs it through libavfilter on the host for the same
reason (SURVEY.md §3.3 audio path).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["Highpass", "Delay", "Compressor", "FilterChain", "make_filter"]


class Highpass:
    """RBJ-cookbook 2nd-order highpass (libavfilter 'highpass' default
    shape, Q = 0.707), per-channel biquad state."""

    def __init__(self, frequency: float = 3000.0, rate: int = 48000, q: float = 0.707):
        self.frequency = float(frequency)
        w0 = 2.0 * math.pi * frequency / rate
        alpha = math.sin(w0) / (2.0 * q)
        cosw = math.cos(w0)
        a0 = 1.0 + alpha
        self.b = np.array(
            [(1 + cosw) / 2 / a0, -(1 + cosw) / a0, (1 + cosw) / 2 / a0], np.float64
        )
        self.a = np.array([1.0, -2 * cosw / a0, (1 - alpha) / a0], np.float64)
        self._z: np.ndarray | None = None  # (channels, 2) DF2T state

    def process(self, x: np.ndarray) -> np.ndarray:
        ch, n = x.shape
        if self._z is None or self._z.shape[0] != ch:
            self._z = np.zeros((ch, 2), np.float64)
        b, a, z = self.b, self.a, self._z
        y = np.empty_like(x, np.float64)
        xi = x.astype(np.float64)
        for i in range(n):  # DF2T; n is QUANTUM (1024) — cheap on host
            s = xi[:, i]
            out = b[0] * s + z[:, 0]
            z[:, 0] = b[1] * s - a[1] * out + z[:, 1]
            z[:, 1] = b[2] * s - a[2] * out
            y[:, i] = out
        return y.astype(np.float32)


class Delay:
    """Integer-sample per-channel delay (the reference's adelay)."""

    def __init__(self, samples: int = 0):
        self.samples = int(samples)
        self._buf: np.ndarray | None = None

    def process(self, x: np.ndarray) -> np.ndarray:
        d = self.samples
        if d <= 0:
            return x
        ch, n = x.shape
        if self._buf is None or self._buf.shape != (ch, d):
            self._buf = np.zeros((ch, d), np.float32)
        joined = np.concatenate([self._buf, x], axis=1)
        self._buf = joined[:, -d:].copy()
        return joined[:, :n]


class Compressor:
    """Feed-forward compressor with one-pole envelope follower
    (libavfilter 'acompressor' parameter surface: threshold as linear
    amplitude, ratio, attack/release ms, makeup gain)."""

    def __init__(
        self,
        threshold: float = 0.125,
        ratio: float = 2.0,
        attack: float = 20.0,
        release: float = 250.0,
        makeup: float = 1.0,
        rate: int = 48000,
    ):
        self.threshold = float(threshold)
        self.ratio = float(ratio)
        self.makeup = float(makeup)
        self._ga = math.exp(-1.0 / (rate * attack / 1000.0))
        self._gr = math.exp(-1.0 / (rate * release / 1000.0))
        self._env = 0.0

    def process(self, x: np.ndarray) -> np.ndarray:
        n = x.shape[1]
        level = np.abs(x).max(axis=0)  # linked channels, peak detector
        gains = np.empty(n, np.float32)
        env, ga, gr = self._env, self._ga, self._gr
        thr, ratio = self.threshold, self.ratio
        for i in range(n):
            s = level[i]
            env = ga * env + (1 - ga) * s if s > env else gr * env + (1 - gr) * s
            if env > thr and env > 0.0:
                target = thr * (env / thr) ** (1.0 / ratio)
                gains[i] = target / env
            else:
                gains[i] = 1.0
        self._env = env
        return (x * gains[None, :] * np.float32(self.makeup)).astype(np.float32)


_FILTERS = {"highpass": Highpass, "adelay": Delay, "acompressor": Compressor}


def make_filter(name: str, **params):
    if name not in _FILTERS:
        raise KeyError(f"unknown audio filter '{name}'")
    return _FILTERS[name](**params)


class FilterChain:
    """Ordered per-source filter chain applied between pan and volume
    (the reference's graph position, mixer.ts:146)."""

    def __init__(self):
        self._filters: list = []

    def set(self, name: str, **params) -> None:
        """Add or replace the filter of this name (chain keeps the
        reference's fixed order: highpass, adelay, acompressor)."""
        order = list(_FILTERS)
        self._filters = [f for f in self._filters if f[0] != name]
        self._filters.append((name, make_filter(name, **params)))
        self._filters.sort(key=lambda f: order.index(f[0]))

    def clear(self, name: str | None = None) -> None:
        if name is None:
            self._filters = []
        else:
            self._filters = [f for f in self._filters if f[0] != name]

    @property
    def active(self) -> list:
        return [name for name, _ in self._filters]

    def process(self, x: np.ndarray) -> np.ndarray:
        for _, f in self._filters:
            x = f.process(x)
        return x
