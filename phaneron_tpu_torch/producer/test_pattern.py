"""Test-pattern producer: SMPTE-style bars / ramps / black + tone
(counterpart of phaneron_tpu/producer/test_pattern.py).

Replaces the reference's SDI capture producer where no DeckLink hardware
exists.  Emits real packed frames (v210 by default) so the full unpack
path is exercised; N animation phases are packed on the producer's
device at load by the port's ``make_pack_program`` (K2 for v210, B11 or
B13 for the planar formats) and cycled per frame at zero per-frame cost.
Audio is a 1 kHz tone (-18 dBFS) or silence.

A v210 frame is one interleaved (H, G*4) int32 word plane, the layout K1
reads (the JAX package caches word planes).  Cached frames are served
again every ``n_phases`` frames, so nothing may write into a payload.

URLs: BARS[@fmt] | RAMP[@fmt] | BLACK[@fmt], e.g. "BARS@yuv422p10le".
"""

from __future__ import annotations

import asyncio

import numpy as np
import torch

from ..audio.engine import QUANTUM
from ..config import VideoFormat
from ..graph.pipeline import make_pack_program
from ..ops.formats import FORMATS
from ..runtime.frame import AudioFrame, VideoFrame
from ..runtime.stream import END, Stream, from_generator
from .producer import InvalidProducerError, LoadParams, Producer

__all__ = ["create_test_pattern_producer"]

_PATTERNS = ("BARS", "RAMP", "BLACK")

# 100% colour bars, linear-light RGB
_BAR_COLOURS = np.array(
    [
        [1.0, 1.0, 1.0],
        [1.0, 1.0, 0.0],
        [0.0, 1.0, 1.0],
        [0.0, 1.0, 0.0],
        [1.0, 0.0, 1.0],
        [1.0, 0.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, 0.0],
    ],
    dtype=np.float32,
)


def _pattern_rgba(kind: str, width: int, height: int, phase: float, device) -> torch.Tensor:
    """Pattern values are constant across each horizontal pixel PAIR so
    the packed 4:2:2 output has chroma consistent with both lumas of a
    pair; mixed pairs would produce out-of-gamut (Y, C) combinations
    that saturate in the colour matrix and cannot round-trip.

    Built on the device: only a width-long row is computed, then
    broadcast.  ``phase`` is a float32 value; every step is the float32
    operation the JAX package does, so the frames are equal."""
    pairs = (width + 1) // 2
    px = torch.repeat_interleave(torch.arange(pairs, dtype=torch.int32, device=device) * 2, 2)[:width]
    pos = torch.remainder(px / width + phase, 1.0)
    if kind == "BARS":
        xs = (pos * 8).to(torch.int32).clamp(0, 7)
        row = torch.from_numpy(_BAR_COLOURS).to(device)[xs.long()].T  # (3, W)
    elif kind == "RAMP":
        row = pos.expand(3, width)
    else:
        row = torch.zeros((3, width), dtype=torch.float32, device=device)
    rgb = row[:, None, :].expand(3, height, width)
    alpha = torch.ones((1, height, width), dtype=torch.float32, device=device)
    return torch.cat([rgb, alpha])


class TestPatternProducer(Producer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        super().__init__(source_id, fmt)
        url = params.url.upper()
        if url == "DECKLINK":
            # SDI capture has no hardware here; DECKLINK URLs fall
            # through to bars so CasparCG rundowns still run
            url = "BARS"
        kind, _, pix = url.partition("@")
        if kind not in _PATTERNS:
            raise InvalidProducerError(f"not a test pattern: {params.url}")
        self.kind = kind
        self.pix_format = pix.lower() if pix else "v210"
        if self.pix_format not in FORMATS:
            raise InvalidProducerError(f"unknown pattern format {pix}")
        self.params = params
        self.n_phases = 1 if kind == "BLACK" else 16
        self._frames: list = []
        self.length = params.length

    async def initialise(self) -> None:
        def build():
            w, h = self.fmt.width, self.fmt.height
            pack = make_pack_program(self.pix_format, w, h, "709")
            for i in range(self.n_phases):
                phase = float(np.float32(i / max(self.n_phases * 8, 1)))
                self._frames.append(pack(_pattern_rgba(self.kind, w, h, phase, self.device)))
            if self.device.type == "cuda":  # this thread's stream: no device-wide wait during a graph capture
                torch.cuda.current_stream(self.device).synchronize()

        await asyncio.to_thread(build)

    def video_stream(self) -> Stream:
        async def gen():
            ts = self.params.seek
            while not self.released:
                if self.length is not None and ts - self.params.seek >= self.length:
                    break
                yield VideoFrame(
                    timestamp=ts,
                    format=self.pix_format,
                    payload=self._frames[ts % self.n_phases],
                    width=self.fmt.width,
                    height=self.fmt.height,
                    interlaced=self.fmt.interlaced,
                )
                ts += 1
            yield END

        return from_generator(gen)

    def audio_stream(self) -> Stream:
        rate = self.fmt.audio_sample_rate
        channels = self.fmt.audio_channels
        tone = self.kind != "BLACK"

        async def gen():
            pos = 0
            ts = 0
            while not self.released:
                if tone:
                    t = (pos + np.arange(QUANTUM)) / rate
                    wave = (0.125 * np.sin(2 * np.pi * 1000.0 * t)).astype(np.float32)
                    samples = np.broadcast_to(wave, (channels, QUANTUM)).copy()
                else:
                    samples = np.zeros((channels, QUANTUM), dtype=np.float32)
                yield AudioFrame(timestamp=ts, samples=samples, sample_rate=rate)
                pos += QUANTUM
                ts += 1
            yield END

        return from_generator(gen)


def create_test_pattern_producer(source_id, params, fmt) -> TestPatternProducer:
    return TestPatternProducer(source_id, params, fmt)
