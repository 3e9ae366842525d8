"""Native WAV audio producer: audio beds with zero codec binaries
(counterpart of phaneron_tpu/producer/wav_file.py).

The reference plays audio files through FFmpeg, substituting black
video at the channel rate for the missing video stream
(ffmpegProducer.ts:213-246 silence handling; the audio-only black
pacing mirrored from the port's gated FFmpeg producer).  This producer
covers the PCM-WAV subset natively via the stdlib ``wave`` module —
`PLAY 1-1 bed.wav` works in an environment with no ffmpeg — and falls
through the registry chain for anything else.  The black frame is
uploaded once, at initialise, as the format's planes on the producer's
device (v210: the interleaved (H, G*4) words as int32).
"""

from __future__ import annotations

import asyncio
import wave
from pathlib import Path

import numpy as np

from ..audio.engine import QUANTUM
from ..config import VideoFormat
from ..graph.convert import to_tensor
from ..ops.formats import get_format
from ..runtime.frame import AudioFrame, VideoFrame
from ..runtime.stream import END, Stream, from_generator
from .producer import InvalidProducerError, LoadParams, Producer

__all__ = ["WavProducer", "black_planes", "create_wav_producer", "decode_pcm", "pcm_stream"]


def decode_pcm(raw: bytes, sampwidth: int, channels: int) -> np.ndarray:
    """WAV sample bytes (8, 16, 24 or 32 bit) -> (channels, samples)
    float32 planar."""
    if sampwidth == 1:  # WAV 8-bit is unsigned
        x = (np.frombuffer(raw, np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 2:
        x = np.frombuffer(raw, "<i2").astype(np.float32) / 32768.0
    elif sampwidth == 3:  # packed 24-bit
        b = np.frombuffer(raw, np.uint8).reshape(-1, 3)
        i = b[:, 0].astype(np.int32) | (b[:, 1].astype(np.int32) << 8) | (b[:, 2].astype(np.int32) << 16)
        i = np.where(i >= 1 << 23, i - (1 << 24), i)
        x = i.astype(np.float32) / float(1 << 23)
    else:
        x = np.frombuffer(raw, "<i4").astype(np.float32) / 2147483648.0
    n = len(x) // channels
    return x[: n * channels].reshape(n, channels).T.copy()  # (channels, samples) planar


def black_planes(pix_format: str, width: int, height: int, device) -> list:
    """True-black codes, NOT zeros (zero YUV decodes below black with an
    extreme chroma excursion), as the format's planes on ``device``."""
    return [to_tensor(p, device) for p in get_format(pix_format).black_buf(width, height)]


def pcm_stream(producer: Producer, pcm: np.ndarray, rate: int, done: asyncio.Event | None = None) -> Stream:
    """(channels, samples) float32 PCM as QUANTUM chunks at ``rate``, up-mapped
    by repetition to the channel's count (or cut to it), looping while
    ``producer.loop``; sets ``done`` when the audio ends."""
    channels = producer.fmt.audio_channels

    async def gen():
        total = pcm.shape[1]
        ts = 0
        off = 0
        while not producer.released:
            if off + QUANTUM > total:
                if producer.loop and total >= QUANTUM:
                    off = 0
                else:
                    break
            chunk = pcm[:, off : off + QUANTUM]
            if chunk.shape[0] < channels:  # up-map by repetition
                reps = -(-channels // chunk.shape[0])
                chunk = np.tile(chunk, (reps, 1))[:channels]
            else:
                chunk = chunk[:channels]
            off += QUANTUM
            yield AudioFrame(timestamp=ts, samples=chunk, sample_rate=rate)
            ts += 1
        if done is not None:
            done.set()
        yield END

    return from_generator(gen)


class WavProducer(Producer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        super().__init__(source_id, fmt)
        url = params.url
        if not url.lower().endswith(".wav"):
            raise InvalidProducerError("not a WAV path")
        self.path = Path(url)
        if not self.path.exists():
            raise InvalidProducerError(f"no such file: {url}")
        try:
            with wave.open(str(self.path), "rb") as wf:
                self.src_channels = wf.getnchannels()
                self.sample_rate = wf.getframerate()
                self.sampwidth = wf.getsampwidth()
                self.num_samples = wf.getnframes()
        except (wave.Error, EOFError) as err:
            raise InvalidProducerError(f"unsupported WAV: {err}") from err
        if self.sampwidth not in (1, 2, 3, 4):
            raise InvalidProducerError(f"unsupported sample width {self.sampwidth}")
        self.loop = params.loop
        self.width, self.height = fmt.width, fmt.height
        self.interlaced = False
        self._audio_done = asyncio.Event()

    async def initialise(self) -> None:
        def load() -> tuple:
            with wave.open(str(self.path), "rb") as wf:
                raw = wf.readframes(self.num_samples)
            black = black_planes(self.pix_format, self.width, self.height, self.device)
            return decode_pcm(raw, self.sampwidth, self.src_channels), black

        self._pcm, self._black = await asyncio.to_thread(load)

    def video_stream(self) -> Stream:
        """Black frames at the channel rate until the audio ends — the
        reference's audio-only substitution."""

        async def gen():
            ts = 0
            while not self.released and not self._audio_done.is_set():
                yield VideoFrame(
                    timestamp=ts, format=self.pix_format, payload=self._black,
                    width=self.width, height=self.height,
                )
                ts += 1
                await asyncio.sleep(0)
            yield END

        return from_generator(gen)

    def audio_stream(self) -> Stream:
        return pcm_stream(self, self._pcm, self.sample_rate, self._audio_done)


def create_wav_producer(source_id, params, fmt) -> WavProducer:
    return WavProducer(source_id, params, fmt)
