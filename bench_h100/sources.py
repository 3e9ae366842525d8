"""The cells' sources: clips and graphics made on the device from the
seed, served to the channels by a producer registered in their
ProducerRegistry.

Each source holds ``n`` distinct frames in its clip's own format and
size and serves them in turn, frame ``k`` at its ``k``-th pull, as the
test-pattern producer cycles its phases: nothing is made per tick.
YCbCr clips are uniformly random legal codes (10-bit for v210 and
yuv422p10le, 8-bit for yuv420p and nv12); a graphic is premultiplied
rgba8 whose alpha is 255 inside a box of the frame, falls off linearly
over ``soft`` pixels around it and is 0 elsewhere, its colour random
under that alpha.  Audio is seeded noise at -18 dBFS, ``n`` quanta
cycled.  Every plane of a source comes from one draw of a
``torch.Generator`` on the device, seeded from (seed, channel, layer,
slot).
"""

from __future__ import annotations

import asyncio
import functools
import hashlib

import numpy as np
import torch

from .reference.formats import INFO, pack_codes, planar_pitch, v210_pitch

__all__ = ["make_frames", "SourceBank", "source_seed"]

QUANTUM = 1024  # audio samples a quantum (the port's audio engine reads any length)


def source_seed(seed: int, *path) -> int:
    """A 63-bit seed for one source from the run's seed and its place."""
    h = hashlib.sha256(repr((int(seed),) + tuple(path)).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _legal(gen, shape, lo: int, hi: int, device) -> torch.Tensor:
    return torch.randint(lo, hi + 1, shape, generator=gen, device=device, dtype=torch.int32)


def _graphic(gen, n: int, width: int, height: int, box, soft: int, device) -> list:
    """n (H, W, 4) premultiplied rgba8 frames keyed by one soft-edged box
    (fractions of the frame: x0, y0, x1, y1)."""
    def ramp(size, lo, hi):
        x = torch.arange(size, dtype=torch.float32, device=device)
        a, b = lo * size, hi * size
        return torch.clamp(torch.minimum(x - a + soft, b - x + soft) / soft, 0.0, 1.0)

    alpha = ramp(height, box[1], box[3])[:, None] * ramp(width, box[0], box[2])[None, :]
    alpha = torch.round(alpha * 255.0)
    colour = torch.randint(0, 256, (n, height, width, 3), generator=gen, device=device).float()
    rgb = torch.round(colour * (alpha / 255.0)[None, :, :, None])
    px = torch.cat([rgb, alpha[None, :, :, None].expand(n, height, width, 1)], dim=-1)
    return [[f] for f in px.to(torch.uint8)]


def make_frames(fmt: str, width: int, height: int, n: int, seed: int, device,
                box=(0.0, 0.0, 1.0, 1.0), soft: int = 8) -> list:
    """n frames (each a list of planes as the program carries them) of one source."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if fmt == "rgba8":
        return _graphic(gen, n, width, height, box, soft, device)
    info = INFO[fmt]
    top = 1 << info.bits
    ylo, yhi = info.black, info.white  # legal luma
    clo, chi = top // 16, top - top // 16 - top // 64  # legal chroma: 64..960 or 16..240
    if fmt == "v210":
        p = v210_pitch(width)
        y = _legal(gen, (n, height, p), ylo, yhi, device)
        c = _legal(gen, (n, 2, height, p), clo, chi, device)
        return [pack_codes("v210", y[k], c[k, 0], c[k, 1], p) for k in range(n)]
    p, h2 = planar_pitch(width), (height + 1) // 2
    dtype = torch.uint16 if info.bits > 8 else torch.uint8
    if fmt == "yuv422p10le":
        y = _legal(gen, (n, height, p), ylo, yhi, device).to(dtype)
        c = _legal(gen, (n, 2, height, p // 2), clo, chi, device).to(dtype)
        return [[y[k], c[k, 0], c[k, 1]] for k in range(n)]
    y = _legal(gen, (n, height, p), ylo, yhi, device).to(dtype)
    if fmt == "yuv420p":
        c = _legal(gen, (n, 2, h2, p // 2), clo, chi, device).to(dtype)
        return [[y[k], c[k, 0], c[k, 1]] for k in range(n)]
    if fmt == "nv12":
        c = _legal(gen, (n, h2, p), clo, chi, device).to(dtype)
        return [[y[k], c[k]] for k in range(n)]
    raise KeyError(fmt)


class SourceBank:
    """Every source of a run by URL, with the producer factory that serves
    them.  ``add`` makes a source's frames; ``factory`` is a
    ProducerRegistry factory for the URLs ``add`` returned."""

    SCHEME = "SEEDED:"

    def __init__(self, n_frames: int):
        self.n_frames = n_frames
        self.sources: dict = {}  # url -> (format, width, height, frames, audio)

    def add(self, name: str, fmt: str, width: int, height: int, seed: int, device, **graphic) -> str:
        frames = make_frames(fmt, width, height, self.n_frames, seed, device, **graphic)
        rng = np.random.default_rng(seed)
        audio = (0.125 * rng.uniform(-1.0, 1.0, (self.n_frames, 8, QUANTUM))).astype(np.float32)
        url = self.SCHEME + name
        self.sources[url] = (fmt, width, height, frames, audio)
        return url

    def frame(self, url: str, k: int) -> list:
        """The planes the source serves at its k-th pull."""
        return self.sources[url][3][k % self.n_frames]

    def factory(self, source_id, params, channel_fmt):
        from phaneron_tpu_torch.producer.producer import InvalidProducerError

        if params.url not in self.sources:
            raise InvalidProducerError(f"not a benchmark source: {params.url}")
        return _producer_class()(source_id, channel_fmt, self.sources[params.url])


@functools.cache
def _producer_class():
    """The Producer subclass (the program is imported only when a run
    builds its channels)."""
    from phaneron_tpu_torch.producer.producer import Producer
    from phaneron_tpu_torch.runtime.frame import AudioFrame, VideoFrame
    from phaneron_tpu_torch.runtime.stream import END, from_generator

    class SeededProducer(Producer):
        def __init__(self, source_id, channel_fmt, source):
            super().__init__(source_id, channel_fmt)
            self.pix_format, self.width, self.height, self.frames, self.audio = source

        async def initialise(self) -> None:
            await asyncio.sleep(0)

        def video_stream(self):
            async def gen():
                k = 0
                while not self.released:
                    yield VideoFrame(timestamp=k, format=self.pix_format,
                                     payload=self.frames[k % len(self.frames)],
                                     width=self.width, height=self.height)
                    k += 1
                yield END

            return from_generator(gen)

        def audio_stream(self):
            rate = self.fmt.audio_sample_rate

            async def gen():
                k = 0
                while not self.released:
                    yield AudioFrame(timestamp=k, samples=self.audio[k % len(self.audio)], sample_rate=rate)
                    k += 1
                yield END

            return from_generator(gen)

    return SeededProducer
