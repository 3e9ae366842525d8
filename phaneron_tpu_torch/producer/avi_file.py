"""AVI container producer: real-container ingest without codec libs
(counterpart of phaneron_tpu/producer/avi_file.py).

The reference ingests files through libavformat (probe -> stream select
-> geometry -> per-stream packet routing, producer/ffmpegProducer.ts:
98-168,321-391).  This producer does the same for the uncompressed-AVI
subset natively: container probing (utils/avi.read_avi), fourcc ->
format-library dispatch (v210 / BI_RGB->bgra8), embedded interleaved
PCM audio, SEEK/LOOP/LENGTH and the loader-thread prefetch inherited
from RawFileProducer: frames are read through the chunk table into a
pinned buffer (BI_RGB files stored bottom-up flipped on the way) and
uploaded ``non_blocking``.  MJPG chunks decode to rgba8 straight into
the pinned buffer in the codec process of ``utils/jpeg.py`` (Pillow
holds the GIL while it codes).  Compressed media still routes to the
FFmpeg producer (gated on a real binary) via the registry fallback chain
(producer/producer.ts:62-102 semantics).
"""

from __future__ import annotations

import asyncio
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..config import VideoFormat
from ..ops.formats import get_format
from ..runtime.stream import Stream
from ..utils.avi import read_avi
from ..utils.jpeg import EXACT_RGB, ImageSizeError, JpegProcess
from .producer import InvalidProducerError, LoadParams, Producer
from .raw_file import RawFileProducer
from .wav_file import pcm_stream

__all__ = ["AviProducer", "create_avi_producer"]

# MJPG is the one COMPRESSED fourcc decoded natively (PIL's baseline
# JPEG decoder, the same dependency the mjpeg HTTP producer uses) —
# real codec media plays with zero external binaries.  Reference codec
# dispatch breadth: ffmpegProducer.ts:393-466.
_FOURCC_FORMATS = {"v210": "v210", "BI_RGB": "bgra8", "MJPG": "rgba8"}


class AviProducer(RawFileProducer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        # bypass RawFileProducer.__init__ (its sidecar/extension
        # resolution); container headers are authoritative here
        Producer.__init__(self, source_id, fmt)
        url = params.url
        if not url.lower().endswith(".avi"):
            raise InvalidProducerError("not an AVI path")
        self.path = Path(url)
        if not self.path.exists():
            raise InvalidProducerError(f"no such file: {url}")
        try:
            self.info = read_avi(self.path)
        except ValueError as err:
            # compressed payloads fall through to the FFmpeg producer
            raise InvalidProducerError(f"unsupported AVI: {err}") from err
        vid = self.info.video
        if vid.fourcc not in _FOURCC_FORMATS:
            raise InvalidProducerError(f"no decoder for fourcc {vid.fourcc}")
        self._mjpg = vid.fourcc == "MJPG"
        if self._mjpg:
            try:
                from PIL import Image  # noqa: F401
            except Exception as err:  # pragma: no cover
                raise InvalidProducerError(f"PIL unavailable for MJPG decode: {err}") from err
        self.pix_format = _FOURCC_FORMATS[vid.fourcc]
        self.width, self.height = vid.width, vid.height
        self.meta: dict = {}
        self.params = params
        self.loop = params.loop
        self.interlaced = False
        if abs(vid.fps - fmt.fps / fmt.fields) > 1e-6:
            self.fmt = replace(self.fmt, fields=1, timescale=int(round(vid.fps * 1000)), duration=1000)
        self._mm: np.memmap | None = None
        self._pending_seek: int | None = None
        self._device_cache: dict[int, list] = {}
        self._cache_ok = False
        self._uploader = None
        self._codec: JpegProcess | None = None

    async def initialise(self) -> None:
        fmt_mod = get_format(self.pix_format)
        expect = sum(fmt_mod.num_bytes(self.width, self.height))
        vid = self.info.video
        if not self._mjpg:  # compressed chunks are variable-size
            bad = [s for _, s in vid.frames if s != expect]
            if bad:
                raise InvalidProducerError(
                    f"AVI frame size {bad[0]} != {expect} for "
                    f"{self.pix_format} {self.width}x{self.height}"
                )
        self.plane_shapes = fmt_mod.plane_shapes(self.width, self.height)
        self.num_frames = len(vid.frames)
        self.frame_bytes = expect  # MJPG: the decoded rgba8 frame
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        if self._mjpg:
            self._codec = JpegProcess()
            await asyncio.to_thread(self._codec.start)
        await self._init_staging()

    def _read_frame(self, index: int, out: np.ndarray) -> None:
        """Chunk-table addressing instead of raw_file's fixed stride (the
        loader thread): MJPG decodes into ``out``, bottom-up rows flip."""
        off, size = self.info.video.frames[index]
        chunk = self._mm[off : off + size]
        if self._mjpg:
            try:
                self._codec.decode(chunk, self.width, self.height, EXACT_RGB, out)
            except ImageSizeError as err:
                raise InvalidProducerError(
                    f"MJPG frame {err.size} != container {self.width}x{self.height}") from err
            return
        if not self.info.video.bottom_up:
            out[:] = chunk
            return
        pos = 0
        for shape, dtype in self.plane_shapes:
            n = int(np.prod(shape)) * dtype.itemsize
            rows = shape[0]
            out[pos : pos + n].reshape(rows, -1)[:] = chunk[pos : pos + n].reshape(rows, -1)[::-1]
            pos += n

    def audio_stream(self) -> Stream:
        aud = self.info.audio
        if aud is None:
            return super().audio_stream()  # meta empty -> silence
        mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        parts = []
        for off, size in aud.chunks:
            raw = mm[off : off + size]
            if aud.format_tag == 3:
                x = raw.view("<f4")
            elif aud.bits == 16:  # PCM int
                x = raw.view("<i2").astype(np.float32) / 32768.0
            else:
                x = raw.view("<i4").astype(np.float32) / 2147483648.0
            parts.append(x)
        inter = np.concatenate(parts)
        n = len(inter) // aud.channels
        pcm = inter[: n * aud.channels].reshape(n, aud.channels).T.copy()  # (src_channels, samples)
        return pcm_stream(self, pcm, aud.sample_rate)

    def release(self) -> None:
        super().release()
        if self._codec is not None:
            self._codec.close()  # a decode in flight finishes first


def create_avi_producer(source_id, params, fmt) -> AviProducer:
    return AviProducer(source_id, params, fmt)
