"""Raw media file producer: headerless packed video (+ optional PCM)
(counterpart of phaneron_tpu/producer/raw_file.py).

The file-ingest role of the reference's FFmpegProducer
(producer/ffmpegProducer.ts) for environments without codec libraries:
plays raw v210 / yuv422p10le / yuv422p8 / yuv420p / nv12 / rgba8 frame
sequences with SEEK / LENGTH / LOOP semantics
(ffmpegProducer.ts:170-174,325-331), and CALL SEEK / LOOP at run time.

Geometry/format resolution, in order:
1. sidecar JSON `<file>.json`: {"format": "v210", "width": 1920,
   "height": 1080, "fps": 50, "interlaced": false,
   "audio": "<file>.pcm", "audio_channels": 8} — what the file consumer
   writes beside its output
2. filename convention `name.1920x1080.v210`
3. extension matching a known format + the channel's geometry

Ingest: a loader thread reads frame N+1 from the memmap into a pinned
host buffer and enqueues its upload to the producer's device
(``non_blocking``) while the channel composites frame N.  The planes keep
the format's host layout (v210: the interleaved (H, G*4) words as int32,
the layout the port's unpack takes).  Three pinned buffers rotate
(``utils/hostio.StagedUpload``), and a buffer is filled again only once
the event after its last upload has completed.  Looping sources within ``CACHE_BYTES`` keep their uploaded
frames on the device and replay them without host traffic.

Audio: optional side PCM file (float32 planar blocks per QUANTUM) or
silence.
"""

from __future__ import annotations

import asyncio
import json
import os
import time
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..audio.engine import QUANTUM, silence
from ..config import VideoFormat
from ..ops.formats import FORMATS, get_format
from ..runtime.frame import AudioFrame, VideoFrame
from ..runtime.stream import END, Stream, from_generator
from ..utils.hostio import StagedUpload
from .producer import InvalidProducerError, LoadParams, Producer

__all__ = ["RawFileProducer", "create_raw_file_producer"]


def _resolve(path: Path, fmt: VideoFormat, params: LoadParams):
    meta = {}
    sidecar = path.with_suffix(path.suffix + ".json")
    if sidecar.exists():
        meta = json.loads(sidecar.read_text())
    name_bits = path.name.split(".")
    pix = meta.get("format")
    width, height = meta.get("width"), meta.get("height")
    if pix is None and len(name_bits) >= 2 and name_bits[-1].lower() in FORMATS:
        pix = name_bits[-1].lower()
        if len(name_bits) >= 3 and "x" in name_bits[-2]:
            try:
                width, height = (int(v) for v in name_bits[-2].split("x"))
            except ValueError:
                pass
    if pix is None:
        raise InvalidProducerError(f"not a raw media file: {path}")
    width = width or params.extra.get("width") or fmt.width
    height = height or params.extra.get("height") or fmt.height
    return pix, int(width), int(height), meta


class RawFileProducer(Producer):
    # device-cache budget for looping sources (a 24-frame 1080i v210
    # stinger is about 130 MB)
    CACHE_BYTES = 512 * 1024 * 1024

    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        super().__init__(source_id, fmt)
        url = params.url
        if url.upper().startswith(("ROUTE://", "BARS", "RAMP", "BLACK", "HTTP")):
            raise InvalidProducerError("not a file path")
        self.path = Path(url)
        if not self.path.exists():
            raise InvalidProducerError(f"no such file: {url}")
        self.pix_format, self.width, self.height, self.meta = _resolve(self.path, fmt, params)
        self.params = params
        self.loop = params.loop
        self.interlaced = bool(self.meta.get("interlaced", False))
        if "fps" in self.meta:
            # source frame rate differs from the channel: the layer's
            # pull cadence repeats frames (25 fps on a 50 Hz channel
            # shows each frame twice, ffmpegProducer.ts:557-566)
            src_fps = float(self.meta["fps"])
            self.fmt = replace(self.fmt, fields=1, timescale=int(round(src_fps * 1000)), duration=1000)
        self._mm: np.memmap | None = None
        self._pending_seek: int | None = None
        self._device_cache: dict[int, list] = {}
        self._cache_ok = False
        self._uploader: StagedUpload | None = None

    def seek(self, frame: int) -> bool:
        self._pending_seek = frame
        return True

    def set_loop(self, loop: bool) -> bool:
        self.loop = loop
        return True

    async def initialise(self) -> None:
        fmt_mod = get_format(self.pix_format)
        self.plane_shapes = fmt_mod.plane_shapes(self.width, self.height)
        self.frame_bytes = sum(fmt_mod.num_bytes(self.width, self.height))
        size = os.path.getsize(self.path)
        self.num_frames = size // self.frame_bytes
        if self.num_frames == 0:
            raise InvalidProducerError(f"file smaller than one frame: {self.path}")
        self._mm = np.memmap(self.path, dtype=np.uint8, mode="r")
        await self._init_staging()

    async def _init_staging(self) -> None:
        """The device cache's budget check and the staging buffers, once
        ``plane_shapes``, ``frame_bytes`` and ``num_frames`` are known
        (pinning takes tens of ms a buffer: off the loop)."""
        self._cache_ok = self.loop and self.num_frames * self.frame_bytes <= self.CACHE_BYTES
        self._uploader = await asyncio.to_thread(
            StagedUpload, self.device, self.frame_bytes)

    def _read_frame(self, index: int, out: np.ndarray) -> None:
        """Frame ``index``'s bytes into ``out`` (the loader thread)."""
        off = index * self.frame_bytes
        out[:] = self._mm[off : off + self.frame_bytes]

    def _load_frame(self, index: int):
        """Read + upload one frame (runs on the loader thread: the host
        read and the upload of frame N+1 overlap the channel compositing
        frame N — the reference's load-queue overlap, io.ts:88-94): via a
        pinned buffer and an asynchronous copy on a CUDA device, as fresh
        tensors on the CPU.  Looping sources within the cache budget serve
        repeat passes from the device."""
        stamp = time.monotonic()
        cached = self._device_cache.get(index)
        if cached is not None:
            return cached, stamp
        planes = self._uploader(lambda out: self._read_frame(index, out), self.plane_shapes)
        if self._cache_ok:
            self._device_cache[index] = planes
        return planes, stamp

    def video_stream(self) -> Stream:
        seek = self.params.seek
        length = self.params.length

        async def gen():
            from concurrent.futures import ThreadPoolExecutor

            loop_ = asyncio.get_running_loop()
            pool = ThreadPoolExecutor(1, thread_name_prefix="rawfile-load")
            ts = 0
            idx = seek % self.num_frames if self.num_frames else 0
            remaining = length if length is not None else None
            fut = None
            fut_idx = -1
            try:
                while not self.released:
                    if self._pending_seek is not None:  # CALL SEEK (runtime)
                        idx = self._pending_seek % self.num_frames
                        self._pending_seek = None
                    if remaining is not None and remaining <= 0:
                        break
                    if idx >= self.num_frames:
                        if self.loop:
                            idx = seek % self.num_frames  # loop wrap re-seek
                        else:
                            break
                    if fut is None or fut_idx != idx:  # miss (start/seek)
                        fut = loop_.run_in_executor(pool, self._load_frame, idx)
                        fut_idx = idx
                    planes, stamp = await fut
                    # prefetch the successor while this frame composites
                    nxt = idx + 1
                    if nxt >= self.num_frames and self.loop:
                        nxt = seek % self.num_frames
                    if nxt < self.num_frames and (remaining is None or remaining > 1):
                        fut = loop_.run_in_executor(pool, self._load_frame, nxt)
                        fut_idx = nxt
                    else:
                        fut = None
                    yield VideoFrame(
                        timestamp=ts,
                        format=self.pix_format,
                        payload=planes,
                        width=self.width,
                        height=self.height,
                        interlaced=self.interlaced,
                        loadstamp=stamp,
                    )
                    ts += 1
                    idx += 1
                    if remaining is not None:
                        remaining -= 1
                yield END
            finally:
                pool.shutdown(wait=False)

        return from_generator(gen)

    def audio_stream(self) -> Stream:
        # sidecar may declare the PCM's own rate; the layer resamples
        rate = int(self.meta.get("audio_rate", self.fmt.audio_sample_rate))
        channels = self.fmt.audio_channels
        audio_path = self.meta.get("audio")
        pcm = None
        if audio_path:
            p = Path(audio_path)
            if not p.is_absolute():
                p = self.path.parent / p
            if p.exists():
                pcm = np.memmap(p, dtype=np.float32, mode="r")
                channels = int(self.meta.get("audio_channels", channels))

        async def gen():
            ts = 0
            off = 0
            while not self.released:
                if pcm is not None:
                    block = channels * QUANTUM
                    if off + block > len(pcm):
                        if self.loop:
                            off = 0
                        else:
                            break
                    chunk = np.asarray(pcm[off : off + block]).reshape(channels, QUANTUM)
                    off += block
                else:
                    chunk = silence(channels)
                yield AudioFrame(timestamp=ts, samples=chunk, sample_rate=rate)
                ts += 1
            yield END

        return from_generator(gen)


def create_raw_file_producer(source_id, params, fmt) -> RawFileProducer:
    return RawFileProducer(source_id, params, fmt)
