"""MJPEG HTTP stream producer — the cluster ingest side (counterpart of
phaneron_tpu/producer/mjpeg.py).

Pairs with consumer/mjpeg_consumer.py to form the phaneron->phaneron
cluster transport (the reference pairs ffmpegConsumer's mpjpeg HTTP
output with a remote ffmpegProducer demuxing it, SURVEY.md §2.7 P8).
Reads multipart/x-mixed-replace JPEG parts over HTTP on the event loop;
a worker thread has each part decoded to rgba8 (resized to the channel's
size at Pillow's default filter where it differs) by the codec process
of ``utils/jpeg.py`` straight into a pinned buffer, and uploads it
``non_blocking`` to the producer's device.  The decode runs in a process
because Pillow holds the GIL while it codes, which on a thread would
stall the loop that paces every channel.

URLs: http://host:port/...
"""

from __future__ import annotations

import asyncio
import time
from urllib.parse import urlparse

from ..audio.engine import silence
from ..config import VideoFormat
from ..ops.formats import get_format
from ..runtime.frame import AudioFrame, VideoFrame
from ..runtime.stream import END, Stream, from_generator
from ..utils.hostio import StagedUpload
from ..utils.jpeg import FIT_RGB, JpegProcess
from .producer import InvalidProducerError, LoadParams, Producer

__all__ = ["MJPEGProducer", "create_mjpeg_producer"]


class MJPEGProducer(Producer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        super().__init__(source_id, fmt)
        url = params.url
        if not url.lower().startswith(("http://", "https://")):
            raise InvalidProducerError("not an http url")
        try:
            from PIL import Image  # noqa: F401
        except ImportError as err:
            raise InvalidProducerError(f"PIL unavailable for mjpeg decode: {err}")
        self.url = urlparse(url)
        self.params = params
        self.pix_format = "rgba8"
        self._reader: asyncio.StreamReader | None = None
        self._writer: asyncio.StreamWriter | None = None
        self._boundary: bytes | None = None
        self._codec = JpegProcess()
        self._uploader: StagedUpload | None = None

    async def initialise(self) -> None:
        host = self.url.hostname or "127.0.0.1"
        port = self.url.port or 80
        try:
            self._reader, self._writer = await asyncio.wait_for(asyncio.open_connection(host, port), timeout=5)
        except (OSError, asyncio.TimeoutError) as err:
            raise InvalidProducerError(f"mjpeg connect failed: {err}")
        path = self.url.path or "/"
        self._writer.write(f"GET {path} HTTP/1.1\r\nHost: {host}\r\nConnection: keep-alive\r\n\r\n".encode())
        await self._writer.drain()
        # parse response headers for the multipart boundary
        status = await self._reader.readline()
        if b"200" not in status:
            raise InvalidProducerError(f"mjpeg http status: {status!r}")
        while True:
            line = await self._reader.readline()
            if not line.strip():
                break
            if b"boundary=" in line.lower():
                self._boundary = line.split(b"boundary=")[1].strip()
        if self._boundary is None:
            raise InvalidProducerError("mjpeg response is not multipart")
        w, h = self.fmt.width, self.fmt.height
        self.plane_shapes = get_format(self.pix_format).plane_shapes(w, h)
        self._uploader = await asyncio.to_thread(StagedUpload, self.device, w * h * 4)
        await asyncio.to_thread(self._codec.start)

    async def _next_jpeg(self) -> bytes | None:
        """Read one multipart part body."""
        length = None
        # skip to boundary, read part headers
        while True:
            line = await self._reader.readline()
            if not line:
                return None
            if line.strip().endswith(self._boundary):
                break
        while True:
            line = await self._reader.readline()
            if not line:
                return None
            if not line.strip():
                break
            if line.lower().startswith(b"content-length:"):
                length = int(line.split(b":")[1])
        if length is None:
            return None
        return await self._reader.readexactly(length)

    def _decode_upload(self, jpeg: bytes, w: int, h: int):
        """JPEG -> rgba8 plane on the device (a worker thread: the decode
        runs in the codec process, the upload from a pinned buffer)."""
        stamp = time.monotonic()
        planes = self._uploader(lambda out: self._codec.decode(jpeg, w, h, FIT_RGB, out), self.plane_shapes)
        return planes, stamp

    def video_stream(self) -> Stream:
        w, h = self.fmt.width, self.fmt.height
        length_limit = self.params.length

        async def gen():
            ts = 0
            while not self.released:
                if length_limit is not None and ts >= length_limit:
                    break
                try:
                    jpeg = await self._next_jpeg()
                except (asyncio.IncompleteReadError, ConnectionResetError):
                    break
                if jpeg is None:
                    break
                payload, stamp = await asyncio.to_thread(self._decode_upload, jpeg, w, h)
                yield VideoFrame(timestamp=ts, format="rgba8", payload=payload, width=w, height=h,
                                 loadstamp=stamp)
                ts += 1
            yield END

        return from_generator(gen)

    def audio_stream(self) -> Stream:
        channels = self.fmt.audio_channels

        async def gen():
            ts = 0
            while not self.released:
                yield AudioFrame(timestamp=ts, samples=silence(channels), sample_rate=self.fmt.audio_sample_rate)
                ts += 1
            yield END

        return from_generator(gen)

    def release(self) -> None:
        super().release()
        if self._writer is not None:
            self._writer.close()
            self._writer = None
        self._codec.close()  # a decode in flight finishes first


def create_mjpeg_producer(source_id, params, fmt) -> MJPEGProducer:
    return MJPEGProducer(source_id, params, fmt)
