"""MJPEG HTTP streaming consumer — the cluster transport (counterpart of
phaneron_tpu/consumer/mjpeg_consumer.py).

Parity with the reference FFmpegConsumer (consumer/ffmpegConsumer.ts:
163-258): frames encode to JPEG and stream as multipart/x-mixed-replace
(mpjpeg) on an HTTP port; a peer server's producer ingests the stream.
Colour conversion and 8-bit packing run on the device
(``make_pack_program('rgba8', ..., 'sRGB')``, torch ops); the pack's copy
into a pinned host buffer is enqueued on the event loop, a worker thread
waits for its event and hands the bytes to an encoder process
(``utils/jpeg.py``), which makes the JPEG with Pillow (the reference used
libavcodec's mjpeg encoder on the CPU too): Pillow holds the GIL while it
encodes, which on a thread would stall the loop.  Without Pillow no JPEG
is made and nothing is streamed, as in the JAX package.
"""

from __future__ import annotations

import asyncio
from typing import Optional

from ..graph.pipeline import make_pack_program
from ..utils.hostio import copy_to_host, wait_copy
from ..utils.jpeg import JpegProcess
from .consumer import ChannelFrame, Consumer

__all__ = ["MJPEGConsumer"]

BOUNDARY = b"phaneronframe"


class MJPEGConsumer(Consumer):
    pix_format = None

    def __init__(self, params: dict | None = None):
        super().__init__(params)
        self.port = int(self.params.get("port", 3000))
        self.quality = int(self.params.get("quality", 85))
        self._clients: list[asyncio.StreamWriter] = []
        self._server: Optional[asyncio.AbstractServer] = None
        self._latest: Optional[ChannelFrame] = None
        self._task: Optional[asyncio.Task] = None
        self._buf = None  # one pinned buffer: the drain copies and encodes a frame at a time
        self._encoder = JpegProcess()
        self.dropped = 0
        self.sent = 0  # parts written to clients

    async def initialise(self, fmt) -> None:
        await super().initialise(fmt)
        self._pack = make_pack_program("rgba8", fmt.width, fmt.height, "sRGB")
        if self.device is not None:
            (self._buf,) = await self.host_buffers(fmt.width * fmt.height * 4, 1)
        self._server = await asyncio.start_server(self._handle, "0.0.0.0", self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # port 0: the OS's choice

    async def _handle(self, reader, writer):
        try:
            await reader.readline()
            while (await reader.readline()).strip():
                pass
            writer.write(
                b"HTTP/1.1 200 OK\r\n"
                b"Content-Type: multipart/x-mixed-replace; boundary=" + BOUNDARY + b"\r\n"
                b"Access-Control-Allow-Origin: *\r\n\r\n"
            )
            await writer.drain()
            self._clients.append(writer)
        except ConnectionResetError:
            writer.close()

    async def deliver(self, frame: ChannelFrame) -> None:
        """Latest-wins: keep the frame and return — the copy's wait and
        the JPEG encode run off the event loop in the drain task (the
        frame loop never stalls on a consumer)."""
        if frame.rgba is None or not self._clients:
            return
        if self._latest is not None:
            self.dropped += 1  # encoder slower than channel rate
        self._latest = frame
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._drain())

    def _encode(self, buf, nbytes: int, event) -> Optional[bytes]:
        """On a worker thread: wait for the copy, then the encoder process."""
        wait_copy(event)
        return self._encoder.encode(buf.numpy()[:nbytes], self.fmt.width, self.fmt.height, self.quality)

    async def _drain(self) -> None:
        while self._latest is not None:
            frame, self._latest = self._latest, None
            planes = self._pack(frame.rgba)  # device work only
            if self._buf is None:
                (self._buf,) = await self.host_buffers(planes[0].numel(), 1, planes[0].device)
            nbytes, event = copy_to_host(planes, self._buf)
            jpeg = await asyncio.to_thread(self._encode, self._buf, nbytes, event)
            del planes  # the copy is done: its source may be reused
            if jpeg is None:
                return
            part = (
                b"--" + BOUNDARY + b"\r\n"
                b"Content-Type: image/jpeg\r\n"
                + f"Content-Length: {len(jpeg)}\r\n\r\n".encode()
                + jpeg
                + b"\r\n"
            )
            dead = []
            for w in self._clients:
                try:
                    w.write(part)
                    await w.drain()
                    self.sent += 1
                except (ConnectionResetError, BrokenPipeError):
                    dead.append(w)
            for w in dead:
                self._clients.remove(w)
                w.close()

    def release(self) -> None:
        for w in self._clients:
            w.close()
        self._clients.clear()
        if self._server:
            self._server.close()
            self._server = None
        self._encoder.close()
