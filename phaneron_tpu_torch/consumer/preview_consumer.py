"""Web preview consumer: latest frame as raw RGBA over HTTP
(counterpart of phaneron_tpu/consumer/preview_consumer.py).

Parity with the reference ScreenConsumer's HTTP side
(consumer/screenConsumer.ts:85-92,218): the most recent frame is kept
packed as rgba8 (sRGB) and served at GET / with CORS headers so a web
page can poll it.  The monitor feed (naudiodon, screenConsumer.ts:73-80)
is served over HTTP: GET /audio.wav is an endless stereo s16 WAV stream a
browser <audio> tag plays live; /audio keeps the last raw chunk for
polling tools.

Latest wins: deliver keeps the newest frame and a drain task packs it on
the device (``make_pack_program('rgba8', ..., 'sRGB')``, torch ops),
enqueues its copy into a pinned host buffer and waits for the copy's
event on a worker thread.  Two buffers alternate: the one served and the
one in flight, so a copy never writes into bytes being served.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Optional

import numpy as np

from ..graph.pipeline import make_pack_program
from ..utils.hostio import copy_to_host, wait_copy
from .consumer import ChannelFrame, Consumer

__all__ = ["PreviewConsumer"]


class PreviewConsumer(Consumer):
    pix_format = None  # packs its own rgba8/sRGB from the RGBA frame

    def __init__(self, params: dict | None = None):
        super().__init__(params)
        self.port = int(self.params.get("port", 3001))
        self._last: Optional[np.ndarray] = None  # the served rgba8 bytes
        self._last_audio: Optional[bytes] = None
        self.last_timestamp: Optional[int] = None  # the served frame's channel tick
        self._server: Optional[asyncio.AbstractServer] = None
        self._latest: Optional[ChannelFrame] = None
        self._task: Optional[asyncio.Task] = None
        self._listeners: set[asyncio.Queue] = set()
        self._buffers: list = []

    async def initialise(self, fmt) -> None:
        await super().initialise(fmt)
        # sRGB gamma for display (screenConsumer.ts:128-133)
        self._pack = make_pack_program("rgba8", fmt.width, fmt.height, "sRGB")
        if self.device is not None:
            self._buffers = await self.host_buffers(fmt.width * fmt.height * 4, 2)
        self._server = await asyncio.start_server(self._handle, "0.0.0.0", self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # port 0: the OS's choice

    async def deliver(self, frame: ChannelFrame) -> None:
        if frame.rgba is None:
            return
        self._latest = frame  # latest-wins; the copy is awaited off the loop
        if self._task is None or self._task.done():
            self._task = asyncio.create_task(self._drain())

    async def _drain(self) -> None:
        while self._latest is not None:
            frame, self._latest = self._latest, None
            planes = self._pack(frame.rgba)  # device work only
            if not self._buffers:
                self._buffers = await self.host_buffers(planes[0].numel(), 2, planes[0].device)
            buf = self._buffers[1]  # the one not served
            nbytes, event = copy_to_host(planes, buf)
            await asyncio.to_thread(wait_copy, event)
            del planes  # the copy is done: its source may be reused
            self._buffers.reverse()
            self._last = buf.numpy()[:nbytes]
            self.last_timestamp = frame.timestamp
            self._last_audio = frame.audio.tobytes()
            if self._listeners:
                pcm = self._monitor_pcm(frame.audio)
                for q in list(self._listeners):
                    try:
                        q.put_nowait(pcm)
                    except asyncio.QueueFull:
                        # slow listener: drop oldest, keep the feed live
                        try:
                            q.get_nowait()
                        except asyncio.QueueEmpty:
                            pass
                        q.put_nowait(pcm)

    @staticmethod
    def _monitor_pcm(audio: np.ndarray) -> bytes:
        """(channels, n) float planar -> stereo s16 interleaved (the
        reference's 2-ch monitor mix, screenConsumer.ts:73-80)."""
        stereo = audio[:2] if audio.shape[0] >= 2 else np.repeat(audio, 2, axis=0)
        clipped = np.clip(stereo.T, -1.0, 1.0 - 2**-15)
        return (clipped * 32767).astype("<i2").tobytes()

    @staticmethod
    def _wav_stream_header(rate: int) -> bytes:
        """WAV header with maxed sizes: players treat it as endless."""
        return (
            b"RIFF" + struct.pack("<I", 0xFFFFFFFF) + b"WAVEfmt "
            + struct.pack("<IHHIIHH", 16, 1, 2, rate, rate * 4, 4, 16)
            + b"data" + struct.pack("<I", 0xFFFFFFFF)
        )

    async def _stream_audio(self, writer) -> None:
        q: asyncio.Queue = asyncio.Queue(maxsize=16)
        self._listeners.add(q)
        try:
            head = (
                "HTTP/1.1 200 OK\r\nContent-Type: audio/wav\r\n"
                "Access-Control-Allow-Origin: *\r\nConnection: close\r\n\r\n"
            )
            writer.write(head.encode())
            writer.write(self._wav_stream_header(self.fmt.audio_sample_rate))
            await writer.drain()
            while True:
                writer.write(await q.get())
                await writer.drain()
        except (ConnectionResetError, BrokenPipeError):
            pass
        finally:
            self._listeners.discard(q)
            writer.close()

    async def _handle(self, reader, writer):
        try:
            request = await reader.readline()
            while (await reader.readline()).strip():
                pass
            path = request.split()[1].decode() if len(request.split()) > 1 else "/"
            if path.startswith("/audio.wav"):
                await self._stream_audio(writer)
                return
            body = self._last_audio if path.startswith("/audio") else self._last
            if body is None:
                writer.write(b"HTTP/1.1 503 Service Unavailable\r\n\r\n")
            else:
                body = bytes(body)  # the transport may send after the buffer is reused
                head = (
                    "HTTP/1.1 200 OK\r\n"
                    "Content-Type: application/octet-stream\r\n"
                    f"Content-Length: {len(body)}\r\n"
                    f"X-Width: {self.fmt.width}\r\nX-Height: {self.fmt.height}\r\n"
                    "Access-Control-Allow-Origin: *\r\n\r\n"
                )
                writer.write(head.encode() + body)
            await writer.drain()
        except (ConnectionResetError, IndexError):
            pass
        finally:
            writer.close()

    def release(self) -> None:
        if self._server:
            self._server.close()
            self._server = None
