"""FFmpeg encode consumer, gated on an ffmpeg binary (counterpart of
phaneron_tpu/consumer/ffmpeg_consumer.py).

The encode half of the reference's FFmpegConsumer
(consumer/ffmpegConsumer.ts:163-258): channel frames encode through an
ffmpeg subprocess to any container/codec/URL — file recording or a
stream another server ingests.  Without a binary the constructor raises
RuntimeError: the server reports it and keeps serving (the JAX server's
fallback to the file consumer is not ported, so nothing is silently
replaced).

The channel's RGBA frame is packed on the device to yuv422p10le
(``make_pack_program``, planar422_pack on a CUDA device); deliver()
enqueues the planes' copy into a pinned host buffer (``non_blocking``)
and its CUDA event on the event loop, and a drain task has a worker
thread wait for the event and crop each row to its unpadded width for
rawvideo, then writes the frame to the encoder's stdin.  Audio pipes to
a SECOND ffmpeg input as f32 interleaved PCM over an inherited fd
(pass_fds), muxed with ``-map`` (the reference filters audio but only
muxes video, ffmpegConsumer.ts:245 — this consumer completes that).  The
frame loop only enqueues (latest-wins for streams, bounded for files).
Audio writes are best-effort: an encoder that stops reading its audio
input sheds audio bytes rather than stalling video delivery.
"""

from __future__ import annotations

import asyncio
import contextlib
import fcntl
import os
import shutil
from typing import Optional

import numpy as np

from ..graph.pipeline import make_pack_program
from ..ops.formats import get_format
from ..utils.hostio import copy_to_host, host_planes, wait_copy
from .consumer import ChannelFrame, Consumer

__all__ = ["FFmpegConsumer", "ffmpeg_available"]

PIPE_FORMAT = "yuv422p10le"  # rawvideo-safe (rows cropped to the width)
AUDIO_HIGH_WATER = 2 * 1024 * 1024  # shed audio beyond this transport backlog


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None


class FFmpegConsumer(Consumer):
    pix_format = None  # packs its own pipe format from the RGBA frame
    needs_rgba = True
    QUEUE = 4  # frames between deliver and the drain

    def __init__(self, params: dict | None = None):
        super().__init__(params)
        if not ffmpeg_available():
            raise RuntimeError("no ffmpeg binary in this environment")
        self.url = self.params.get("url") or self.params.get("path", "out.nut")
        self.vcodec = self.params.get("vcodec", "ffv1")
        self.acodec = self.params.get("acodec", "pcm_s16le")
        self.container = self.params.get("container")
        self.realtime = bool(self.params.get("realtime", False))
        self.audio_enabled = bool(self.params.get("audio", True))
        self.proc: Optional[asyncio.subprocess.Process] = None
        self._q: asyncio.Queue = asyncio.Queue(maxsize=self.QUEUE)
        self._task: Optional[asyncio.Task] = None
        self._closing = False
        self._failed = False  # encoder died mid-recording: shed, don't stall
        self._aud_writer: Optional[asyncio.StreamWriter] = None
        # host buffers not in flight; at most QUEUE + 2 are made: the
        # queue's, the drain's and one awaiting a place in the queue
        self._free: list = []
        self.dropped = 0
        self.audio_dropped = 0
        self.bytes_written = 0  # video bytes written to the encoder
        self._finish_task: Optional[asyncio.Task] = None  # release: the encoder's inputs closed, it exited

    async def initialise(self, fmt) -> None:
        await super().initialise(fmt)
        self._pack = make_pack_program(PIPE_FORMAT, fmt.width, fmt.height, "709")
        args = [
            "ffmpeg", "-hide_banner", "-loglevel", "warning", "-y",
            "-f", "rawvideo", "-pix_fmt", "yuv422p10le",
            "-s", f"{fmt.width}x{fmt.height}",
            # interlaced channels deliver one full-height deinterlaced
            # frame per FIELD tick, so the pipe rate is the field rate
            "-r", f"{fmt.timescale}/{fmt.duration}",
            "-i", "pipe:0",
        ]
        aud_r = aud_w = None
        if self.audio_enabled:
            aud_r, aud_w = os.pipe()
            args += [
                "-f", "f32le",
                "-ar", str(fmt.audio_sample_rate),
                "-ac", str(fmt.audio_channels),
                "-i", f"pipe:{aud_r}",
                "-map", "0:v", "-map", "1:a",
                "-c:a", self.acodec,
            ]
        args += ["-c:v", self.vcodec]
        if self.container:
            args += ["-f", self.container]
        args.append(self.url)
        if self.device is not None:  # pinning takes tens of ms a buffer: off the loop
            self._free = await self.host_buffers(self._frame_bytes(fmt), self.QUEUE + 2)
        self.proc = await asyncio.create_subprocess_exec(
            *args,
            stdin=asyncio.subprocess.PIPE,
            stderr=asyncio.subprocess.DEVNULL,
            pass_fds=(aud_r,) if aud_r is not None else (),
        )
        if aud_r is not None:
            os.close(aud_r)  # the child owns its copy now
            loop = asyncio.get_running_loop()
            transport, protocol = await loop.connect_write_pipe(
                asyncio.streams.FlowControlMixin, os.fdopen(aud_w, "wb")
            )
            self._aud_writer = asyncio.StreamWriter(transport, protocol, None, loop)
        with contextlib.suppress(OSError, AttributeError):  # a frame in fewer writes (Linux)
            fcntl.fcntl(self.proc.stdin.get_extra_info("pipe").fileno(), fcntl.F_SETPIPE_SZ, 1 << 20)
        self._task = asyncio.create_task(self._drain())

    @staticmethod
    def _frame_bytes(fmt) -> int:
        return sum(get_format(PIPE_FORMAT).num_bytes(fmt.width, fmt.height))

    async def _buffer(self, device):
        if self._free:
            return self._free.pop()
        return (await self.host_buffers(self._frame_bytes(self.fmt), 1, device))[0]

    async def deliver(self, frame: ChannelFrame) -> None:
        if self.proc is None or self._closing or self._failed or frame.rgba is None:
            return
        if self.realtime and self._q.full():
            self.dropped += 1  # stream semantics: never stall
            return
        planes = self._pack(frame.rgba)  # device work only
        aud = None
        if self._aud_writer is not None and frame.audio is not None:
            # planar (ch, samples) f32 -> interleaved bytes
            aud = np.ascontiguousarray(np.asarray(frame.audio, dtype=np.float32).T).tobytes()
        buf = await self._buffer(planes[0].device)
        _, event = copy_to_host(planes, buf)
        # the planes stay referenced until the drain has seen the copy complete
        await self._q.put((buf, event, planes, aud))  # recording: honest backpressure

    def _to_bytes(self, buf, event, planes) -> memoryview:
        """On a worker thread: wait for the copy, then the rawvideo bytes,
        each plane's rows cropped to their unpadded widths."""
        wait_copy(event)
        w = self.fmt.width
        views = host_planes(buf, planes, copy=False)
        crops = [v[:, : (w if i == 0 else (w + 1) // 2)] for i, v in enumerate(views)]
        out = np.empty(sum(c.nbytes for c in crops), np.uint8)
        pos = 0
        for c in crops:
            out[pos : pos + c.nbytes].view(c.dtype).reshape(c.shape)[:] = c
            pos += c.nbytes
        return out.data

    def _write_audio(self, aud: Optional[bytes]) -> None:
        """Best-effort audio write: never blocks the video path.  An
        encoder ignoring its audio input just accumulates transport
        backlog, which we shed at the high-water mark."""
        w = self._aud_writer
        if w is None or aud is None:
            return
        try:
            if w.transport.get_write_buffer_size() > AUDIO_HIGH_WATER:
                self.audio_dropped += 1
                return
            w.write(aud)
        except (BrokenPipeError, ConnectionResetError, RuntimeError):
            pass

    async def _drain(self) -> None:
        proc = self.proc
        while True:
            item = await self._q.get()
            if item is None:
                break
            buf, event, planes, aud = item
            if not self._failed:  # encoder died: keep consuming so deliver() never blocks
                data = await asyncio.to_thread(self._to_bytes, buf, event, planes)
                try:
                    self._write_audio(aud)
                    proc.stdin.write(data)
                    await proc.stdin.drain()
                    self.bytes_written += data.nbytes
                except (BrokenPipeError, ConnectionResetError):
                    # mid-recording encoder death: flag it and keep draining
                    # (discarding) so deliver() returns immediately forever
                    self._failed = True
            else:
                await asyncio.to_thread(wait_copy, event)
            del planes, item
            self._free.append(buf)
        if proc.stdin:
            try:
                proc.stdin.close()
            except RuntimeError:
                pass
        if self._aud_writer is not None:
            try:
                self._aud_writer.close()
            except RuntimeError:
                pass

    def release(self) -> None:
        """Close the encoder's inputs once the frames queued so far are
        written (the queue's end mark waits for a place), then wait for it
        to finish: ``_finish_task``."""
        if self.proc is None or self._closing:
            return
        self._closing = True
        task, p = self._task, self.proc

        async def _finish():
            await self._q.put(None)
            if task is not None:
                await task  # drain the queue, close stdin+audio -> encoder EOF
            try:
                await asyncio.wait_for(p.wait(), timeout=10)
            except asyncio.TimeoutError:
                with contextlib.suppress(ProcessLookupError):
                    p.kill()
            t = getattr(p, "_transport", None)
            if t is not None:
                t.close()
            self.proc = None

        try:
            self._finish_task = asyncio.get_running_loop().create_task(_finish())
        except RuntimeError:  # no running loop: nothing can drain
            with contextlib.suppress(ProcessLookupError):
                p.kill()
            self.proc = None
