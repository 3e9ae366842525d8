"""Raw file consumer: packed video frames to disk (+ audio WAV)
(counterpart of phaneron_tpu/consumer/file_consumer.py).

The file-writing role of the reference's FFmpegConsumer
(consumer/ffmpegConsumer.ts) without codec libraries: writes the
channel's packed planes verbatim (v210/yuv422p8/... — playable by any
raw-video tool and bit-comparable in tests) plus a standard WAV for the
mixed audio.  A sidecar JSON records geometry for the raw-file producer
to play back.  ``.avi`` paths wrap the same frames in a container
(``utils/avi.py AviWriter``) with embedded float PCM.

Egress keeps the reference's unload-queue overlap (io.ts:166-174):
deliver() enqueues, on the event loop, the copy of the frame's planes
into a pinned host buffer (``non_blocking``) and the CUDA event after
it, and returns; a fetch thread waits on the event and moves the bytes
into the native SPSC staging ring (``utils/hostio.StagingRing``) while a
writer thread drains ring -> disk.  The channel's frame loop never waits
for the card or the disk.  A frame in flight holds one pinned buffer and
its source planes until its copy has completed; there are at most
``DEPTH`` of them, and a full pool is the backpressure: 'block' waits for
a buffer off the loop (the channel goes late honestly), 'drop' counts the
frame in ``dropped`` and skips it.

An interlaced channel pairs its field ticks in the packed domain before
the copy (``Consumer._init_field_pairing``); the first field's audio
travels with the pair.
"""

from __future__ import annotations

import asyncio
import json
import queue
import threading
import wave
from pathlib import Path

import numpy as np

from ..ops.formats import get_format
from ..utils.hostio import StagingRing, copy_to_host, wait_copy
from .consumer import ChannelFrame, Consumer

__all__ = ["FileConsumer"]

_STOP = object()


class FileConsumer(Consumer):
    DEPTH = 32  # frames in flight between deliver and the ring (pinned buffers)
    PREALLOCATED = 4  # buffers made at initialise (one is in use at 25 frames a second)

    def __init__(self, params: dict | None = None):
        super().__init__(params)
        self.pix_format = self.params.get("format", "v210")
        self.path = Path(self.params.get("path", "channel_out.raw"))
        self.audio_path = self.params.get("audio_path")
        self.max_frames = self.params.get("max_frames")
        # queue-full policy: 'block' (archival: backpressure the channel,
        # honest lateness) or 'drop' (real-time: never stall the chain,
        # count the skipped frames — broadcast recording semantics)
        self.on_full = self.params.get("on_full", "block")
        self.dropped = 0
        self.join_fetch_s = float(self.params.get("join_fetch_s", 120.0))
        self.join_write_s = float(self.params.get("join_write_s", 30.0))
        self.leaked_threads = 0
        self.container_avi = False
        self.written = 0  # frames on disk (writer thread)
        self.bytes_written = 0
        self._avi = None
        self._fh = None
        self._wav = None
        self._frames = 0
        self._q: queue.Queue = queue.Queue()  # bounded by the buffer pool
        self._free: queue.Queue = queue.Queue()  # pinned buffers not in flight
        self._buffers = 0
        self._ring: StagingRing | None = None
        self._audio_q: queue.Queue = queue.Queue()
        self._threads: list[threading.Thread] = []
        self._stop = threading.Event()
        # set when the fetch thread can write no more ring frames (it
        # returned, or release abandoned it): the writer's exit gate
        self._fetch_done = threading.Event()

    async def initialise(self, fmt) -> None:
        await super().initialise(fmt)
        self.interlaced = fmt.interlaced
        if self.interlaced:
            # packed-domain field pairing (bit-identical, no re-encode,
            # the channel stays packed-only); 4:2:0 outputs pack the RGBA pair
            self._init_field_pairing(fmt)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.frame_bytes = sum(get_format(self.pix_format).num_bytes(fmt.width, fmt.height))
        self.container_avi = self.path.suffix.lower() == ".avi"
        if self.container_avi:
            from ..utils.avi import AviWriter

            if self.audio_path:
                raise ValueError(
                    "AVI output embeds its audio; audio_path sidecar WAV "
                    "is only for raw-file output"
                )
            fourcc = {"v210": "v210", "bgra8": "BI_RGB", "bgra": "BI_RGB"}.get(self.pix_format)
            if fourcc is None:
                raise ValueError(f"AVI container supports v210/bgra8, not {self.pix_format}")
            self._avi = AviWriter(
                self.path, fourcc, fmt.width, fmt.height,
                fmt.fps / (2 if fmt.interlaced else 1), self.frame_bytes,
                bit_count=32 if fourcc == "BI_RGB" else 20,
                audio_channels=fmt.audio_channels,
                audio_rate=fmt.audio_sample_rate,
            )
            self._fh = self._avi._fh  # non-None marks the consumer open
        else:
            self._fh = open(self.path, "wb")
            sidecar = {
                "format": self.pix_format,
                "width": fmt.width,
                "height": fmt.height,
                "fps": fmt.fps / (2 if fmt.interlaced else 1),
                "interlaced": fmt.interlaced,
            }
            Path(str(self.path) + ".json").write_text(json.dumps(sidecar))
        if self.audio_path:
            self._wav = wave.open(str(self.audio_path), "wb")
            self._wav.setnchannels(fmt.audio_channels)
            self._wav.setsampwidth(2)
            self._wav.setframerate(fmt.audio_sample_rate)

        if self.device is not None:
            for buf in await self.host_buffers(self.frame_bytes, self.PREALLOCATED):
                self._free.put(buf)
            self._buffers = self.PREALLOCATED
        self._ring = StagingRing(self.frame_bytes, slots=8)
        self._threads = [
            threading.Thread(target=self._fetch_loop, name="file-fetch", daemon=True),
            threading.Thread(target=self._write_loop, name="file-write", daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------ frame loop side

    async def _buffer(self, device):
        """A free host buffer, or a new one (made off the loop) while fewer
        than DEPTH exist; None when every buffer is in flight."""
        try:
            return self._free.get_nowait()
        except queue.Empty:
            if self._buffers >= self.DEPTH:
                return None
            self._buffers += 1
            return (await self.host_buffers(self.frame_bytes, 1, device))[0]

    async def deliver(self, frame: ChannelFrame) -> None:
        if self._fh is None or (self.max_frames and self._frames >= self.max_frames):
            return
        planes = frame.packed
        pcms = [self._audio_pcm(frame)]
        if self.interlaced:
            # two field-rate frames -> one interlaced frame
            # (macadamConsumer.ts:224-244 two-pass field packing); the
            # pair is device work, no host copy here.  The first field's
            # audio travels WITH the pending pair so a dropped video frame
            # drops both fields' audio (no A/V drift)
            pair = self._pair_field(frame, pcms[0])
            if pair is None:
                return
            planes, top_pcm = pair
            pcms = [top_pcm, pcms[0]]
        buf = await self._buffer(planes[0].device)
        if buf is None:
            if self.on_full == "drop":
                self.dropped += 1
                return
            # bounded backpressure off the event loop: the channel goes
            # late honestly instead of the loop waiting on the card or disk
            buf = await asyncio.to_thread(self._free.get)
        nbytes, event = copy_to_host(planes, buf)
        # audio rides WITH the video item: the fetch thread queues it just
        # before staging the frame, so the writer never sees a frame whose
        # audio hasn't arrived, and a dropped frame drops its audio too;
        # the planes stay referenced until the copy has completed
        self._q.put((buf, nbytes, event, planes, pcms))
        self._frames += 1

    def _audio_pcm(self, frame: ChannelFrame) -> bytes | None:
        if self.container_avi:
            # embedded float PCM chunks, interleaved per frame
            return np.ascontiguousarray(frame.audio.T, dtype="<f4").tobytes()
        if self._wav is None:
            return None
        pcm = np.clip(frame.audio.T, -1.0, 1.0 - 2**-15)
        return (pcm * 32767).astype("<i2").tobytes()

    # --------------------------------------------------------- worker side

    def _fetch_loop(self) -> None:
        """Copied frames -> the staging ring (the 'unload queue')."""
        try:
            self._fetch_impl()
        finally:
            # happens-after every ring write this thread will ever
            # make: the writer may now exit once the ring runs dry
            self._fetch_done.set()

    def _fetch_impl(self) -> None:
        while True:
            try:
                item = self._q.get(timeout=0.25)
            except queue.Empty:
                if self._stop.is_set():  # abandoned by release()
                    return
                continue
            if item is _STOP:
                return
            buf, nbytes, event, planes, pcms = item
            if not wait_copy(event, self._stop):
                return
            del planes, item  # the copy is done: the sources may be reused
            # audio FIRST, then the frame: the writer pairs them by
            # popping after a successful ring read
            for pcm in pcms:
                self._audio_q.put(pcm)
            data = buf.numpy()[:nbytes]
            while not self._ring.try_write(data):
                if self._stop.is_set():
                    return
                self._stop.wait(0.001)
            self._free.put(buf)

    def _write_loop(self) -> None:
        """Staging ring -> disk (+ audio, kept in frame order)."""
        while True:
            buf = self._ring.try_read() if self._ring else None
            if buf is None:
                # exit only once the FETCH side is done and the ring is
                # dry, so the fetch thread's last in-flight frame is kept
                if self._fetch_done.is_set():
                    return
                self._stop.wait(0.001)
                continue
            if self.container_avi:
                # audio was queued before the frame entered the fetch
                # pipeline (deliver order), so its chunks are ready;
                # interlaced writes carry both fields' audio
                pcm = b""
                for _ in range(2 if self.interlaced else 1):
                    try:
                        got = self._audio_q.get_nowait()
                    except queue.Empty:
                        break
                    pcm += got or b""
                self._avi.write_frame(buf.tobytes(), pcm or None)
            else:
                self._fh.write(buf)
                self._drain_audio()
            self.written += 1
            self.bytes_written += buf.size

    def _drain_audio(self) -> None:
        # audio arrives per delivered frame (per FIELD when interlaced —
        # both fields' audio belongs in the WAV), independent of video
        # ring pacing; drain everything queued, order preserved
        while True:
            try:
                pcm = self._audio_q.get_nowait()
            except queue.Empty:
                return
            if pcm and self._wav is not None:
                self._wav.writeframes(pcm)

    def release(self) -> None:
        if self._fh is None:
            return
        # drain: stop accepting, let the fetch thread finish the queue,
        # then the writer exits once the fetch is done AND the ring is dry
        self._q.put(_STOP)
        fetch = self._threads[0] if self._threads else None
        writer = self._threads[1] if len(self._threads) > 1 else None
        if fetch is not None:
            fetch.join(timeout=self.join_fetch_s)
            if fetch.is_alive():
                # fetch wedged past its budget: abort its spins and abandon
                # the drain — but NEVER close the ring/files under the live
                # thread (a use-after-free: empty output + in-thread crash)
                self._stop.set()
                self._fetch_done.set()  # writer may finish what arrived
                fetch.join(timeout=5)
        if writer is not None:
            writer.join(timeout=self.join_write_s)
        self.leaked_threads = sum(t.is_alive() for t in self._threads)
        self._threads = []
        if self.leaked_threads:
            # a wedged daemon thread still holds the ring and file
            # handles: leak them (process cleanup at exit) rather than
            # corrupt state under it; mark the consumer closed so the
            # channel stops delivering
            self._fh = None
            return
        if not self.container_avi:
            self._drain_audio()
        if self._ring is not None:
            self._ring.close()
            self._ring = None
        if self.container_avi:
            self._avi.close()  # patches RIFF/movi sizes + frame counts
        else:
            self._fh.close()
        self._fh = None
        if self._wav:
            self._wav.close()
            self._wav = None
