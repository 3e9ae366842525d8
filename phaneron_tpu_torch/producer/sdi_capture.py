"""SDI capture producer (counterpart of phaneron_tpu/producer/sdi_capture.py;
reference producer/macadamProducer.ts:66-264).

The mirror of the playout seam (consumer/sdi_consumer.py): the hardware
boundary is a ``backend`` object — a host-side C++ shim against the
DeckLink SDK in production, a fake in tests.  Everything ABOVE the seam
is the real producer logic:

- wire frames arrive as packed v210 (the DeckLink capture pixel format,
  macadamProducer.ts:100-116) and are uploaded, on a worker thread,
  through a pinned buffer as the interleaved (H, G*4) words (int32 bit
  views), the form every v210 producer uploads, so the channel unpack
  (K1) and the slot's pair deinterlace in runtime/layer.py run UNCHANGED
  (the reference's v210 read kernel -> send_field path,
  macadamProducer.ts:180-241);
- A/V pairing: each capture delivers its frame's audio with it (s32
  interleaved, the DeckLink wire form, macadamProducer.ts:142-156); the
  producer converts to planar f32 and rides it out the audio pipe in
  QUANTUM chunks, so dropped video drops its audio with it;
- cadence comes from the hardware: ``capture_frame`` resolves when the
  next frame lands on the input, so the pull loop is genlocked to the
  SDI source clock the way the reference's frame promise chain is.

Backend protocol (the macadam capture surface a shim must provide):
    await open(device_index, fmt)
    await capture_frame() -> (v210_bytes_or_words, audio_s32, hw_time)
                             | None on end-of-input
    close()

URLs: ``DECKLINK [DEVICE n]``.  The host registers a backend FACTORY
(set_capture_backend); without one the factory raises
InvalidProducerError so the registry falls through to the test-pattern
producer's bars — CasparCG rundowns keep running in environments with
no capture hardware.
"""

from __future__ import annotations

import asyncio
from collections import deque
from typing import Callable, Optional

import numpy as np

from ..audio.engine import QUANTUM
from ..config import VideoFormat
from ..ops.formats import get_format
from ..runtime.frame import AudioFrame, VideoFrame
from ..runtime.stream import END, Stream, from_generator
from ..utils.hostio import StagedUpload
from .producer import InvalidProducerError, LoadParams, Producer

__all__ = ["SDICaptureProducer", "create_sdi_capture_producer", "set_capture_backend"]

# factory(device_index: int, fmt: VideoFormat) -> backend | None
_capture_backend_factory: Optional[Callable] = None


def set_capture_backend(factory: Optional[Callable]) -> None:
    """Register the host's capture-hardware shim factory (None clears)."""
    global _capture_backend_factory
    _capture_backend_factory = factory


class SDICaptureProducer(Producer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat, backend):
        super().__init__(source_id, fmt)
        self.pix_format = "v210"
        self.backend = backend
        self.device_index = int(params.extra.get("device", 1))
        self.interlaced = fmt.interlaced
        self._audio_buf: deque = deque()
        self._audio_event = asyncio.Event()
        self._video_done = False
        self._uploader: StagedUpload | None = None

    async def initialise(self) -> None:
        v210 = get_format("v210")
        self.plane_shapes = v210.plane_shapes(self.fmt.width, self.fmt.height)
        nbytes = sum(v210.num_bytes(self.fmt.width, self.fmt.height))
        self._uploader = await asyncio.to_thread(StagedUpload, self.device, nbytes)
        await self.backend.open(self.device_index, self.fmt)

    def _upload(self, raw) -> list:
        """Wire frame (bytes, or a words array) -> its word plane on the
        device (a worker thread: the host copy and the upload never block
        the event loop)."""
        if not isinstance(raw, (bytes, bytearray, memoryview)):
            raw = np.ascontiguousarray(raw)
        data = np.frombuffer(raw, np.uint8)

        def fill(out: np.ndarray) -> None:
            out[:] = data

        return self._uploader(fill, self.plane_shapes)

    def _push_audio(self, audio_s32) -> None:
        """s32 interleaved (DeckLink wire form) -> planar f32 chunk."""
        ch = self.fmt.audio_channels
        x = np.asarray(audio_s32).reshape(-1)
        n = len(x) // ch
        planar = x[: n * ch].reshape(n, ch).T.astype(np.float32) / np.float32(2.0**31)
        self._audio_buf.append(planar)
        self._audio_event.set()

    def video_stream(self) -> Stream:
        async def gen():
            ts = 0
            while not self.released:
                cap = await self.backend.capture_frame()
                if cap is None:
                    break
                raw, audio_s32, _hw_time = cap
                payload = await asyncio.to_thread(self._upload, raw)
                if audio_s32 is not None:
                    self._push_audio(audio_s32)
                yield VideoFrame(
                    timestamp=ts,
                    format="v210",
                    payload=payload,
                    width=self.fmt.width,
                    height=self.fmt.height,
                    interlaced=self.interlaced,
                    tff=True,
                )
                ts += 1
            self._video_done = True
            self._audio_event.set()
            yield END

        return from_generator(gen)

    def audio_stream(self) -> Stream:
        channels = self.fmt.audio_channels
        rate = self.fmt.audio_sample_rate

        async def gen():
            ts = 0
            pending = np.zeros((channels, 0), dtype=np.float32)
            while not self.released:
                while pending.shape[1] < QUANTUM:
                    if self._audio_buf:
                        pending = np.concatenate([pending, self._audio_buf.popleft()], axis=1)
                        continue
                    if self._video_done or self.released:
                        break
                    self._audio_event.clear()
                    if self._audio_buf or self._video_done:
                        continue
                    await self._audio_event.wait()
                if pending.shape[1] < QUANTUM:
                    break
                chunk = pending[:, :QUANTUM]
                pending = pending[:, QUANTUM:]
                yield AudioFrame(timestamp=ts, samples=chunk, sample_rate=rate)
                ts += 1
            yield END

        return from_generator(gen)

    def release(self) -> None:
        super().release()
        self._audio_event.set()
        if self.backend is not None:
            self.backend.close()
            self.backend = None


def create_sdi_capture_producer(source_id, params, fmt) -> SDICaptureProducer:
    if params.url.upper() != "DECKLINK":
        raise InvalidProducerError("not a DECKLINK url")
    if _capture_backend_factory is None:
        raise InvalidProducerError("no SDI capture backend registered (falls through to bars)")
    backend = _capture_backend_factory(int(params.extra.get("device", 1)), fmt)
    if backend is None:
        raise InvalidProducerError("capture backend declined the device")
    return SDICaptureProducer(source_id, params, fmt, backend)
