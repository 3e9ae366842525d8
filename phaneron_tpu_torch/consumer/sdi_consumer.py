"""SDI playout consumer (counterpart of phaneron_tpu/consumer/sdi_consumer.py;
reference consumer/macadamConsumer.ts).

The hardware seam is a ``backend`` object (a host-side C++ shim against
the DeckLink SDK in production, a fake in tests).  Everything ABOVE the
seam is the real consumer logic:

- interlaced formats pack FIELD PAIRS into one v210 output frame (the
  functional form of the reference's two write passes,
  macadamConsumer.ts:224-244), in the packed domain on the device
  (``Consumer._init_field_pairing``);
- the frame's planes are copied into a pinned host buffer
  (``non_blocking``, on the event loop) and a worker thread waits for the
  copy's CUDA event and takes the planes out as numpy arrays the backend
  owns (v210: (H, G*4) uint32 words), so the loop never waits for the
  card and nothing writes into the frame's tensors;
- audio converts fltp -> interleaved s32 per displayed frame
  (macadamConsumer.ts:135-158), both fields' chunks concatenated so
  A/V travel together;
- delivery paces against the BACKEND's hardware clock — the software
  genlock of macadamConsumer.ts:174-197 (waitHW): each frame waits for
  its slot on the output clock, and frames arriving more than half a
  period behind are counted late (the reference's late-frame warning,
  macadamConsumer.ts:186-193).

Backend protocol (the macadam surface the shim must provide):
    await open(device_index, fmt, keyer=False)
    hardware_time() -> float   # seconds on the output genlock clock
    await display_frame(host_planes, audio_s32, timestamp)
    close()
Without a backend the consumer validates config and raises at
initialise, which the registry reports cleanly.
"""

from __future__ import annotations

import asyncio

import numpy as np

from ..audio.engine import interleave_s32
from ..ops.formats import get_format
from ..utils.hostio import copy_to_host, host_planes, wait_copy
from .consumer import ChannelFrame, Consumer

__all__ = ["SDIConsumer"]


class SDIConsumer(Consumer):
    pix_format = "v210"

    def __init__(self, params: dict | None = None):
        super().__init__(params)
        self.device_index = int(self.params.get("device", 1))
        self.keyer = self.params.get("keyer", False)
        self.latency = self.params.get("latency", "normal")  # macadamConsumer.ts:32-50
        self.backend = self.params.get("backend")  # injected hardware shim
        self.late_frames = 0
        self._t0 = None  # hardware-clock origin of frame 0
        self._displayed = 0
        self._buf = None  # one host buffer: a frame is displayed before the next is copied

    async def initialise(self, fmt) -> None:
        await super().initialise(fmt)
        if self.backend is None:
            raise RuntimeError(
                "SDI output requires DeckLink hardware and a host SDI shim; "
                "none is present in this environment"
            )
        self.interlaced = fmt.interlaced
        if self.interlaced:
            # packed-domain field pairing (v210 rows pack independently:
            # bit-identical, no re-encode, the channel stays packed-only)
            self._init_field_pairing(fmt)
        # displayed-frame period: interlaced channels tick at field rate,
        # the wire carries one frame per two fields (config.ts:43-78)
        self.frame_period = fmt.duration / fmt.timescale * (2 if fmt.interlaced else 1)
        if self.device is not None:  # pinning takes tens of ms: at initialise, off the loop
            nbytes = sum(get_format(self.pix_format).num_bytes(fmt.width, fmt.height))
            (self._buf,) = await self.host_buffers(nbytes, 1)
        await self.backend.open(self.device_index, fmt, keyer=self.keyer)

    async def deliver(self, frame: ChannelFrame) -> None:
        planes = frame.packed
        audio = frame.audio
        if self.interlaced:
            pair = self._pair_field(frame, frame.audio)
            if pair is None:
                return
            planes, top_audio = pair
            audio = np.concatenate([top_audio, frame.audio], axis=1)
        nbytes = sum(p.numel() * p.element_size() for p in planes)
        if self._buf is None or self._buf.numel() < nbytes:
            (self._buf,) = await self.host_buffers(nbytes, 1, planes[0].device)
        _, event = copy_to_host(planes, self._buf)
        wire = await asyncio.to_thread(self._fetch, event, planes)
        await self._wait_hw()
        audio_s32 = interleave_s32(audio)
        await self.backend.display_frame(wire, audio_s32, frame.timestamp)
        self._displayed += 1

    def _fetch(self, event, planes) -> list[np.ndarray]:
        """On a worker thread: wait for the copy, then the planes as numpy
        arrays of their own."""
        wait_copy(event)
        return host_planes(self._buf, planes)

    async def _wait_hw(self) -> None:
        """Software genlock (macadamConsumer.ts:174-197): wait until this
        frame's slot on the backend's hardware clock; count (and never
        block on) frames that miss their slot by more than HALF a period
        — a frame later than that displays visibly off-cadence, so it is
        counted and the origin resyncs rather than compounding lateness
        (the reference's late-frame warning, macadamConsumer.ts:186-193).

        Backends may provide an awaitable ``wait_until(t)`` (a virtual
        clock in tests, a hardware wait in shims); otherwise the wait is
        an asyncio.sleep against ``hardware_time()``."""
        now = self.backend.hardware_time()
        if self._t0 is None:
            self._t0 = now
            return
        slot = self._t0 + self._displayed * self.frame_period
        if now + 1e-4 < slot:
            waiter = getattr(self.backend, "wait_until", None)
            if waiter is not None:
                await waiter(slot)
            else:
                await asyncio.sleep(slot - now)
        elif now > slot + 0.5 * self.frame_period:
            self.late_frames += 1
            # resync rather than compounding lateness forever
            self._t0 = now - self._displayed * self.frame_period

    def release(self) -> None:
        if self.backend is not None:
            self.backend.close()
