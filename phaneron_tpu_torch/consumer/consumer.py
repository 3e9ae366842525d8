"""Consumer base and registry (counterpart of
phaneron_tpu/consumer/consumer.py; reference consumer/consumer.ts:30-153).

A consumer attaches to a channel and receives one ChannelFrame per tick:
the packed planes in the channel's primary format, optionally the
composited RGBA (when the consumer packs its own format), and the mixed
audio chunk.  Registry maps name -> factory with add/remove index
bookkeeping (ADD/REMOVE commands, basicCmds.ts:189-219).

**Frame ownership.**  Tensors are mutable where JAX arrays are not, so
the runtime keeps one rule: nothing writes into a tensor it was handed
or has handed on.  A ChannelFrame's ``packed`` and ``rgba`` are made for
that tick; no later tick, program or consumer writes into them, and a
consumer that keeps a frame past its ``deliver`` may read it as long as
it likes.  The same holds for what a frame is built from and shared
with: producers serve cached frames again (the test patterns every 16
ticks), ROUTE and layer taps pass source and output tensors on without a
copy, and the frame program reads its params without writing them.  A
frame program that writes its outputs into buffers of its own (a
replayed CUDA graph) must copy them into fresh tensors before it returns
a frame, or keep a buffer out of reuse until every consumer is done
with it.
"""

from __future__ import annotations

import asyncio
from abc import ABC, abstractmethod
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np

from ..config import VideoFormat
from ..graph.pipeline import make_interlaced_pack_program, make_interlaced_word_pack_program
from ..utils.hostio import host_buffer

__all__ = ["ChannelFrame", "Consumer", "ConsumerRegistry"]


@dataclass
class ChannelFrame:
    timestamp: int
    packed: Optional[list]  # planes in the channel's primary out format
    rgba: Optional[Any]  # (4, H, W) device tensor when emitted
    audio: np.ndarray  # (channels, samples_per_frame) f32
    width: int = 0
    height: int = 0
    packed_format: str = "v210"
    loadstamp: Optional[float] = None  # earliest source ingest time
    # (end-to-end latency metric)


class Consumer(ABC):
    """One output endpoint.  pix_format None means the consumer needs
    the RGBA frame and packs/encodes itself; needs_rgba forces RGBA
    delivery even when the packed format matches (interlaced packing)."""

    pix_format: Optional[str] = "v210"
    needs_rgba: bool = False

    def __init__(self, params: dict[str, Any] | None = None):
        self.params = params or {}
        self.index: int = 0
        self._pending_field = None  # (field frame, payload) awaiting pair
        self._word_pair = None
        self._pack_pair = None
        self.dropped_fields = 0  # fields discarded for a missing form
        # the device of the frames it is handed: Channel.add_consumer sets
        # it before initialise (None: known at the first frame)
        self.device = None

    async def initialise(self, fmt: VideoFormat) -> None:
        self.fmt = fmt

    def _init_field_pairing(self, fmt: VideoFormat) -> None:
        """Set up two-field -> one-interlaced-frame pairing for deliver.

        Row-independent formats (sub_y == 1) pair in the PACKED domain
        (make_interlaced_word_pack_program, bit-identical to the RGBA
        re-encode, no RGBA emit needed); others set needs_rgba and pack
        the merged RGBA pair (macadamConsumer.ts:224-244).  Neither has
        anything to compile: the JAX package's prewarm of them has no
        counterpart."""
        self._word_pair = make_interlaced_word_pack_program(self.pix_format)
        if self._word_pair is None:
            self.needs_rgba = True
            self._pack_pair = make_interlaced_pack_program(
                self.pix_format, fmt.width, fmt.height, "709"
            )

    def _pair_field(self, frame: ChannelFrame, payload: Any):
        """Feed one field-rate frame; returns (planes, top_payload) when
        a pair completes, None while the top field pends or the frame
        lacks the required form (counted in dropped_fields)."""
        field = frame.packed if self._word_pair is not None else frame.rgba
        if field is None:
            self.dropped_fields += 1
            return None
        if self._pending_field is None:
            self._pending_field = (field, payload)
            return None
        top, top_payload = self._pending_field
        self._pending_field = None
        if self._word_pair is not None:
            planes = self._word_pair(top, field)
        else:
            planes = self._pack_pair(top, field)
        return planes, top_payload

    async def host_buffers(self, nbytes: int, count: int, device=None) -> list:
        """``count`` host buffers for frames of ``device`` (default: the
        consumer's), made on a worker thread: pinning memory takes tens of
        milliseconds a buffer, which would stall the event loop."""
        return await asyncio.to_thread(
            lambda: [host_buffer(nbytes, device or self.device) for _ in range(count)]
        )

    @abstractmethod
    async def deliver(self, frame: ChannelFrame) -> None: ...

    def release(self) -> None:
        pass


class ConsumerRegistry:
    def __init__(self):
        self.factories: dict[str, Callable[[dict], Consumer]] = {}

    def register(self, name: str, factory: Callable[[dict], Consumer]) -> None:
        self.factories[name] = factory
        # aliases as in the reference: file/stream -> ffmpeg (basicCmds.ts:195)

    def create(self, name: str, params: dict[str, Any] | None = None) -> Consumer:
        key = name.lower()
        if key not in self.factories:
            raise KeyError(f"unknown consumer '{name}'")
        return self.factories[key](params or {})
