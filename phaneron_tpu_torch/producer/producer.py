"""Producer base, factory chain and registry (counterpart of
phaneron_tpu/producer/producer.py).

Parity with the reference's producer framework (producer/producer.ts:
36-103): factories try a URL in order and throw InvalidProducerError to
pass to the next; the registry binds the winning producer to a channel
layer.  A producer makes its frames on the channel's device, which the
channel passes to ``create_source`` (``cuda`` by default) and the
registry sets as ``producer.device`` before ``initialise``.
"""

from __future__ import annotations

from abc import ABC, abstractmethod
from typing import Any, Callable, Optional

import torch

from ..config import VideoFormat
from ..runtime.stream import Stream

__all__ = ["InvalidProducerError", "Producer", "ProducerRegistry", "LoadParams"]


class InvalidProducerError(Exception):
    """Factory rejection: this URL is not ours (producer.ts:53-60)."""


class LoadParams:
    """LOADBG/PLAY parameters (chanLayer.ts:39-50)."""

    def __init__(
        self,
        url: str,
        loop: bool = False,
        auto_play: bool = False,
        seek: int = 0,
        length: Optional[int] = None,
        extra: Optional[dict[str, Any]] = None,
    ):
        self.url = url
        self.loop = loop
        self.auto_play = auto_play
        self.seek = seek
        self.length = length
        self.extra = extra or {}


class Producer(ABC):
    """A bound source delivering video/audio pipes (routeSource.ts:26-35)."""

    def __init__(self, source_id: str, fmt: VideoFormat):
        self.source_id = source_id
        self.fmt = fmt
        self.pix_format: str = "v210"
        self.device = torch.device("cuda")  # where its frames live (create_source sets it)
        self.paused = False
        self._released = False

    @abstractmethod
    async def initialise(self) -> None: ...

    @abstractmethod
    def video_stream(self) -> Stream: ...

    @abstractmethod
    def audio_stream(self) -> Stream: ...

    def set_paused(self, paused: bool) -> None:
        self.paused = paused

    def seek(self, frame: int) -> bool:
        """Runtime seek (AMCP CALL SEEK); producers without random
        access return False."""
        return False

    def set_loop(self, loop: bool) -> bool:
        """Runtime loop toggle (AMCP CALL LOOP)."""
        return False

    def release(self) -> None:
        self._released = True

    @property
    def released(self) -> bool:
        return self._released


Factory = Callable[[str, LoadParams, VideoFormat], "Producer"]


class ProducerRegistry:
    """Tries each factory in order (producer.ts:75-102)."""

    def __init__(self, factories: list[Factory]):
        self.factories = factories

    async def create_source(
        self, source_id: str, params: LoadParams, channel_format: VideoFormat,
        device: torch.device | str = "cuda",
    ) -> Optional[Producer]:
        for factory in self.factories:
            try:
                producer = factory(source_id, params, channel_format)
            except InvalidProducerError:
                continue
            producer.device = torch.device(device)
            try:
                await producer.initialise()
                return producer
            except InvalidProducerError:
                continue
        print(f"Failed to find producer for {params.url}")
        return None
