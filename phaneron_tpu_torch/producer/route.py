"""ROUTE producer: pull another channel (or layer) as a source,
in-process and zero-copy (counterpart of phaneron_tpu/producer/route.py;
reference producer/routeProducer.ts:51-132).

Whole-channel routes tap the frame program's RGBA output (``route_pipes``
of runtime/channel.py: attaching the tap makes the routed channel emit
its rgba frame); the frames stay on the device and the route holds one
more reference to the same tensors, which nothing writes into
(consumer/consumer.py, frame ownership).  A channel on another device
gets them copied without a host wait (``Channel._pin``).  Layer routes
tap that layer's source frames."""

from __future__ import annotations

import re
from typing import Callable, Optional

from ..config import VideoFormat
from ..runtime.stream import Stream
from .producer import InvalidProducerError, LoadParams, Producer

__all__ = ["make_route_factory"]

_ROUTE_RE = re.compile(r"^route://(\d+)(?:-(\d+))?$", re.IGNORECASE)


class RouteProducer(Producer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat, channel, layer):
        super().__init__(source_id, fmt)
        self.channel = channel
        self.layer = layer
        self._video: Optional[Stream] = None
        self._audio: Optional[Stream] = None

    async def initialise(self) -> None:
        video, audio, pix_format = self.channel.route_pipes(self.layer)
        self._video, self._audio = video, audio
        self.pix_format = pix_format

    def video_stream(self) -> Stream:
        return self._video

    def audio_stream(self) -> Stream:
        return self._audio

    def release(self) -> None:
        super().release()
        if self._video:
            self._video.stop()
        if self._audio:
            self._audio.stop()


def make_route_factory(get_channel: Callable[[int], object]):
    """Factory bound to the server's channel registry (the reference's
    exported channels[] global, index.ts:137)."""

    def factory(source_id: str, params: LoadParams, fmt: VideoFormat) -> RouteProducer:
        m = _ROUTE_RE.match(params.url.strip())
        if not m:
            raise InvalidProducerError("not a route url")
        chan_num = int(m.group(1))
        layer = int(m.group(2)) if m.group(2) else None
        channel = get_channel(chan_num)
        if channel is None:
            raise InvalidProducerError(f"no channel {chan_num} to route")
        return RouteProducer(source_id, params, fmt, channel, layer)

    return factory
