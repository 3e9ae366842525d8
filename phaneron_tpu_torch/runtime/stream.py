"""Backpressured async stream plumbing (a copy of
phaneron_tpu/runtime/stream.py).

Reproduces the redioactive semantics the reference uses for every pipe
(SURVEY.md §2.6): bounded buffers, END/NIL sentinels, valve transforms,
zip/zip_each synchronisation, fork fan-out and spout sinks — as asyncio
primitives.  Host-side orchestration only; frame payloads are
device tensors flowing through these queues by reference.
"""

from __future__ import annotations

import asyncio
from typing import Any, AsyncIterator, Awaitable, Callable, Optional

__all__ = ["END", "NIL", "Stream", "from_generator", "is_value"]


class _End:
    def __repr__(self):
        return "<END>"


class _Nil:
    def __repr__(self):
        return "<NIL>"


END = _End()  # stream termination, propagates through every stage
NIL = _Nil()  # dropped by the framework (valve returning NIL filters)


def is_value(x: Any) -> bool:
    return x is not END and x is not NIL


class Stream:
    """A pull-driven async stream with a bounded prefetch buffer."""

    def __init__(self, it: AsyncIterator[Any], buffer_size: int = 2):
        self._it = it
        self._buffer_size = buffer_size
        self._queue: Optional[asyncio.Queue] = None
        self._task: Optional[asyncio.Task] = None
        self._ended = False

    def _ensure_pump(self):
        if self._queue is None:
            self._queue = asyncio.Queue(maxsize=self._buffer_size)
            self._task = asyncio.create_task(self._pump())

    async def _pump(self):
        try:
            async for item in self._it:
                await self._queue.put(item)
                if item is END:
                    return
            await self._queue.put(END)
        except asyncio.CancelledError:
            raise
        except Exception as exc:  # propagate to consumer
            await self._queue.put(exc)

    async def next(self) -> Any:
        """Pull the next value (skipping NILs); returns END at the end."""
        if self._ended:
            return END
        self._ensure_pump()
        while True:
            item = await self._queue.get()
            if isinstance(item, Exception):
                self._ended = True
                raise item
            if item is NIL:
                continue
            if item is END:
                self._ended = True
            return item

    def stop(self):
        """Cancel the pump; subsequent next() returns END."""
        self._ended = True
        if self._task is not None:
            self._task.cancel()

    # -------------------------------------------------------- combinators

    def valve(
        self, fn: Callable[[Any], Awaitable[Any]], buffer_size: int = 2, one_to_many: bool = False
    ) -> "Stream":
        """Transform each value; fn may return NIL to drop.  With
        one_to_many, fn returns an iterable of outputs (used for e.g.
        field-rate doubling, ffmpegProducer.ts:557-566)."""

        async def gen():
            while True:
                item = await self.next()
                if item is END:
                    out = await fn(END)
                    if one_to_many and out is not None and not isinstance(out, _End):
                        for o in out:
                            if o is not END:
                                yield o
                    yield END
                    return
                out = await fn(item)
                if one_to_many:
                    for o in out:
                        if o is END:
                            yield END
                            return
                        yield o
                else:
                    yield out

        return Stream(gen(), buffer_size)

    def map(self, fn: Callable[[Any], Any], buffer_size: int = 2) -> "Stream":
        async def afn(x):
            if x is END:
                return END
            return fn(x)

        return self.valve(afn, buffer_size)

    def zip(self, *others: "Stream", buffer_size: int = 2) -> "Stream":
        """Tuple-up one value from each stream; END when any ends
        (the reference's A/V zip, macadamConsumer.ts:291-295)."""

        async def gen():
            streams = (self, *others)
            while True:
                vals = await asyncio.gather(*(s.next() for s in streams))
                if any(v is END for v in vals):
                    yield END
                    return
                yield tuple(vals)

        return Stream(gen(), buffer_size)

    @staticmethod
    def zip_each(streams: list["Stream"], buffer_size: int = 2) -> "Stream":
        """Zip a (possibly changing-length) list into list values
        (combiner.ts zipEach over layer pipes)."""

        async def gen():
            while True:
                vals = await asyncio.gather(*(s.next() for s in streams))
                if any(v is END for v in vals):
                    yield END
                    return
                yield list(vals)

        return Stream(gen(), buffer_size)

    def fork(self, n: int, buffer_size: int = 2) -> list["Stream"]:
        """Fan one stream out to n consumers; each gets every value.
        Values are shared by reference (zero-copy, as the reference's
        refcounted fork, combiner.ts:339-359): no reader writes into a
        value it receives (consumer/consumer.py)."""
        queues = [asyncio.Queue(maxsize=buffer_size) for _ in range(n)]

        async def pump():
            while True:
                item = await self.next()
                await asyncio.gather(*(q.put(item) for q in queues))
                if item is END:
                    return

        task = asyncio.create_task(pump())

        def make(q):
            async def gen():
                while True:
                    item = await q.get()
                    yield item
                    if item is END:
                        return

            s = Stream(gen(), buffer_size)
            s._fork_task = task  # keep the pump alive
            return s

        return [make(q) for q in queues]

    async def spout(self, fn: Callable[[Any], Awaitable[None]]):
        """Consume the stream to its end (the sink stage)."""
        while True:
            item = await self.next()
            await fn(item)
            if item is END:
                return


def from_generator(gen_fn: Callable[[], AsyncIterator[Any]], buffer_size: int = 2) -> Stream:
    return Stream(gen_fn(), buffer_size)
