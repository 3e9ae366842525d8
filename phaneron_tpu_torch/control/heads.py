"""Heads rundown automation (reference src/heads/heads.ts:63-165).

A JSON rundown of events, each loading sources (with optional
transitions) onto channel layers; the next event preloads (LOADBG)
while the current one plays; advance is frame-accurate, counted against
the event's duration on a designated tick layer; OSC controls trigger
(re)load and take.

A copy of phaneron_tpu/control/heads.py: the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

import asyncio
import json
from pathlib import Path
from typing import Optional

from ..producer.producer import LoadParams
from ..runtime.types import TransitionSpec
from .osc import Osc

__all__ = ["Heads"]


class Heads:
    def __init__(self, osc: Osc, channel, controls: Optional[dict] = None):
        self.osc = osc
        self.channel = channel
        self.spec: Optional[dict] = None
        self.last_spec: Optional[str] = None
        self.event_index = 0
        self.running = False
        self._tick_task: Optional[asyncio.Task] = None
        controls = controls or {}
        if controls.get("load"):
            osc.add_control(controls["load"], self._osc_load)
        if controls.get("take"):
            osc.add_control(controls["take"], self._osc_take)

    def _osc_load(self, msg: dict) -> None:
        if msg.get("value"):
            spec = msg["value"] if isinstance(msg["value"], str) else self.last_spec
            if spec:
                asyncio.get_event_loop().create_task(self.load_spec(spec))

    def _osc_take(self, msg: dict) -> None:
        if msg.get("value"):
            asyncio.get_event_loop().create_task(self.next())

    async def load_spec(self, url_or_json: str) -> bool:
        """Load a rundown from a JSON string or file path, idempotently
        (heads.ts:90-106), and preload the first event."""
        try:
            self.spec = json.loads(url_or_json)
        except json.JSONDecodeError:
            path = Path(url_or_json)
            if not path.exists():
                print(f"Heads: no such spec {url_or_json}")
                return False
            self.spec = json.loads(path.read_text())
        self.last_spec = url_or_json
        self.event_index = 0
        self.running = False
        if self._tick_task:
            self._tick_task.cancel()
        await self._load_event(0, preview=True)
        return True

    def _transition(self, layer_spec: dict) -> Optional[TransitionSpec]:
        tr = layer_spec.get("transition")
        if not tr:
            return None
        return TransitionSpec(tr.get("type", "cut"), tr.get("length", 0), tr.get("url"))

    async def _load_event(self, index: int, preview: bool) -> None:
        if self.spec is None or index >= len(self.spec.get("events", [])):
            return
        event = self.spec["events"][index]
        for lay in event.get("layers", []):
            params = LoadParams(
                url=lay["url"],
                seek=lay.get("seek", 0),
                length=lay.get("length"),
            )
            await self.channel.load_source(
                lay["layerNum"],
                params,
                preview=preview,
                transition=self._transition(lay),
            )

    async def run(self) -> None:
        """Start the rundown: play event 0 and preload event 1."""
        if self.spec is None:
            return
        self.running = True
        await self._play_event(0)

    async def _play_event(self, index: int) -> None:
        if self.spec is None:
            return
        events = self.spec.get("events", [])
        if index >= len(events):
            self.running = False
            return
        self.event_index = index
        event = events[index]
        for lay in event.get("layers", []):
            self.channel.play(lay["layerNum"])
        # preload the next event's sources in the background
        if index + 1 < len(events):
            await self._load_event(index + 1, preview=False)
        # frame-accurate advance: count channel frames against duration
        duration = int(event.get("duration", 0))
        if duration > 0:
            if self._tick_task:
                self._tick_task.cancel()
            self._tick_task = asyncio.create_task(self._advance_after(duration))

    async def _advance_after(self, frames: int) -> None:
        start = self.channel.timestamp
        period = self.channel.fmt.duration / self.channel.fmt.timescale
        while self.channel.timestamp - start < frames:
            await asyncio.sleep(period)
        if self.running:
            await self.next()

    async def next(self) -> None:
        """Take: advance to the next event (heads.ts next)."""
        if self.spec is None:
            return
        await self._play_event(self.event_index + 1)
