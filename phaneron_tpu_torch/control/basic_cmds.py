"""Basic AMCP command set (reference src/AMCP/basicCmds.ts:28-250):
LOADBG/LOAD/PLAY/PAUSE/RESUME/STOP/CLEAR/ADD/REMOVE with LOOP/AUTO/
SEEK n/LENGTH n parsing, plus CasparCG transition tokens
(CUT/MIX/WIPE duration [mask]) which the reference only reaches via
its heads automation.

A copy of phaneron_tpu/control/basic_cmds.py: the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

import re
from typing import Optional

from ..producer.producer import LoadParams
from ..runtime.types import TransitionSpec
from .chan_layer import ChanLayer
from .commands import CmdSet

__all__ = ["BasicCmds"]


def parse_config_params(params: list[str]) -> dict:
    """k/v tail parsing for ADD (basicCmds.ts:56-70)."""
    out: dict = {}
    text = " ".join(params)
    for m in re.finditer(r"(?P<name>[^-\s]+)(\s+(?P<value>[^\s]+))?", text):
        if m.group("value"):
            v = m.group("value")
            try:
                out[m.group("name").lower()] = int(v)
            except ValueError:
                out[m.group("name").lower()] = v.lower()
    return out


def _parse_load(params: list[str]) -> tuple[LoadParams, Optional[TransitionSpec]]:
    url = params[0].strip('"') if params else ""
    upper = [p.upper() for p in params]

    def flag(name):
        return name in upper

    def value(name, default=None):
        try:
            i = upper.index(name)
            return params[i + 1]
        except (ValueError, IndexError):
            return default

    seek = int(value("SEEK", 0) or 0)
    length_raw = value("LENGTH")
    length = int(length_raw) if length_raw else None

    transition: Optional[TransitionSpec] = None
    for tok, ttype in (("MIX", "dissolve"), ("DISSOLVE", "dissolve"), ("WIPE", "wipe"), ("CUT", "cut")):
        if tok in upper[1:]:
            i = upper.index(tok)
            dur = 0
            mask = None
            if i + 1 < len(params):
                try:
                    dur = int(params[i + 1])
                except ValueError:
                    dur = 0
            if ttype == "wipe" and i + 2 < len(params) and not params[i + 2].isdigit():
                mask = params[i + 2].strip('"')
            transition = TransitionSpec(ttype, dur, mask)
            break

    extra = {}
    device_raw = value("DEVICE")  # PLAY 1-1 DECKLINK DEVICE 2
    if device_raw is not None:
        try:
            extra["device"] = int(device_raw)
        except ValueError:
            pass
    lp = LoadParams(
        url=url,
        loop=flag("LOOP"),
        auto_play=flag("AUTO"),
        seek=seek,
        length=length,
        extra=extra,
    )
    return lp, transition


class BasicCmds:
    def __init__(self, channels: dict[int, object], consumer_registry):
        self.channels = channels
        self.consumer_registry = consumer_registry

    def list(self) -> CmdSet:
        return CmdSet(
            "",
            {
                "LOADBG": self.loadbg,
                "LOAD": self.load,
                "PLAY": self.play,
                "PAUSE": self.pause,
                "RESUME": self.resume,
                "STOP": self.stop,
                "CLEAR": self.clear,
                "ADD": self.add,
                "REMOVE": self.remove,
                "SWAP": self.swap,
                "CALL": self.call,
            },
        )

    def _channel(self, chan_lay: ChanLayer):
        if not chan_lay.valid:
            return None
        return self.channels.get(chan_lay.channel)

    async def _do_load(self, chan_lay: ChanLayer, params: list[str], preview: bool) -> bool:
        channel = self._channel(chan_lay)
        if channel is None or not params:
            return False
        lp, transition = _parse_load(params)
        return await channel.load_source(
            chan_lay.layer, lp, preview=preview, auto_play=lp.auto_play, transition=transition
        )

    async def loadbg(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        return await self._do_load(chan_lay, params, preview=False)

    async def load(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        return await self._do_load(chan_lay, params, preview=True)

    async def play(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        if channel is None:
            return False
        if params:
            if not await self.loadbg(chan_lay, params):
                return False
        return channel.play(chan_lay.layer)

    async def pause(self, chan_lay: ChanLayer, _params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        return bool(channel and channel.pause(chan_lay.layer))

    async def resume(self, chan_lay: ChanLayer, _params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        return bool(channel and channel.resume(chan_lay.layer))

    async def stop(self, chan_lay: ChanLayer, _params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        return bool(channel and channel.stop(chan_lay.layer))

    async def clear(self, chan_lay: ChanLayer, _params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        if channel is None:
            return False
        return channel.clear(chan_lay.layer if chan_lay.layer else None)

    async def add(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        if channel is None or not params:
            return False
        name = params[0].lower()
        if name in ("file", "stream"):
            name = {"file": "file", "stream": "mjpeg"}[name]
        try:
            consumer = self.consumer_registry.create(name, parse_config_params(params[1:]))
            consumer.index = chan_lay.layer or 0
            await channel.add_consumer(consumer)
        except Exception as err:  # registry/initialise failures -> 400
            print(f"Error adding consumer to channel {chan_lay.channel}: {err}")
            return False
        return True

    async def remove(self, chan_lay: ChanLayer, _params: list[str]) -> bool:
        channel = self._channel(chan_lay)
        if channel is None:
            return False
        return channel.remove_consumer(chan_lay.layer or 0)

    async def call(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        """CALL 1-1 SEEK n | LOOP 0/1: runtime producer control
        (CasparCG AMCP; the reference stubs CALL)."""
        channel = self._channel(chan_lay)
        if channel is None or len(params) < 2:
            return False
        layer = channel.layers.get(chan_lay.layer)
        if layer is None or layer.cur is None:
            return False
        producer = layer.cur.producer
        op = params[0].upper()
        if op == "SEEK":
            return producer.seek(int(params[1]))
        if op == "LOOP":
            return producer.set_loop(params[1] not in ("0", "false", "FALSE"))
        if op in ("HIGHPASS", "ADELAY", "ACOMPRESSOR"):
            # enable a filter from the reference's per-source audio
            # graph (mixer.ts:146 ships them permanently disabled):
            # CALL 1-1 HIGHPASS 120 | ADELAY 480 | ACOMPRESSOR 0.2 4
            # | <name> OFF
            mixer = layer.cur.mixer
            if params[1].upper() == "OFF":
                return mixer.clear_audio_filter(op.lower())
            try:
                if op == "HIGHPASS":
                    return mixer.set_audio_filter(
                        "highpass", frequency=float(params[1])
                    )
                if op == "ADELAY":
                    return mixer.set_audio_filter("adelay", samples=int(params[1]))
                kwargs = {"threshold": float(params[1])}
                if len(params) > 2:
                    kwargs["ratio"] = float(params[2])
                return mixer.set_audio_filter("acompressor", **kwargs)
            except ValueError:
                return False
        return False

    async def swap(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        """SWAP: exchange two layers (CasparCG AMCP; the reference stubs
        it — implemented here for client compatibility)."""
        channel = self._channel(chan_lay)
        if channel is None or not params:
            return False
        from .chan_layer import chan_layer_from_string

        other = chan_layer_from_string(params[0])
        other_channel = self.channels.get(other.channel) if other.valid else None
        if other_channel is None:
            return False
        if other_channel.fmt != channel.fmt:
            return False  # layers are bound to the channel format
        a, b = chan_lay.layer, other.layer
        la = channel.layers.pop(a, None)
        lb = other_channel.layers.pop(b, None)
        if la is not None:
            other_channel.layers[b] = la
        if lb is not None:
            channel.layers[a] = lb
        return True
