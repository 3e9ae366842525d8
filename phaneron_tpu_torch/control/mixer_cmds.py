"""MIXER command set (reference src/AMCP/mixerCmds.ts:25-80):
ANCHOR/FILL/ROTATION/VOLUME, set and query forms.

A copy of phaneron_tpu/control/mixer_cmds.py: the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

from .chan_layer import ChanLayer
from .commands import CmdSet

__all__ = ["MixerCmds"]


class MixerCmds:
    def __init__(self, channels: dict[int, object]):
        self.channels = channels

    def list(self) -> CmdSet:
        return CmdSet(
            "MIXER",
            {
                "ANCHOR": self.anchor,
                "FILL": self.fill,
                "ROTATION": self.rotation,
                "VOLUME": self.volume,
            },
        )

    def _layer(self, chan_lay: ChanLayer):
        if not chan_lay.valid:
            return None
        channel = self.channels.get(chan_lay.channel)
        if channel is None or chan_lay.layer not in channel.layers:
            return None
        return channel.layers[chan_lay.layer]

    async def anchor(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        layer = self._layer(chan_lay)
        if layer is None:
            return False
        if not params:  # query form prints current values (layer.ts:266)
            print(f"anchor={layer.query('anchor')}")
            return True
        if len(params) < 2:
            return False
        return layer.set_anchor(float(params[0]), float(params[1]))

    async def fill(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        layer = self._layer(chan_lay)
        if layer is None:
            return False
        if not params:
            print(f"fill={layer.query('fill')}")
            return True
        if len(params) < 4:
            return False
        x, y, sx, sy = (float(p) for p in params[:4])
        return layer.set_fill(x, y, sx, sy)

    async def rotation(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        layer = self._layer(chan_lay)
        if layer is None:
            return False
        if not params:
            print(f"rotation={layer.query('rotation')}")
            return True
        # AMCP gives clockwise degrees; the matrix builder takes turns
        return layer.set_rotation(float(params[0]) / 360.0)

    async def volume(self, chan_lay: ChanLayer, params: list[str]) -> bool:
        layer = self._layer(chan_lay)
        if layer is None:
            return False
        if not params:
            print(f"volume={layer.query('volume')}")
            return True
        return layer.set_volume(float(params[0]))
