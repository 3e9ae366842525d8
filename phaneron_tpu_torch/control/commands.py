"""AMCP command registry (reference src/AMCP/commands.ts:37-68).

Commands are grouped into sets ('' for basic, 'MIXER' for mixer);
dispatch parses the optional group prefix, the channel-layer address
and forwards the remaining tokens.

A copy of phaneron_tpu/control/commands.py: the port keeps its own, as it
imports nothing of the JAX package.
"""

from __future__ import annotations

from typing import Awaitable, Callable

from .chan_layer import ChanLayer, chan_layer_from_string

__all__ = ["Commands", "CmdSet"]

CmdFn = Callable[[ChanLayer, list[str]], Awaitable[bool]]


class CmdSet:
    def __init__(self, group: str, entries: dict[str, CmdFn]):
        self.group = group
        self.entries = entries


class Commands:
    def __init__(self):
        self._groups: dict[str, dict[str, CmdFn]] = {}

    def add(self, cmd_set: CmdSet) -> None:
        self._groups.setdefault(cmd_set.group, {}).update(cmd_set.entries)

    async def process(self, tokens: list[str]) -> bool:
        if not tokens:
            return False
        head = tokens[0].upper()
        if head in self._groups and head != "":
            # group-prefixed: MIXER <chanLay> <CMD> <params...>
            if len(tokens) < 3:
                return False
            chan_lay = chan_layer_from_string(tokens[1])
            cmd = tokens[2].upper()
            fn = self._groups[head].get(cmd)
            if fn is None:
                return False
            return await fn(chan_lay, tokens[3:])
        fn = self._groups.get("", {}).get(head)
        if fn is None:
            return False
        chan_lay = chan_layer_from_string(tokens[1] if len(tokens) > 1 else None)
        return await fn(chan_lay, tokens[2:])
