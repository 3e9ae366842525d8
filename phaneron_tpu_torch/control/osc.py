"""OSC over UDP (reference src/osc/osc.ts:33-68).

Minimal OSC 1.0 codec (no external dependency): address + ',ifs' type
tags.  A UDP server maps control addresses to callbacks (hardware-panel
load/take buttons for the heads automation) and a client sends control
echoes / telemetry.

A copy of phaneron_tpu/control/osc.py (the port keeps its own, as it
imports nothing of the JAX package); ``start`` records the port it bound,
so port 0 asks the OS for a free one.
"""

from __future__ import annotations

import asyncio
import struct
from typing import Any, Callable, Optional

__all__ = ["Osc", "encode_message", "decode_message"]


def _pad(b: bytes) -> bytes:
    return b + b"\x00" * (4 - len(b) % 4 if len(b) % 4 else 0)


def _osc_str(s: str) -> bytes:
    return _pad(s.encode() + b"\x00")


def encode_message(address: str, *args: Any) -> bytes:
    tags = ","
    payload = b""
    for a in args:
        if isinstance(a, bool):
            a = int(a)
        if isinstance(a, int):
            tags += "i"
            payload += struct.pack(">i", a)
        elif isinstance(a, float):
            tags += "f"
            payload += struct.pack(">f", a)
        elif isinstance(a, str):
            tags += "s"
            payload += _osc_str(a)
        elif isinstance(a, bytes):
            tags += "b"
            payload += struct.pack(">i", len(a)) + _pad(a)
        else:
            raise TypeError(f"unsupported OSC arg {type(a)}")
    return _osc_str(address) + _osc_str(tags) + payload


def _read_str(data: bytes, off: int) -> tuple[str, int]:
    end = data.index(b"\x00", off)
    s = data[off:end].decode()
    off = end + 1
    off += (4 - off % 4) % 4
    return s, off


def decode_message(data: bytes) -> tuple[str, list[Any]]:
    address, off = _read_str(data, 0)
    args: list[Any] = []
    if off < len(data) and data[off : off + 1] == b",":
        tags, off = _read_str(data, off)
        for t in tags[1:]:
            if t == "i":
                args.append(struct.unpack_from(">i", data, off)[0])
                off += 4
            elif t == "f":
                args.append(struct.unpack_from(">f", data, off)[0])
                off += 4
            elif t == "s":
                s, off = _read_str(data, off)
                args.append(s)
            elif t == "b":
                n = struct.unpack_from(">i", data, off)[0]
                off += 4
                args.append(data[off : off + n])
                off += n + (4 - n % 4) % 4
    return address, args


class _Protocol(asyncio.DatagramProtocol):
    def __init__(self, osc: "Osc"):
        self.osc = osc

    def datagram_received(self, data: bytes, addr):
        try:
            address, args = decode_message(data)
        except Exception:
            return
        cb = self.osc.controls.get(address)
        if cb:
            cb({"address": address, "value": args[0] if args else None, "args": args})


class Osc:
    def __init__(
        self,
        listen_port: int = 9876,
        remote_address: str = "127.0.0.1",
        remote_port: int = 9877,
    ):
        self.listen_port = listen_port
        self.remote = (remote_address, remote_port)
        self.controls: dict[str, Callable[[dict], None]] = {}
        self._transport: Optional[asyncio.DatagramTransport] = None

    async def start(self) -> None:
        loop = asyncio.get_running_loop()
        self._transport, _ = await loop.create_datagram_endpoint(
            lambda: _Protocol(self), local_addr=("0.0.0.0", self.listen_port)
        )
        self.listen_port = self._transport.get_extra_info("sockname")[1]  # port 0: the OS's choice

    def add_control(self, address: str, callback: Callable[[dict], None]) -> None:
        self.controls[address] = callback

    def send_msg(self, address: str, *args: Any) -> None:
        if self._transport is not None:
            self._transport.sendto(encode_message(address, *args), self.remote)

    def close(self) -> None:
        if self._transport is not None:
            self._transport.close()
            self._transport = None
