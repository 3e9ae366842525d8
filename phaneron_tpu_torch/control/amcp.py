"""AMCP TCP server (reference src/AMCP/server.ts:28-177).

Line-oriented CasparCG AMCP on :5250: `REQ <token>` prefixing,
`SWITCH 207|218|220` protocol-version emulation, PING/BYE/KILL, command
dispatch through the registry with version-shaped responses, and
`400 ERROR` (never an exception) for unknown/failed commands.

A copy of phaneron_tpu/control/amcp.py (the port keeps its own, as it
imports nothing of the JAX package); ``start`` records the port it bound,
so port 0 asks the OS for a free one.
"""

from __future__ import annotations

import asyncio
import re
from typing import Optional

from .commands import Commands
from .responses import STUB_COMMANDS, ResponseTables

__all__ = ["AMCPServer", "process_command"]

_TOKEN_RE = re.compile(r'"[^"]+"|""|\S+')


class AMCPServer:
    def __init__(self, commands: Commands, port: int = 5250, server=None):
        self.commands = commands
        self.port = port
        self.version = "218"
        self.responses = ResponseTables(server)
        self._server: Optional[asyncio.AbstractServer] = None
        self.on_kill = None  # callback for KILL

    async def process_command(self, tokens: list[str] | None, token: str = "") -> str:
        if not tokens:
            return "400 ERROR"
        head = tokens[0].upper()
        if head == "REQ" and len(tokens) >= 3:
            if tokens[2].upper() != "PING":
                return await self.process_command(tokens[2:], tokens[1])
            token = tokens[1]
            tokens = tokens[2:]
            head = tokens[0].upper()
        if head == "SWITCH" and len(tokens) >= 2:
            if tokens[1] in ("207", "218", "220"):
                self.version = tokens[1]
                return f"202 SWITCH {tokens[1]} OK"
            return "400 SWITCH ERROR"
        if head == "BYE":
            return "***BYE***"
        if head == "PING":
            pong = "PONG" + (f" {token}" if token else "")
            return pong
        if head == "KILL":
            return "202 KILL OK"

        response_fn = self.responses.lookup(self.version, head)
        if response_fn is not None:
            ok = await self.commands.process(tokens)
            if not ok and head not in STUB_COMMANDS:
                body = f"400 ERROR\r\n{' '.join(tokens)} NOT IMPLEMENTED"
                return f"RES {token} {body}" if token else body
            response = response_fn(tokens)
            if response:
                # 200-class multi-line data terminates with an empty line
                if response.startswith("200") and "\r\n" in response and not response.endswith("\r\n"):
                    response += "\r\n"
                return f"RES {token} {response}" if token else response
        body = f"400 ERROR\r\n{' '.join(tokens)}"
        return f"RES {token} {body}" if token else body

    async def _handle(self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter):
        try:
            while True:
                line = await reader.readline()
                if not line:
                    break
                text = line.decode(errors="replace").strip("\r\n")
                if not text:
                    continue
                result = await self.process_command(_TOKEN_RE.findall(text))
                if result == "***BYE***":
                    break
                writer.write((result + "\r\n").encode())
                await writer.drain()
                if result == "202 KILL OK":
                    if self.on_kill:
                        self.on_kill()
                    break
        except (ConnectionResetError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()

    async def start(self) -> str:
        self._server = await asyncio.start_server(self._handle, "0.0.0.0", self.port)
        self.port = self._server.sockets[0].getsockname()[1]  # port 0: the one the OS chose
        return f"phaneron_tpu_torch AMCP protocol running on port {self.port}"

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
