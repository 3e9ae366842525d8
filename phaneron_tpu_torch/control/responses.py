"""CasparCG protocol-version response emulation.

The reference ships canned per-version response tables
(src/AMCP/cmdResponses.ts:27-196, testResponses.ts) so existing
CasparCG clients get plausible answers for commands phaneron doesn't
implement — a protocol-level fake backend (SURVEY.md §4.2).  Same
approach here: three tables (2.0.7 / 2.1.8 / 2.2.0) with implemented
commands answering for real and stubs for the rest, plus live INFO
built from actual channel state (the reference stubs INFO; SURVEY.md
§5.5 calls for real responses).

A copy of phaneron_tpu/control/responses.py (the port keeps its own, as it
imports nothing of the JAX package); DIAG prints the port tracer's spans
and counters (``utils/metrics.py tracer``) and the memory census,
``device_memory_stats`` of each channel's device.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

__all__ = ["ResponseTables", "STUB_COMMANDS"]

# Commands answerable purely from the emulation tables — no runtime
# implementation required (protocol-level fake backend, SURVEY.md §4.2).
# The reference's own dispatch 400s these; answering is strictly more
# CasparCG-client-compatible.
STUB_COMMANDS = {
    "VERSION", "CLS", "TLS", "FLS", "CINF", "INFO", "THUMBNAIL", "DATA",
    "CG", "LOG", "SET", "LOCK", "PRINT", "CHANNEL_GRID",
    "GL", "DIAG",
}

Fn = Callable[[list[str]], Optional[str]]


def _const(s: str) -> Fn:
    return lambda _c: s


_MEDIA_207 = '200 CLS OK\r\n"AMB" MOVIE 6445960 20121101160514 643 1/60\r\n'
_MEDIA_218 = '200 CLS OK\r\n"AMB"  MOVIE  6445960 20210316122859 268 25/1\r\n'
_MEDIA_220 = '200 CLS OK\r\n"AMB"  MOVIE  6445960 20210316141859 268 25/1\r\n'


class ResponseTables:
    """version -> {COMMAND: response fn}; implemented commands return
    their CasparCG-shaped OK lines after real dispatch succeeds."""

    def __init__(self, server=None):
        self.server = server  # for live INFO
        common = {
            "LOADBG": _const("202 LOADBG OK"),
            "LOAD": _const("202 LOAD OK"),
            "PLAY": _const("202 PLAY OK"),
            "PAUSE": _const("202 PAUSE OK"),
            "RESUME": _const("202 RESUME OK"),
            "STOP": _const("202 STOP OK"),
            "CLEAR": _const("202 CLEAR OK"),
            "ADD": _const("202 ADD OK"),
            "REMOVE": _const("202 REMOVE OK"),
            "MIXER": _const("202 MIXER OK"),
            "CHANNEL_GRID": _const("202 CHANNEL_GRID OK"),
            "DIAG": self._diag,
            "PRINT": _const("202 PRINT OK"),
            "CALL": _const("202 CALL OK"),
            "SWAP": _const("202 SWAP OK"),
            "LOG": _const("202 LOG OK"),
            "SET": _const("202 SET OK"),
            "LOCK": _const("202 LOCK OK"),
            "DATA": _const("202 DATA OK"),
            "CG": _const("202 CG OK"),
            "THUMBNAIL": _const("202 THUMBNAIL OK"),
            "CINF": _const("200 CINF OK"),
            "FLS": _const("200 FLS OK\r\n"),
            "TLS": _const("200 TLS OK\r\n"),
            "GL": _const("202 GL OK"),
            "INFO": self._info,
        }
        self.tables: dict[str, dict[str, Fn]] = {
            "207": {
                **common,
                "VERSION": _const("201 VERSION OK\r\n2.0.7.e9fc25a Stable"),
                "CLS": lambda c: self._cls(_MEDIA_207),
            },
            "218": {
                **common,
                "VERSION": _const("201 VERSION OK\r\n2.1.8.12205 62ea2b24d NRK"),
                "CLS": lambda c: self._cls(_MEDIA_218),
            },
            "220": {
                **common,
                "VERSION": _const("201 VERSION OK\r\n2.2.0 66a9e3e2 Stable"),
                "CLS": lambda c: self._cls(_MEDIA_220),
            },
        }

    def _cls(self, fallback: str) -> str:
        """CLS: list real media files from media_root in CasparCG shape
        (the reference serves canned lists, testResponses.ts; real files
        beat fakes when a media dir exists)."""
        from pathlib import Path

        root = None
        if self.server is not None:
            root = Path(getattr(self.server.config, "media_root", "media"))
        if root is None or not root.is_dir():
            return fallback
        lines = ["200 CLS OK"]
        for p in sorted(root.iterdir()):
            if p.suffix == ".json" or not p.is_file():
                continue
            stamp = time.strftime("%Y%m%d%H%M%S", time.localtime(p.stat().st_mtime))
            lines.append(f'"{p.stem.upper()}"  MOVIE  {p.stat().st_size} {stamp} 0 25/1')
        return "\r\n".join(lines) + "\r\n"

    def _diag(self, _cmd: list[str]) -> str:
        """DIAG prints the tracer's span table and counters + device memory
        census to the server log (the reference's showTimings tables +
        logBuffers, SURVEY.md §5.1)."""
        if self.server is not None:
            from ..utils.metrics import device_memory_stats, tracer

            print("--- spans (host ms) and counters ---")
            print(tracer.log_table())
            for device in sorted({str(ch.device) for ch in self.server.channels.values()}):
                print(device_memory_stats(device))
        return "202 DIAG OK"

    def _info(self, cmd: list[str]) -> str:
        if self.server is None:
            return "200 INFO OK"
        chans = self.server.channels
        if len(cmd) >= 2 and cmd[1].isdigit():
            ch = chans.get(int(cmd[1]))
            if ch is None:
                return "401 INFO ERROR"
            s = ch.stats()
            return (
                f"201 INFO OK\r\n{ch.chan_id} {ch.fmt.name} PLAYING frames={s['frames']} "
                f"layers={s['layers']} render_p99_ms={s['render_p99_ms']:.2f}"
            )
        lines = [f"{ch.chan_id} {ch.fmt.name} PLAYING" for ch in chans.values()]
        return "200 INFO OK\r\n" + "\r\n".join(lines)

    def lookup(self, version: str, command: str) -> Optional[Fn]:
        return self.tables.get(version, self.tables["218"]).get(command.upper())
