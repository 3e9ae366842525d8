"""JPEG encoding for the MJPEG consumer, in a process of its own.

Pillow's JPEG encoder holds the GIL while it encodes into memory: a
1080p frame holds it for tens of milliseconds, which on a worker thread
stalls the event loop that paces every channel.  So the MJPEG consumer
hands each frame's rgba8 bytes to one encoder process over a pipe and
reads the JPEG back, on a worker thread that waits without the GIL.

The process is ``python -m phaneron_tpu_torch.utils.jpeg``, which
imports numpy and Pillow only.  Protocol: a request is four little-endian
uint32 (width, height, quality, byte count) and the (H, W, 4) rgba8
bytes; the answer an int32 byte count (-1: no Pillow) and the JPEG.
"""

from __future__ import annotations

import os
import struct
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["JpegEncoder", "encode_rgba"]

_REQUEST = struct.Struct("<IIII")
_ANSWER = struct.Struct("<i")


def encode_rgba(data, width: int, height: int, quality: int) -> Optional[bytes]:
    """(H, W, 4) rgba8 bytes -> a JPEG of its RGB, or None without Pillow."""
    try:
        from PIL import Image
    except ImportError:
        return None
    import io

    rgba = np.frombuffer(data, dtype=np.uint8).reshape(height, width, 4)
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgba[:, :, :3]), "RGB").save(out, "JPEG", quality=quality)
    return out.getvalue()


def _read(stream, n: int) -> bytes:
    data = stream.read(n)
    if data is None or len(data) != n:
        raise EOFError("jpeg encoder pipe closed")
    return data


class JpegEncoder:
    """One encoder process, started at the first frame; ``encode`` blocks
    (call it from a worker thread)."""

    def __init__(self):
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._closed = False

    def _start(self) -> subprocess.Popen:
        root = str(Path(__file__).resolve().parents[2])
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
        return subprocess.Popen([sys.executable, "-m", __name__], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, env=dict(os.environ, PYTHONPATH=path))

    def encode(self, data, width: int, height: int, quality: int) -> Optional[bytes]:
        """The JPEG of ``data`` (bytes or a uint8 host array), or None
        without Pillow or once closed."""
        with self._lock:
            if self._closed:
                return None
            if self._proc is None:
                self._proc = self._start()
            view = memoryview(data).cast("B")
            self._proc.stdin.write(_REQUEST.pack(width, height, quality, view.nbytes))
            self._proc.stdin.write(view)
            self._proc.stdin.flush()
            (n,) = _ANSWER.unpack(_read(self._proc.stdout, _ANSWER.size))
            return None if n < 0 else _read(self._proc.stdout, n)

    def close(self) -> None:
        """Stop the encoder process (after the frame it is encoding)."""
        with self._lock:
            self._closed = True
            proc, self._proc = self._proc, None
        if proc is not None:
            proc.stdin.close()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
            proc.stdout.close()


def _serve() -> None:
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    while True:
        head = stdin.read(_REQUEST.size)
        if len(head) < _REQUEST.size:
            return
        width, height, quality, n = _REQUEST.unpack(head)
        jpeg = encode_rgba(_read(stdin, n), width, height, quality)
        stdout.write(_ANSWER.pack(-1 if jpeg is None else len(jpeg)) + (jpeg or b""))
        stdout.flush()


if __name__ == "__main__":
    _serve()
