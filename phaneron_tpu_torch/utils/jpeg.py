"""JPEG and PNG coding for the MJPEG consumer and the image producers, in
a process of their own.

Pillow holds the GIL while it encodes into memory: a 1080p frame holds
it for tens of milliseconds, which on a worker thread stalls the event
loop that paces every channel.  So the MJPEG consumer hands each frame's
rgba8 bytes to one codec process over a pipe and reads the JPEG back,
and the MJPEG producer, the AVI producer's MJPG chunks and the image
producer hand it encoded bytes and read rgba8 back, each from a worker
thread that waits without the GIL.

The process is ``python -m phaneron_tpu_torch.utils.jpeg``, which
imports numpy and Pillow only, and writes one byte (``R``) once it
serves.  Protocol: a request is five
little-endian uint32 (operation, width, height, argument, byte count) and
the bytes; the answer an int32 byte count and two uint32 (the decoded
image's width and height; 0 for an encode), then the bytes.

- ``ENCODE``: (H, W, 4) rgba8 in, argument the quality; out a JPEG of
  its RGB.
- ``DECODE``: an image file's bytes in (any format Pillow opens);
  argument a decode mode; out (H, W, 4) rgba8.  ``FIT_RGB``: RGB, alpha
  255, resized to (width, height) at Pillow's default filter where its
  size differs (the MJPEG producer's); ``EXACT_RGB``: RGB, alpha 255;
  ``EXACT_RGBA``: RGBA.  The exact modes answer ``WRONG_SIZE`` and the
  image's size where it is not (width, height).

A count of ``NO_PILLOW`` means Pillow does not import there.
"""

from __future__ import annotations

import contextlib
import fcntl
import io
import os
import struct
import subprocess
import sys
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = [
    "JpegProcess", "encode_rgba", "decode_rgba", "ImageSizeError",
    "FIT_RGB", "EXACT_RGB", "EXACT_RGBA",
]

_REQUEST = struct.Struct("<IIIII")
_ANSWER = struct.Struct("<iII")
ENCODE, DECODE = 0, 1
FIT_RGB, EXACT_RGB, EXACT_RGBA = 0, 1, 2
NO_PILLOW, WRONG_SIZE = -1, -2
_PIPE_BYTES = 1 << 20  # the default ceiling of a pipe's buffer (/proc/sys/fs/pipe-max-size)
_READY = b"R"  # the process's first byte: it serves


class ImageSizeError(ValueError):
    """A decoded image is not the size asked for."""

    def __init__(self, size: tuple[int, int], want: tuple[int, int]):
        super().__init__(f"{size} != {want[0]}x{want[1]}")
        self.size = size


def encode_rgba(data, width: int, height: int, quality: int) -> Optional[bytes]:
    """(H, W, 4) rgba8 bytes -> a JPEG of its RGB, or None without Pillow."""
    try:
        from PIL import Image
    except ImportError:
        return None

    rgba = np.frombuffer(data, dtype=np.uint8).reshape(height, width, 4)
    out = io.BytesIO()
    Image.fromarray(np.ascontiguousarray(rgba[:, :, :3]), "RGB").save(out, "JPEG", quality=quality)
    return out.getvalue()


def decode_rgba(data, width: int, height: int, mode: int) -> Optional[bytes]:
    """An image file's bytes -> (H, W, 4) rgba8 bytes (see the module's
    decode modes), None without Pillow; raises ImageSizeError in an exact
    mode.  RGB -> RGBA conversion sets alpha 255."""
    try:
        from PIL import Image
    except ImportError:
        return None

    with Image.open(io.BytesIO(data)) as img:
        if mode != FIT_RGB and img.size != (width, height):
            raise ImageSizeError(img.size, (width, height))
        rgb = img.convert("RGBA" if mode == EXACT_RGBA else "RGB")
    if rgb.size != (width, height):
        rgb = rgb.resize((width, height))
    return rgb.convert("RGBA").tobytes()


def _read(stream, n: int) -> bytes:
    data = stream.read(n)
    if data is None or len(data) != n:
        raise EOFError("jpeg codec pipe closed")
    return data


def _read_into(stream, out: memoryview) -> None:
    got = 0
    while got < len(out):
        n = stream.readinto(out[got:])
        if not n:
            raise EOFError("jpeg codec pipe closed")
        got += n


class JpegProcess:
    """One codec process, started at the first request; ``encode`` and
    ``decode`` block (call them from a worker thread)."""

    def __init__(self):
        self._proc: Optional[subprocess.Popen] = None
        self._lock = threading.Lock()
        self._closed = False

    def _start(self) -> subprocess.Popen:
        root = str(Path(__file__).resolve().parents[2])
        path = os.pathsep.join(p for p in (root, os.environ.get("PYTHONPATH")) if p)
        proc = subprocess.Popen([sys.executable, "-m", __name__], stdin=subprocess.PIPE,
                                stdout=subprocess.PIPE, env=dict(os.environ, PYTHONPATH=path))
        for pipe in (proc.stdin, proc.stdout):  # a frame in fewer round trips (Linux: F_SETPIPE_SZ)
            with contextlib.suppress(OSError, AttributeError):
                fcntl.fcntl(pipe.fileno(), fcntl.F_SETPIPE_SZ, _PIPE_BYTES)
        if _read(proc.stdout, len(_READY)) != _READY:  # its imports are done
            raise RuntimeError("jpeg codec process did not start")
        return proc

    def start(self) -> None:
        """Start the process now and wait until it serves (a Python
        start-up and Pillow's imports, a few hundred milliseconds: call it
        from a worker thread) instead of at the first request."""
        with self._lock:
            if self._proc is None and not self._closed:
                self._proc = self._start()

    def _request(self, op: int, width: int, height: int, arg: int, data) -> Optional[tuple]:
        """Send one request (the lock held); the answer's header, or None
        once closed."""
        if self._closed:
            return None
        if self._proc is None:
            self._proc = self._start()
        view = memoryview(data).cast("B")
        self._proc.stdin.write(_REQUEST.pack(op, width, height, arg, view.nbytes))
        self._proc.stdin.write(view)
        self._proc.stdin.flush()
        return _ANSWER.unpack(_read(self._proc.stdout, _ANSWER.size))

    def encode(self, data, width: int, height: int, quality: int) -> Optional[bytes]:
        """The JPEG of ``data`` (bytes or a uint8 host array), or None
        without Pillow or once closed."""
        with self._lock:
            answer = self._request(ENCODE, width, height, quality, data)
            if answer is None or answer[0] < 0:
                return None
            return _read(self._proc.stdout, answer[0])

    def decode(self, data, width: int, height: int, mode: int, out: np.ndarray) -> bool:
        """Decode an image file's bytes into ``out`` (a writable uint8
        array of width * height * 4 bytes) as rgba8; False once closed.
        Raises ImageSizeError in an exact mode, RuntimeError without
        Pillow."""
        with self._lock:
            answer = self._request(DECODE, width, height, mode, data)
            if answer is None:
                return False
            if answer[0] == NO_PILLOW:
                raise RuntimeError("jpeg codec process: Pillow does not import")
            if answer[0] == WRONG_SIZE:
                raise ImageSizeError((answer[1], answer[2]), (width, height))
            _read_into(self._proc.stdout, memoryview(out).cast("B"))
            return True

    def close(self) -> None:
        """Stop the codec process (after the request it is serving)."""
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
    with contextlib.suppress(ImportError):  # the codecs' plugins load now, not at the first frame
        from PIL import Image

        Image.init()
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    stdout.write(_READY)
    stdout.flush()
    while True:
        head = stdin.read(_REQUEST.size)
        if len(head) < _REQUEST.size:
            return
        op, width, height, arg, n = _REQUEST.unpack(head)
        data = _read(stdin, n)
        w = h = 0
        if op == ENCODE:
            out = encode_rgba(data, width, height, arg)
        else:
            try:
                out = decode_rgba(data, width, height, arg)
            except ImageSizeError as err:
                out, (w, h) = b"", err.size
        count = NO_PILLOW if out is None else (WRONG_SIZE if (w, h) != (0, 0) else len(out))
        stdout.write(_ANSWER.pack(count, w, h))
        stdout.write(out or b"")
        stdout.flush()


if __name__ == "__main__":
    _serve()
