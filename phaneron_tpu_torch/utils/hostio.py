"""ctypes bindings for the native hostio library, with numpy fallbacks
(the port's own binding of native/hostio.cpp, which it shares with the
JAX package: ``native/build.py`` builds it into ``native/build/``).

The native side provides the host half of the frame path: packed-format
byte shuffles, PCM conversion and an SPSC staging ring — the role the
reference delegated to its C++ N-API deps.  Everything degrades to numpy
when the toolchain is unavailable, so the framework never hard-depends on
the binary; the numpy versions are host code, as the JAX package keeps
them."""

from __future__ import annotations

import ctypes
import threading
import time
from typing import Optional

import numpy as np
import torch

__all__ = [
    "native_available",
    "v210_deinterleave",
    "v210_interleave",
    "uv_deinterleave",
    "uv_interleave",
    "pcm_f32_to_s32",
    "pcm_s32_to_f32",
    "StagingRing",
    "host_buffer",
    "copy_to_host",
    "wait_copy",
    "StagedUpload",
    "host_planes",
]

_lib: Optional[ctypes.CDLL] = None
_tried = False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    try:
        import sys
        from pathlib import Path

        sys.path.insert(0, str(Path(__file__).parents[2] / "native"))
        try:
            from build import build  # type: ignore
        finally:
            sys.path.pop(0)
        lib = ctypes.CDLL(str(build()))
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_acquire_write.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ring_acquire_read.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.ring_size.restype = ctypes.c_int64
        for fn in (lib.ring_destroy, lib.ring_commit_write, lib.ring_commit_read,
                   lib.ring_acquire_write, lib.ring_acquire_read, lib.ring_size):
            fn.argtypes = [ctypes.c_void_p]
        lib.ring_create.argtypes = [ctypes.c_int64, ctypes.c_int64]
        _lib = lib
    except Exception as err:  # no toolchain / build failure -> fallbacks
        print(f"hostio: native library unavailable ({err}); using numpy fallbacks")
        _lib = None
    return _lib


def native_available() -> bool:
    return _load() is not None


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def v210_deinterleave(words: np.ndarray) -> np.ndarray:
    """(H, G*4) uint32 -> (4, H, G): word planes for lane-aligned unpack."""
    h, w4 = words.shape
    g = w4 // 4
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(words.reshape(h, g, 4).transpose(2, 0, 1))
    words = np.ascontiguousarray(words)
    out = np.empty((4, h, g), dtype=np.uint32)
    lib.v210_deinterleave(_ptr(words, ctypes.c_uint32), _ptr(out, ctypes.c_uint32), h, g)
    return out


def v210_interleave(planes: np.ndarray) -> np.ndarray:
    """(4, H, G) uint32 -> (H, G*4)."""
    _, h, g = planes.shape
    lib = _load()
    if lib is None:
        return np.ascontiguousarray(planes.transpose(1, 2, 0).reshape(h, g * 4))
    planes = np.ascontiguousarray(planes)
    out = np.empty((h, g * 4), dtype=np.uint32)
    lib.v210_interleave(_ptr(planes, ctypes.c_uint32), _ptr(out, ctypes.c_uint32), h, g)
    return out


def uv_deinterleave(c: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    flat = np.ascontiguousarray(c).reshape(-1)
    n = flat.size // 2
    lib = _load()
    if lib is None:
        return c[..., 0::2].copy(), c[..., 1::2].copy()
    u = np.empty(n, dtype=np.uint8)
    v = np.empty(n, dtype=np.uint8)
    lib.uv_deinterleave(_ptr(flat, ctypes.c_uint8), _ptr(u, ctypes.c_uint8),
                        _ptr(v, ctypes.c_uint8), n)
    shape = c.shape[:-1] + (c.shape[-1] // 2,)
    return u.reshape(shape), v.reshape(shape)


def uv_interleave(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        out = np.empty(u.shape[:-1] + (u.shape[-1] * 2,), dtype=np.uint8)
        out[..., 0::2] = u
        out[..., 1::2] = v
        return out
    uf = np.ascontiguousarray(u).reshape(-1)
    vf = np.ascontiguousarray(v).reshape(-1)
    out = np.empty(uf.size * 2, dtype=np.uint8)
    lib.uv_interleave(_ptr(uf, ctypes.c_uint8), _ptr(vf, ctypes.c_uint8),
                      _ptr(out, ctypes.c_uint8), uf.size)
    return out.reshape(u.shape[:-1] + (u.shape[-1] * 2,))


def pcm_f32_to_s32(planar: np.ndarray) -> np.ndarray:
    """(C, N) f32 planar -> (N*C,) s32 interleaved."""
    c, n = planar.shape
    lib = _load()
    if lib is None:
        clipped = np.clip(planar, -1.0, 1.0)
        return (clipped.T.reshape(-1).astype(np.float64) * 2147483647.0).astype(np.int32)
    planar = np.ascontiguousarray(planar, dtype=np.float32)
    out = np.empty(c * n, dtype=np.int32)
    lib.pcm_f32_planar_to_s32_interleaved(
        _ptr(planar, ctypes.c_float), _ptr(out, ctypes.c_int32), c, n
    )
    return out


def pcm_s32_to_f32(interleaved: np.ndarray, channels: int) -> np.ndarray:
    n = interleaved.size // channels
    lib = _load()
    if lib is None:
        return (
            interleaved.reshape(n, channels).T.astype(np.float64) / 2147483648.0
        ).astype(np.float32)
    interleaved = np.ascontiguousarray(interleaved, dtype=np.int32)
    out = np.empty((channels, n), dtype=np.float32)
    lib.pcm_s32_interleaved_to_f32_planar(
        _ptr(interleaved, ctypes.c_int32), _ptr(out, ctypes.c_float), channels, n
    )
    return out


class StagingRing:
    """SPSC frame staging ring: decode thread writes slot N+1 while the
    dispatcher uploads slot N (the reference's load-queue overlap)."""

    def __init__(self, slot_bytes: int, slots: int = 3):
        self.slot_bytes = slot_bytes
        self.slots = slots
        lib = _load()
        if lib is None:
            import collections

            self._fallback = collections.deque(maxlen=slots)
            self._handle = None
        else:
            self._handle = lib.ring_create(slot_bytes, slots)
            self._lib = lib

    def try_write(self, data) -> bool:
        """Copy ``data`` (bytes, or a host array's bytes) into the next free
        slot; False when the ring is full."""
        if self._handle is None:
            if len(self._fallback) >= self.slots:
                return False
            self._fallback.append(np.frombuffer(data, dtype=np.uint8).copy())
            return True
        ptr = self._lib.ring_acquire_write(self._handle)
        if not ptr:
            return False
        src = np.frombuffer(data, dtype=np.uint8)  # bytes or a host array, no copy
        ctypes.memmove(ptr, src.ctypes.data, min(src.size, self.slot_bytes))
        self._lib.ring_commit_write(self._handle)
        return True

    def try_read(self) -> Optional[np.ndarray]:
        if self._handle is None:
            return self._fallback.popleft() if self._fallback else None
        ptr = self._lib.ring_acquire_read(self._handle)
        if not ptr:
            return None
        out = np.ctypeslib.as_array(ptr, shape=(self.slot_bytes,)).copy()
        self._lib.ring_commit_read(self._handle)
        return out

    def __len__(self) -> int:
        if self._handle is None:
            return len(self._fallback)
        return int(self._lib.ring_size(self._handle))

    def close(self) -> None:
        if self._handle is not None:
            self._lib.ring_destroy(self._handle)
            self._handle = None


# ------------------------------------------------ device <-> host staging
#
# A frame's device -> host copy is enqueued on the thread that owns the
# frame (the event loop) into a pinned buffer and fenced by a CUDA event;
# only a worker thread waits for it, by polling the event (a query never
# makes the host wait for the card).  Whoever enqueues a copy keeps its
# source tensors referenced until the event has completed, so the caching
# allocator cannot hand their memory to another tensor mid-copy.


def host_buffer(nbytes: int, device: torch.device | str) -> torch.Tensor:
    """A flat uint8 host buffer for frames of ``device``: pinned where the
    device is a CUDA device (asynchronous copies need pinned memory)."""
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=torch.device(device).type == "cuda")


def copy_to_host(planes, buf: torch.Tensor) -> tuple[int, Optional[torch.cuda.Event]]:
    """Copy the planes' bytes, one after another, into ``buf`` (from
    ``host_buffer``); returns the byte count and, for CUDA planes, the
    event recorded after the copies (they are enqueued with
    ``non_blocking=True`` on the planes' current stream), else None (CPU
    planes are copied at once)."""
    off = 0
    event = None
    for plane in planes:
        src = plane.contiguous().view(torch.uint8).reshape(-1)
        n = src.numel()
        buf[off : off + n].copy_(src, non_blocking=src.is_cuda)
        off += n
        if src.is_cuda:
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(src.device))
    return off, event


def wait_copy(event: Optional[torch.cuda.Event], stop: Optional[threading.Event] = None) -> bool:
    """Wait on a worker thread until ``event`` has completed (None: at
    once); False when ``stop`` is set first."""
    while event is not None and not event.query():
        if stop is not None:
            if stop.wait(0.0005):
                return False
        else:
            time.sleep(0.0005)
    return True


# host plane dtype -> the tensor dtype a plane is carried in (v210 words:
# int32 bit views, graph/convert.py), and back
TORCH_DTYPES = {np.dtype(np.uint32): torch.int32, np.dtype(np.uint16): torch.uint16,
                np.dtype(np.uint8): torch.uint8}
HOST_DTYPES = {t: d for d, t in TORCH_DTYPES.items()}


class StagedUpload:
    """Host frames -> plane tensors on ``device``, for a producer's loader
    thread (one call at a time).  On a CUDA device each frame is written
    into one of ``buffers`` pinned buffers and copied up ``non_blocking``;
    a buffer is written again only once the event after its last copy has
    completed.  On the CPU each frame gets a fresh buffer: the planes
    handed on are never written again.  Make it on a worker thread:
    pinning takes tens of milliseconds a buffer."""

    def __init__(self, device: torch.device | str, nbytes: int, buffers: int = 3):
        # three: the frame being read, the one uploading, one spare
        self.device = torch.device(device)
        self.nbytes = nbytes
        self._staging = ([(host_buffer(nbytes, self.device), None) for _ in range(buffers)]
                         if self.device.type == "cuda" else [])

    def __call__(self, fill, plane_shapes) -> list:
        """``fill(out)`` writes the frame's bytes into ``out``, a uint8
        numpy array of ``nbytes``; returns its planes, ``plane_shapes``
        ([(shape, numpy dtype)], a format's ``plane_shapes``), as tensors
        on the device."""
        cuda = self.device.type == "cuda"
        if cuda:
            buf, event = self._staging.pop(0)
            wait_copy(event)  # its last upload has completed
        else:
            buf = torch.empty(self.nbytes, dtype=torch.uint8)
        fill(buf.numpy())
        planes, off = [], 0
        for shape, dtype in plane_shapes:
            n = int(np.prod(shape)) * dtype.itemsize
            planes.append(buf[off : off + n].view(TORCH_DTYPES[dtype]).view(shape))
            off += n
        if not cuda:
            return planes
        planes = [p.to(self.device, non_blocking=True) for p in planes]
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(self.device))
        self._staging.append((buf, event))
        return planes


def host_planes(buf: torch.Tensor, planes, copy: bool = True) -> list[np.ndarray]:
    """The planes ``copy_to_host`` wrote into ``buf``, as numpy arrays in
    the wire dtypes (v210 words uint32) with the planes' shapes: arrays of
    their own, or with ``copy=False`` views of ``buf``.  Call it once the
    copy has completed."""
    out, off = [], 0
    data = buf.numpy()
    for plane in planes:
        dtype = np.dtype(HOST_DTYPES[plane.dtype])
        n = plane.numel() * dtype.itemsize
        view = data[off : off + n].view(dtype).reshape(tuple(plane.shape))
        out.append(view.copy() if copy else view)
        off += n
    return out
