"""Image / image-sequence producer: PNG, JPEG, BMP stills and clips
(counterpart of phaneron_tpu/producer/image_seq.py).

The reference routes still images and printf-style image sequences
through libavformat's image2 demuxer like any other media URL
(producer/ffmpegProducer.ts:98-168; codec dispatch 393-466).  This
producer covers that role natively via PIL — the second compressed
codec family (PNG's DEFLATE, alongside the AVI path's baseline JPEG)
that executes end-to-end with zero external binaries.

Accepted URLs:
- a single still (``logo.png``) — holds on the frame forever, the
  reference's still-image behaviour (an image "clip" never ends)
- a glob pattern (``frames/*.png``) — lexicographically sorted clip
- a printf pattern (``frames/f%04d.png``) — consecutive from the first
  index found (0 or 1)
- a directory — all images inside, sorted

Frame rate defaults to the channel's; an optional sidecar
``<dir>/sequence.json`` ({"fps": 25, "loop": true}) overrides it.
The loader thread reads each file and decodes it to RGBA in the codec
process of ``utils/jpeg.py``, straight into a pinned buffer, then
uploads it as one rgba8 plane (the RawFileProducer prefetch contract);
loops serve repeat passes from the device cache.
"""

from __future__ import annotations

import asyncio
import json
import re
from dataclasses import replace
from pathlib import Path

import numpy as np

from ..config import VideoFormat
from ..ops.formats import get_format
from ..utils.jpeg import EXACT_RGBA, ImageSizeError, JpegProcess
from .producer import InvalidProducerError, LoadParams, Producer
from .raw_file import RawFileProducer

__all__ = ["ImageSeqProducer", "create_image_seq_producer"]

_IMAGE_EXTS = {".png", ".jpg", ".jpeg", ".bmp"}
_PRINTF_RE = re.compile(r"%0?(\d*)d")


def _expand(url: str) -> list[Path]:
    """URL -> ordered list of image paths (empty = not ours)."""
    p = Path(url)
    m = _PRINTF_RE.search(p.name)
    if m:  # printf pattern: consecutive run starting at 0 or 1
        if p.suffix.lower() not in _IMAGE_EXTS:
            return []
        out: list[Path] = []
        for start in (0, 1):
            idx = start
            run: list[Path] = []
            while True:
                cand = p.with_name(_PRINTF_RE.sub(lambda mm: str(idx).zfill(int(mm.group(1) or 1)), p.name))
                if not cand.exists():
                    break
                run.append(cand)
                idx += 1
            if len(run) > len(out):
                out = run
        return out
    if any(c in p.name for c in "*?["):
        if p.suffix.lower() not in _IMAGE_EXTS:
            return []
        return sorted(p.parent.glob(p.name))
    if p.is_dir():
        return sorted(f for f in p.iterdir() if f.suffix.lower() in _IMAGE_EXTS)
    if p.suffix.lower() in _IMAGE_EXTS and p.exists():
        return [p]
    return []


class ImageSeqProducer(RawFileProducer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        # bypass RawFileProducer.__init__ (raw sidecar/extension
        # resolution); the image headers are authoritative here
        Producer.__init__(self, source_id, fmt)
        url = params.url
        if url.upper().startswith(("ROUTE://", "BARS", "RAMP", "BLACK", "HTTP")):
            raise InvalidProducerError("not an image path")
        self.files = _expand(url)
        if not self.files:
            raise InvalidProducerError(f"no image(s) at: {url}")
        try:
            from PIL import Image  # noqa: F401
        except Exception as err:  # pragma: no cover - PIL is baked in
            raise InvalidProducerError(f"PIL unavailable: {err}") from err
        self.still = len(self.files) == 1 and "%" not in url
        self.pix_format = "rgba8"
        self.params = params
        # a still holds forever, like the reference's image clips
        self.loop = params.loop or self.still
        self.interlaced = False
        self.meta: dict = {}
        sidecar = self.files[0].parent / "sequence.json"
        if sidecar.exists() and not self.still:
            self.meta = json.loads(sidecar.read_text())
            if self.meta.get("loop"):
                self.loop = True
            if "fps" in self.meta:
                src_fps = float(self.meta["fps"])
                self.fmt = replace(self.fmt, fields=1, timescale=int(round(src_fps * 1000)), duration=1000)
        self.width = self.height = 0  # probed in initialise
        self._pending_seek: int | None = None
        self._device_cache: dict[int, list] = {}
        self._cache_ok = False
        self._uploader = None
        self._codec = JpegProcess()

    async def initialise(self) -> None:
        def probe() -> tuple[int, int]:
            from PIL import Image

            with Image.open(self.files[0]) as img:
                return img.size

        self.width, self.height = await asyncio.to_thread(probe)
        await asyncio.to_thread(self._codec.start)
        self.plane_shapes = get_format(self.pix_format).plane_shapes(self.width, self.height)
        self.num_frames = len(self.files)
        self.frame_bytes = self.width * self.height * 4
        await self._init_staging()

    def _read_frame(self, index: int, out: np.ndarray) -> None:
        """Read and decode one image into ``out`` (the loader thread; the
        decode runs in the codec process, never on the event loop)."""
        path = self.files[index]
        try:
            self._codec.decode(path.read_bytes(), self.width, self.height, EXACT_RGBA, out)
        except ImageSizeError as err:
            raise InvalidProducerError(
                f"{path.name}: {err.size} != sequence geometry {self.width}x{self.height}") from err

    def release(self) -> None:
        super().release()
        self._codec.close()  # a decode in flight finishes first


def create_image_seq_producer(source_id, params, fmt) -> ImageSeqProducer:
    return ImageSeqProducer(source_id, params, fmt)
