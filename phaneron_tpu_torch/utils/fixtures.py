"""Synthetic media fixtures shared by tests and the chip check
(counterpart of phaneron_tpu/utils/fixtures.py, writing the same files
byte for byte).

Deterministic interlaced v210 sequences with per-field luma markers —
the build's analogue of the reference's fillBuf test ramps
(v210.ts:206-236), extended to carry field-line provenance so an
ingest->yadif->interlaced-output chain can be asserted bit-exactly.
Frames are packed on the host by the port's ``v210.pack_codes`` over CPU
tensors."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..audio.engine import QUANTUM
from ..ops.formats import v210

__all__ = ["interlaced_v210_frame", "rawvideo_frame", "write_ffmpeg_stubs", "write_interlaced_v210"]


def interlaced_v210_frame(width: int, height: int, k: int) -> np.ndarray:
    """Frame ``k``'s (H, G*4) uint32 words: luma 120+16k on top-field
    lines, 560+16k on bottom-field lines, chroma null."""
    y = np.zeros((height, width), dtype=np.int32)
    y[0::2] = 120 + 16 * k  # top field lines
    y[1::2] = 560 + 16 * k  # bottom field lines
    c = torch.full((height, width), 512, dtype=torch.int32)
    return v210.pack_codes(torch.from_numpy(y), c, c, width, height)[0].numpy().view(np.uint32)


def write_interlaced_v210(
    tmp: Path,
    width: int = 1920,
    height: int = 1080,
    n_frames: int = 6,
    tone: float = 0.25,
    audio_channels: int = 8,
    name: str = "clip",
) -> tuple[Path, list[np.ndarray]]:
    """Write `<name>.v210` (+ sidecar JSON + side PCM tone) where frame k
    carries luma 120+16k on top-field lines and 560+16k on bottom-field
    lines, chroma null.  Returns (path, word arrays per frame)."""
    tmp = Path(tmp)
    path = tmp / f"{name}.v210"
    frames: list[np.ndarray] = []
    with open(path, "wb") as fh:
        for k in range(n_frames):
            words = interlaced_v210_frame(width, height, k)
            frames.append(words)
            fh.write(words.tobytes())
    pcm_path = tmp / f"{name}.pcm"
    blocks = max(1, n_frames) * 48000 // (25 * QUANTUM) + 4
    chunk = np.full((audio_channels, QUANTUM), tone, dtype=np.float32)
    with open(pcm_path, "wb") as fh:
        for _ in range(blocks):
            fh.write(chunk.tobytes())
    (tmp / f"{name}.v210.json").write_text(
        json.dumps(
            {
                "format": "v210",
                "width": width,
                "height": height,
                "interlaced": True,
                "audio": f"{name}.pcm",
                "audio_channels": audio_channels,
            }
        )
    )
    return path, frames


_FFPROBE = """#!{python}
import json
streams = [{{"codec_type": "video", "width": {width}, "height": {height}, "pix_fmt": "{pix_fmt}",
             "avg_frame_rate": "{fps}/1", "field_order": "progressive"}}]
streams += [{{"codec_type": "audio", "channels": 1, "sample_rate": "48000"}}] * {audio_streams}
print(json.dumps({{"streams": streams, "format": {{"duration": "1.0"}}}}))
"""

_FFMPEG = """#!{python}
import os, sys, threading
import numpy as np
{rawvideo_frame}
args = sys.argv
out = sys.stdout.buffer
if "pipe:0" in args:
    # encode mode: stdin (rawvideo) verbatim to the output file, the
    # fd-passed audio input verbatim to <output>.audio
    afd = next((int(a.split(":")[1]) for a in args if a.startswith("pipe:") and a != "pipe:0"), None)
    audio = []
    def read_audio():
        while afd is not None:
            try:
                b = os.read(afd, 65536)
            except OSError:
                break
            if not b:
                break
            audio.append(b)
    t = threading.Thread(target=read_audio)
    t.start()
    data = sys.stdin.buffer.read()
    t.join(timeout=2)
    with open(args[-1], "wb") as f:
        f.write(data)
    with open(args[-1] + ".audio", "wb") as f:
        f.write(b"".join(audio))
elif "f32le" in args:
    n = int(args[args.index("-ac") + 1])
    if {audio_streams} > 1:
        assert "amerge=inputs={audio_streams}" in args[args.index("-filter_complex") + 1]
    t = np.arange(48000, dtype=np.float32) / 48000.0
    tone = (0.5 * np.sin(2 * np.pi * 1000.0 * t)).astype("<f4")
    out.write(np.repeat(tone[:, None], n, axis=1).tobytes())
elif "rawvideo" in args:
    assert args[args.index("-pix_fmt") + 1] == "{pix_fmt}"
    for i in range({n_frames}):
        out.write(rawvideo_frame("{pix_fmt}", {width}, {height}, i))
out.flush()
"""


def rawvideo_frame(pix_fmt: str, width: int, height: int, k: int) -> bytes:
    """Frame ``k`` of the ffmpeg stub's rawvideo (unpadded planes): in-range
    diagonal ramps, luma and chroma moving with ``k``.  yuv422p10le (10-bit
    little-endian) or yuv420p / yuv422p (8-bit)."""
    ten = pix_fmt == "yuv422p10le"
    cw, ch = (width + 1) // 2, height if pix_fmt != "yuv420p" else (height + 1) // 2
    black, span = (64, 877) if ten else (16, 220)
    cspan = 897 if ten else 225
    r, c = np.ogrid[:height, :width]
    y = black + (3 * r + 7 * c + 32 * k) % span
    r, c = np.ogrid[:ch, :cw]
    u = black + (5 * r + 3 * c + 16 * k) % cspan
    v = black + (2 * r + 9 * c + 8 * k) % cspan
    dtype = "<u2" if ten else np.uint8
    return b"".join(np.ascontiguousarray(p, dtype=dtype).tobytes() for p in (y, u, v))


def write_ffmpeg_stubs(bindir: Path, width: int, height: int, pix_fmt: str = "yuv422p10le", n_frames: int = 12,
                       fps: int = 25, audio_streams: int = 2) -> Path:
    """Write stub ``ffprobe`` and ``ffmpeg`` executables into ``bindir``
    (put it at the front of PATH): ffprobe reports one video stream
    (``width`` x ``height``, ``pix_fmt``, ``fps``) and ``audio_streams``
    mono audio streams; ffmpeg decodes ``n_frames`` of
    ``rawvideo_frame`` or a 1 kHz tone (an amerge graph over the audio
    streams), and in encode mode (``-i pipe:0``) writes its stdin to the
    output file and its audio input to ``<output>.audio``, unchanged."""
    import inspect
    import stat
    import sys

    bindir = Path(bindir)
    bindir.mkdir(parents=True, exist_ok=True)
    fields = dict(python=sys.executable, width=width, height=height, pix_fmt=pix_fmt, n_frames=n_frames,
                  fps=fps, audio_streams=audio_streams, rawvideo_frame=inspect.getsource(rawvideo_frame))
    for name, body in (("ffprobe", _FFPROBE), ("ffmpeg", _FFMPEG)):
        path = bindir / name
        path.write_text(body.format(**fields))
        path.chmod(path.stat().st_mode | stat.S_IEXEC)
    return bindir
