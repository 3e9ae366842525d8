"""FFmpeg-based media ingest, gated on ffmpeg and ffprobe binaries
(counterpart of phaneron_tpu/producer/ffmpeg.py).

The reference's largest component is its FFmpeg producer
(producer/ffmpegProducer.ts, 705 LoC: demux -> decode -> filter ->
GPU load).  Without the binaries the factory rejects cleanly and the
registry falls through (producer.ts:62-102 fallback chain).  When they
are present:

- ffprobe resolves geometry, pixel format, frame rate, interlacing and
  the audio stream layout (the reference reads the demuxer's stream
  table, ffmpegProducer.ts:121-168);
- the video pipe decodes to the source's OWN pixel format when it is
  one the port unpacks natively (yuv422p10le and yuv422p through
  planar422_unpack, yuv420p and nv12 through planar420_unpack, rgba and
  bgra through the torch decode), else falls back to yuv422p10le (or
  rgba for alpha formats) — the reference's format dispatch with
  libavfilter fallbacks (ffmpegProducer.ts:393-466);
- frames arrive at native geometry; the channel program unpacks at
  source size and stretch-fits (LayerSpec.src_size).  A worker thread
  pads each rawvideo row to the format's pitch straight into a pinned
  buffer and uploads it ``non_blocking`` (``utils/hostio.StagedUpload``);
- a second ffmpeg process decodes audio to f32 PCM, merging multiple
  mono streams like the reference's MXF amerge graph
  (ffmpegProducer.ts:181-246); missing audio degrades to silence
  (ffmpegProducer.ts:213-246).
"""

from __future__ import annotations

import asyncio
import json
import shutil
import subprocess
import time
from dataclasses import replace

import numpy as np

from ..audio.engine import QUANTUM, silence
from ..config import VideoFormat
from ..ops.formats import get_format
from ..runtime.frame import AudioFrame, VideoFrame
from ..runtime.stream import END, Stream, from_generator
from ..utils.hostio import StagedUpload
from .producer import InvalidProducerError, LoadParams, Producer
from .wav_file import black_planes

__all__ = ["FFmpegProducer", "create_ffmpeg_producer", "ffmpeg_available", "probe"]

# ffmpeg pix_fmt -> framework format with a native unpack
NATIVE_PIX = {
    "yuv422p10le": "yuv422p10le",
    "yuv422p": "yuv422p8",
    "yuv420p": "yuv420p",
    "nv12": "nv12",
    "rgba": "rgba8",
    "bgra": "bgra8",
}
FALLBACK_PIX = ("yuv422p10le", "yuv422p10le")  # (ffmpeg name, framework name)
FALLBACK_ALPHA = ("rgba", "rgba8")  # alpha-carrying sources keep their key


def ffmpeg_available() -> bool:
    return shutil.which("ffmpeg") is not None and shutil.which("ffprobe") is not None


def probe(url: str) -> dict:
    """ffprobe stream/format tables as a dict.

    Every failure mode (timeout, bad JSON, exec error) raises
    InvalidProducerError so the registry's fallback chain keeps working
    (producer.ts:62-102)."""
    try:
        out = subprocess.run(
            ["ffprobe", "-v", "quiet", "-print_format", "json", "-show_streams", "-show_format", url],
            capture_output=True,
            timeout=30,
        )
    except (subprocess.TimeoutExpired, OSError) as err:
        raise InvalidProducerError(f"ffprobe failed for {url}: {err}")
    if out.returncode != 0:
        raise InvalidProducerError(f"ffprobe failed for {url}")
    try:
        return json.loads(out.stdout or b"{}")
    except json.JSONDecodeError as err:
        raise InvalidProducerError(f"ffprobe output unparsable for {url}: {err}")


def _parse_rate(s: str | None) -> float:
    if not s:
        return 0.0
    if "/" in s:
        num, den = s.split("/")
        return float(num) / float(den) if float(den) else 0.0
    return float(s)


def _dispatch_pix(src_pix: str) -> tuple[str, str]:
    """(ffmpeg pipe pix_fmt, framework format) for a source pixel format
    — native pass-through when we unpack it, else the reference's
    fallback conversion (ffmpegProducer.ts:393-466)."""
    if src_pix in NATIVE_PIX:
        return src_pix, NATIVE_PIX[src_pix]
    if "a" in src_pix.replace("yuv", "").replace("gray", ""):  # yuva*, *a
        return FALLBACK_ALPHA
    return FALLBACK_PIX


def rawvideo_layout(pix_format: str, width: int, height: int) -> list[tuple[int, int, int]]:
    """Each plane's (rows, unpadded row bytes, pitched row bytes): ffmpeg's
    rawvideo rows are unpadded, the format's planes pitched.  A chroma or
    semi-planar plane scales the width by its pitch's ratio to the luma
    pitch."""
    fmt_mod = get_format(pix_format)
    out = []
    for shape, dtype in fmt_mod.plane_shapes(width, height):
        rows, pitch = shape[0], shape[1]
        sample = int(np.prod(shape[2:], dtype=np.int64)) * dtype.itemsize  # rgba8: 4 bytes a pixel
        cols = width if pitch == width else min(int(np.ceil(width * (pitch / fmt_mod.pitch(width)))), pitch)
        out.append((rows, cols * sample, pitch * sample))
    return out


class FFmpegProducer(Producer):
    def __init__(self, source_id: str, params: LoadParams, fmt: VideoFormat):
        super().__init__(source_id, fmt)
        if not ffmpeg_available():
            raise InvalidProducerError("no ffmpeg binary in this environment")
        self.params = params
        self.channel_fmt = fmt
        self.proc: asyncio.subprocess.Process | None = None
        self.aproc: asyncio.subprocess.Process | None = None
        self._uploader: StagedUpload | None = None
        self._black = None

    async def initialise(self) -> None:
        info = await asyncio.to_thread(probe, self.params.url)
        streams = info.get("streams", [])
        vstreams = [s for s in streams if s.get("codec_type") == "video"]
        self.astreams = [s for s in streams if s.get("codec_type") == "audio"]
        if not vstreams and not self.astreams:
            raise InvalidProducerError(f"no decodable streams in {self.params.url}")

        ch = self.channel_fmt
        if vstreams:
            v = vstreams[0]
            self.width = int(v.get("width") or ch.width)
            self.height = int(v.get("height") or ch.height)
            src_fps = _parse_rate(v.get("avg_frame_rate") or v.get("r_frame_rate"))
            self.interlaced = v.get("field_order", "progressive") not in ("progressive", "unknown", "")
            self._pipe_pix, self.pix_format = _dispatch_pix(v.get("pix_fmt", ""))
        else:  # audio-only media: black video at channel rate
            self.width, self.height = ch.width, ch.height
            src_fps = ch.fps
            self.interlaced = False
            self._pipe_pix, self.pix_format = FALLBACK_PIX

        # cadence: integer channel/source ratios repeat frames via the
        # layer pull cadence (ffmpegProducer.ts:557-566); anything else
        # is rate-converted by ffmpeg's fps filter (ts:446-463)
        self._fps_filter = None
        out_fps = src_fps or ch.fps
        if src_fps > 0:
            ratio = ch.fps / src_fps
            if ratio < 0.999 or abs(ratio - round(ratio)) > 1e-3:
                self._fps_filter = f"fps={ch.timescale}/{ch.duration}"
                out_fps = ch.fps
        self.fmt = replace(ch, fields=1, timescale=int(round(out_fps * 1000)), duration=1000)

        fmt_mod = get_format(self.pix_format)
        self.plane_shapes = fmt_mod.plane_shapes(self.width, self.height)
        self._layout = rawvideo_layout(self.pix_format, self.width, self.height)
        self.frame_bytes = sum(rows * cols for rows, cols, _ in self._layout)
        pitched = sum(fmt_mod.num_bytes(self.width, self.height))
        if vstreams:
            self._uploader = await asyncio.to_thread(StagedUpload, self.device, pitched)
        else:
            self._black = await asyncio.to_thread(black_planes, self.pix_format, self.width, self.height,
                                                  self.device)

        if vstreams:
            args = ["ffmpeg", "-hide_banner", "-loglevel", "warning"]
            if self.params.seek:
                args += ["-ss", str(self.params.seek / (src_fps or ch.fps))]
            if self.params.loop:
                args += ["-stream_loop", "-1"]
            args += ["-i", self.params.url, "-map", "0:v:0", "-an"]
            if self._fps_filter:
                args += ["-vf", self._fps_filter]
            args += ["-f", "rawvideo", "-pix_fmt", self._pipe_pix, "pipe:1"]
            self.proc = await asyncio.create_subprocess_exec(
                *args,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL,
                limit=max(self.frame_bytes * 2, 1 << 20),
            )

        if self.astreams:
            self.audio_channels = sum(
                int(s.get("channels", 1)) for s in self.astreams
            ) if len(self.astreams) > 1 else int(self.astreams[0].get("channels", 2))
            aargs = ["ffmpeg", "-hide_banner", "-loglevel", "warning"]
            if self.params.seek:
                aargs += ["-ss", str(self.params.seek / (src_fps or ch.fps))]
            if self.params.loop:
                aargs += ["-stream_loop", "-1"]
            aargs += ["-i", self.params.url]
            if len(self.astreams) > 1:
                # MXF-style mono stream fan-in (ffmpegProducer.ts:192-197)
                taps = "".join(f"[0:a:{i}]" for i in range(len(self.astreams)))
                aargs += ["-filter_complex", f"{taps}amerge=inputs={len(self.astreams)}[a]", "-map", "[a]"]
            else:
                aargs += ["-map", "0:a:0"]
            aargs += ["-vn", "-f", "f32le", "-ar", str(ch.audio_sample_rate), "-ac", str(self.audio_channels),
                      "pipe:1"]
            self.aproc = await asyncio.create_subprocess_exec(
                *aargs,
                stdout=asyncio.subprocess.PIPE,
                stderr=asyncio.subprocess.DEVNULL,
            )

    def _to_planes(self, raw: bytes) -> list:
        """Unpadded rawvideo frame bytes -> pitched planes on the device (a
        worker thread): each row padded with zeros to its pitch in the
        staging buffer."""

        def fill(out: np.ndarray) -> None:
            src = np.frombuffer(raw, np.uint8)
            pos_in = pos_out = 0
            for rows, cols, pitch in self._layout:
                dst = out[pos_out : pos_out + rows * pitch].reshape(rows, pitch)
                dst[:, :cols] = src[pos_in : pos_in + rows * cols].reshape(rows, cols)
                dst[:, cols:] = 0
                pos_in += rows * cols
                pos_out += rows * pitch

        return self._uploader(fill, self.plane_shapes)

    def video_stream(self) -> Stream:
        length = self.params.length

        async def gen():
            ts = 0
            while not self.released and self.proc is not None:
                if length is not None and ts >= length:
                    break
                try:
                    raw = await self.proc.stdout.readexactly(self.frame_bytes)
                except (asyncio.IncompleteReadError, AttributeError):
                    break
                stamp = time.monotonic()
                # row padding + upload off the event loop
                planes = await asyncio.to_thread(self._to_planes, raw)
                yield VideoFrame(
                    timestamp=ts,
                    format=self.pix_format,
                    payload=planes,
                    width=self.width,
                    height=self.height,
                    interlaced=self.interlaced,
                    loadstamp=stamp,
                )
                ts += 1
            if self.proc is None:  # audio-only: pace black at channel rate
                while not self.released and (length is None or ts < length):
                    if self.aproc is not None and self.aproc.returncode is not None:
                        break
                    yield VideoFrame(timestamp=ts, format=self.pix_format, payload=self._black,
                                     width=self.width, height=self.height)
                    ts += 1
                    await asyncio.sleep(0)
            yield END

        return from_generator(gen)

    def audio_stream(self) -> Stream:
        ch_silence = self.channel_fmt.audio_channels

        async def gen():
            ts = 0
            if self.aproc is None:
                # missing audio stream -> silence (ffmpegProducer.ts:213-246)
                while not self.released:
                    yield AudioFrame(timestamp=ts, samples=silence(ch_silence),
                                     sample_rate=self.channel_fmt.audio_sample_rate)
                    ts += 1
                yield END
                return
            n_ch = self.audio_channels
            chunk_bytes = QUANTUM * n_ch * 4
            while not self.released:
                try:
                    raw = await self.aproc.stdout.readexactly(chunk_bytes)
                except (asyncio.IncompleteReadError, AttributeError):
                    break
                samples = np.frombuffer(raw, np.float32).reshape(QUANTUM, n_ch).T.copy()
                yield AudioFrame(timestamp=ts, samples=samples, sample_rate=self.channel_fmt.audio_sample_rate)
                ts += 1
            yield END

        return from_generator(gen)

    def release(self) -> None:
        super().release()
        for p in (self.proc, self.aproc):
            if p and p.returncode is None:
                p.kill()
            # close pipe transports now, while the loop is still alive
            # (otherwise their GC after loop close raises in asyncio)
            t = getattr(p, "_transport", None)
            if t is not None:
                try:
                    t.close()
                except RuntimeError:
                    pass


def create_ffmpeg_producer(source_id, params, fmt) -> FFmpegProducer:
    return FFmpegProducer(source_id, params, fmt)
