"""Minimal RIFF/AVI container reader + writer for UNCOMPRESSED media.

Real-container ingest without codec libraries: broadcast delivery of
uncompressed v210 inside AVI/MOV wrappers is standard practice, and the
reference's file producer handles such files through libavformat
(producer/ffmpegProducer.ts:98-168 — probe, stream select, geometry).
This module gives the build the same capability natively: parse the
container headers (avih / strh / strf), locate the movi payload chunks,
and expose per-frame byte ranges over a memmap — zero-copy until the
producer's loader thread touches a frame.

Scope: 'vids' streams whose biCompression is a fourcc this build's
format library decodes bit-exactly (v210, plus BI_RGB 32-bit as bgra8),
and one optional 'auds' PCM stream (s16 or f32 interleaved).  Anything
compressed raises — the FFmpeg producer (gated on a real binary) owns
codecs.

The writer emits the same subset, used by tests and by tools that need
fixture media; output opens in ffmpeg/VLC.

A copy of phaneron_tpu/utils/avi.py (struct and numpy only).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["AviInfo", "AviVideo", "AviAudio", "read_avi", "write_avi", "AviWriter"]


@dataclass
class AviVideo:
    fourcc: str
    width: int
    height: int
    fps: float
    bit_count: int
    frames: list[tuple[int, int]] = field(default_factory=list)  # (offset, size)
    bottom_up: bool = False  # BI_RGB with positive biHeight


@dataclass
class AviAudio:
    format_tag: int  # 1 = PCM int, 3 = IEEE float
    channels: int
    sample_rate: int
    bits: int
    chunks: list[tuple[int, int]] = field(default_factory=list)


@dataclass
class AviInfo:
    video: Optional[AviVideo]
    audio: Optional[AviAudio]


def _u32(b: bytes, off: int) -> int:
    return struct.unpack_from("<I", b, off)[0]


def _chunk_bytes(ck: bytes, body: bytes) -> bytes:
    pad = b"\x00" if len(body) & 1 else b""
    return ck + struct.pack("<I", len(body)) + body + pad


def _list_bytes(kind: bytes, body: bytes) -> bytes:
    return _chunk_bytes(b"LIST", kind + body)


def _build_header(
    fourcc: str,
    width: int,
    height: int,
    fps: float,
    frame_bytes: int,
    bit_count: int,
    n_frames: int,
    audio_channels: int,
    audio_rate: int,
    audio_samples: int,
) -> bytes:
    """RIFF header through the hdrl LIST (single source of the layout
    for both the one-shot writer and the streaming AviWriter; the
    latter writes it with zero counts and patches on close)."""
    scale, rate = 1000, int(round(fps * 1000))
    avih = struct.pack(
        "<IIIIIIIIII4I",
        int(1e6 / fps), frame_bytes * int(fps), 0, 0x10, n_frames, 0,
        2 if audio_channels else 1, frame_bytes, width, height, 0, 0, 0, 0,
    )
    strh_v = struct.pack(
        "<4s4sIHHIIIIIIiI4H",
        b"vids", fourcc.encode().ljust(4), 0, 0, 0, 0, scale, rate, 0, n_frames,
        frame_bytes, -1, 0, 0, 0, width & 0xFFFF, height & 0xFFFF,
    )
    comp = b"\x00\x00\x00\x00" if fourcc == "BI_RGB" else fourcc.encode().ljust(4)
    strf_v = struct.pack(
        "<IiiHH4sIiiII",
        40, width, -height if fourcc == "BI_RGB" else height, 1, bit_count,
        comp, frame_bytes, 0, 0, 0, 0,
    )
    hdrl = _chunk_bytes(b"avih", avih) + _list_bytes(
        b"strl", _chunk_bytes(b"strh", strh_v) + _chunk_bytes(b"strf", strf_v)
    )
    if audio_channels:
        block_align = audio_channels * 4
        strh_a = struct.pack(
            "<4s4sIHHIIIIIIiI4H",
            b"auds", b"\x00\x00\x00\x00", 0, 0, 0, 0, 1, audio_rate, 0,
            audio_samples, audio_rate * block_align, -1, block_align, 0, 0, 0, 0,
        )
        strf_a = struct.pack(
            "<HHIIHH", 3, audio_channels, audio_rate,
            audio_rate * block_align, block_align, 32,
        )
        hdrl += _list_bytes(
            b"strl", _chunk_bytes(b"strh", strh_a) + _chunk_bytes(b"strf", strf_a)
        )
    return b"RIFF\x00\x00\x00\x00AVI " + _list_bytes(b"hdrl", hdrl)


def read_avi(path: str | Path) -> AviInfo:
    """Parse headers + scan movi chunks.  Raises ValueError on anything
    that is not an AVI with supported uncompressed streams."""
    data = np.memmap(path, dtype=np.uint8, mode="r")
    if len(data) < 12 or bytes(data[0:4]) != b"RIFF" or bytes(data[8:12]) != b"AVI ":
        raise ValueError("not an AVI file")

    video: Optional[AviVideo] = None
    audio: Optional[AviAudio] = None
    stream_kinds: list[str] = []  # index -> 'vids'/'auds'
    movi_ranges: list[tuple[int, int]] = []

    def parse_strl(buf: bytes, pos: int, end: int) -> None:
        nonlocal video, audio
        fcc_type = b""
        scale = rate = length = 0
        while pos + 8 <= end:
            ck = buf[pos : pos + 4]
            sz = _u32(buf, pos + 4)
            body = pos + 8
            if ck == b"strh":
                fcc_type = buf[body : body + 4]
                scale = _u32(buf, body + 20)
                rate = _u32(buf, body + 24)
                length = _u32(buf, body + 32)
            elif ck == b"strf" and fcc_type == b"vids":
                w = struct.unpack_from("<i", buf, body + 4)[0]
                h = struct.unpack_from("<i", buf, body + 8)[0]
                bits = struct.unpack_from("<H", buf, body + 14)[0]
                comp = buf[body + 16 : body + 20]
                if comp == b"\x00\x00\x00\x00":
                    fourcc = "BI_RGB"
                else:
                    fourcc = comp.decode("ascii", "replace")
                video = AviVideo(
                    fourcc=fourcc,
                    width=w,
                    height=abs(h),
                    fps=(rate / scale) if scale else 25.0,
                    bit_count=bits,
                    bottom_up=(fourcc == "BI_RGB" and h > 0),
                )
                stream_kinds.append("vids")
            elif ck == b"strf" and fcc_type == b"auds":
                tag, ch = struct.unpack_from("<HH", buf, body)
                sample_rate = _u32(buf, body + 4)
                bits = struct.unpack_from("<H", buf, body + 14)[0]
                audio = AviAudio(
                    format_tag=tag, channels=ch, sample_rate=sample_rate, bits=bits
                )
                stream_kinds.append("auds")
            pos = body + sz + (sz & 1)

    # top-level walk over the FULL file (chunk headers only — stays
    # cheap on a memmap; a movi LIST pushed past 64 KB by JUNK padding
    # or OpenDML headers from standard tools must still be found).
    # The hdrl LIST is materialised to bytes for the field parses.
    pos, end = 12, len(data)
    while pos + 8 <= end:
        ck = bytes(data[pos : pos + 4])
        sz = _u32(bytes(data[pos + 4 : pos + 8]), 0)
        body = pos + 8
        if ck == b"LIST":
            kind = bytes(data[body : body + 4])
            if kind == b"hdrl":
                raw = data[pos : min(body + sz + (sz & 1), end)].tobytes()
                # walk hdrl for strl LISTs (offsets relative to `pos`)
                p2, e2 = 12, 8 + sz
                while p2 + 8 <= min(e2, len(raw)):
                    c2 = raw[p2 : p2 + 4]
                    s2 = _u32(raw, p2 + 4)
                    if c2 == b"LIST" and raw[p2 + 8 : p2 + 12] == b"strl":
                        parse_strl(raw, p2 + 12, p2 + 8 + s2)
                    p2 += 8 + s2 + (s2 & 1)
            elif kind == b"movi":
                movi_ranges.append((body + 4, body + sz))
        pos = body + sz + (sz & 1)

    if video is None:
        raise ValueError("no vids stream")
    if video.fourcc not in ("v210", "BI_RGB", "MJPG"):
        raise ValueError(f"compressed/unsupported video fourcc '{video.fourcc}'")
    if audio is not None and audio.format_tag not in (1, 3):
        raise ValueError(f"unsupported audio format tag {audio.format_tag}")

    # movi scan: chunk ids are '##db'/'##dc'/'##wb' with ## = stream no.
    for m_start, m_end in movi_ranges:
        p = m_start
        while p + 8 <= m_end:
            ck = bytes(data[p : p + 4])
            sz = _u32(bytes(data[p + 4 : p + 8]), 0)
            body = p + 8
            tail = ck[2:4]
            if tail in (b"db", b"dc"):
                video.frames.append((body, sz))
            elif tail == b"wb" and audio is not None:
                audio.chunks.append((body, sz))
            p = body + sz + (sz & 1)

    if not video.frames:
        raise ValueError("movi holds no video chunks")
    return AviInfo(video=video, audio=audio)


def write_avi(
    path: str | Path,
    frames: list[bytes],
    fourcc: str,
    width: int,
    height: int,
    fps: float,
    bit_count: int = 20,
    audio: Optional[np.ndarray] = None,  # (channels, samples) float32
    audio_rate: int = 48000,
) -> None:
    """Write an uncompressed AVI (one vids stream, optional float PCM
    auds stream, audio interleaved per video frame)."""
    n = len(frames)
    sizes = {len(f) for f in frames}
    if fourcc in ("v210", "BI_RGB"):
        assert len(sizes) == 1, "uniform frame size required for uncompressed"
    # header field is dwSuggestedBufferSize — max covers variable (MJPG) chunks
    frame_bytes = max(sizes)
    # compressed payloads use the '##dc' chunk id by convention
    vid_ck = b"00db" if fourcc in ("v210", "BI_RGB") else b"00dc"

    aud_per_frame: list[bytes] = []
    audio_channels = 0
    audio_samples = 0
    if audio is not None:
        audio_channels, audio_samples = audio.shape
        per = audio_samples // n
        inter = np.ascontiguousarray(audio.T, dtype="<f4")  # (samples, ch)
        for k in range(n):
            aud_per_frame.append(inter[k * per : (k + 1) * per].tobytes())

    header = _build_header(
        fourcc, width, height, fps, frame_bytes, bit_count,
        n, audio_channels, audio_rate, audio_samples,
    )
    movi = b"movi"
    for k, f in enumerate(frames):
        movi += _chunk_bytes(vid_ck, f)
        if aud_per_frame:
            movi += _chunk_bytes(b"01wb", aud_per_frame[k])
    # body already includes the 'AVI ' form type, so the RIFF size
    # field is exactly len(body) (== file size - 8, matching
    # AviWriter.close()'s end-8 patch)
    body = header[8:] + _chunk_bytes(b"LIST", movi)
    Path(path).write_bytes(b"RIFF" + struct.pack("<I", len(body)) + body)


class AviWriter:
    """STREAMING uncompressed-AVI writer for live recording: header
    with placeholder counts up front, movi chunks appended per frame,
    sizes patched on close.  Video = one vids stream of fixed-size
    frames; audio = optional float32 interleaved PCM chunks riding with
    each frame ('01wb')."""

    def __init__(
        self,
        path: str | Path,
        fourcc: str,
        width: int,
        height: int,
        fps: float,
        frame_bytes: int,
        bit_count: int = 20,
        audio_channels: int = 0,
        audio_rate: int = 48000,
    ):
        self._fh = open(path, "wb")
        self.audio_channels = audio_channels
        self._frames = 0
        self._audio_samples = 0
        header = _build_header(
            fourcc, width, height, fps, frame_bytes, bit_count,
            0, audio_channels, audio_rate, 0,
        )
        # patch offsets, discovered by scanning the built header
        self._riff_size_at = 4
        self._avih_frames_at = header.index(b"avih") + 8 + 16
        strh_v_at = header.index(b"strh")
        self._vid_len_at = strh_v_at + 8 + 32
        if audio_channels:
            strh_a_at = header.index(b"strh", strh_v_at + 1)
            self._aud_len_at = strh_a_at + 8 + 32
        self._fh.write(header)
        self._movi_size_at = self._fh.tell() + 4
        self._fh.write(b"LIST\x00\x00\x00\x00movi")

    def _chunk(self, ck: bytes, body: bytes) -> None:
        self._fh.write(ck + struct.pack("<I", len(body)))
        self._fh.write(body)
        if len(body) & 1:
            self._fh.write(b"\x00")

    def write_frame(self, video: bytes, audio_f32: bytes | None = None) -> None:
        self._chunk(b"00db", video)
        if audio_f32 and self.audio_channels:
            self._chunk(b"01wb", audio_f32)
            self._audio_samples += len(audio_f32) // (4 * self.audio_channels)
        self._frames += 1

    def close(self) -> None:
        if self._fh is None:
            return
        end = self._fh.tell()

        def patch(at: int, value: int) -> None:
            self._fh.seek(at)
            self._fh.write(struct.pack("<I", value))

        patch(self._riff_size_at, end - 8)
        patch(self._avih_frames_at, self._frames)
        patch(self._vid_len_at, self._frames)
        if self.audio_channels:
            patch(self._aud_len_at, self._audio_samples)
        patch(self._movi_size_at, end - self._movi_size_at - 4)
        self._fh.close()
        self._fh = None
