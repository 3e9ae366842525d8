"""Video format registry and server configuration (a copy of
phaneron_tpu/config.py; ``configs/*.json`` are read as they are).

Parity with the reference's config (src/config.ts:25-97) plus a
declarative JSON config file replacing the hardcoded Config class
(src/index.ts:36-92; SURVEY.md §5.6 calls for this upgrade).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional

__all__ = ["VideoFormat", "VIDEO_FORMATS", "get_video_format", "ServerConfig", "ConsumerConfig"]


@dataclass(frozen=True)
class VideoFormat:
    name: str
    fields: int  # 1 progressive, 2 interlaced
    width: int
    height: int
    square_width: int  # display aspect width (config.ts:27-30)
    timescale: int
    duration: int
    audio_sample_rate: int = 48000
    audio_channels: int = 8

    @property
    def interlaced(self) -> bool:
        return self.fields == 2

    @property
    def fps(self) -> float:
        """Output frames (or fields for interlaced) per second."""
        return self.timescale / self.duration

    @property
    def samples_per_frame(self) -> int:
        return self.audio_sample_rate * self.duration // self.timescale


def _fmt(name, fields, w, h, sq, ts, dur) -> VideoFormat:
    return VideoFormat(name, fields, w, h, sq, ts, dur)


# The reference registers 720p5000/1080i5000/1080p5000 (config.ts:38-86);
# UHD/other rates are the aspirational capability (README.md:39) made real.
VIDEO_FORMATS: dict[str, VideoFormat] = {
    f.name: f
    for f in [
        _fmt("720p5000", 1, 1280, 720, 1280, 50, 1),
        _fmt("1080i5000", 2, 1920, 1080, 1920, 50, 1),
        _fmt("1080p5000", 1, 1920, 1080, 1920, 50, 1),
        _fmt("1080p2500", 1, 1920, 1080, 1920, 25, 1),
        _fmt("2160p5000", 1, 3840, 2160, 3840, 50, 1),
        _fmt("2160p2500", 1, 3840, 2160, 3840, 25, 1),
        _fmt("4320p5000", 1, 7680, 4320, 7680, 50, 1),  # 8K (README.md:39
        # calls UHD/8K aspirational in the reference; real here)
    ]
}


def get_video_format(name: str) -> VideoFormat:
    if name not in VIDEO_FORMATS:
        raise KeyError(f"unknown video format '{name}'")
    return VIDEO_FORMATS[name]


@dataclass
class ConsumerConfig:
    """One consumer attached to a channel (config.ts:88-97)."""

    format: str = "1080p5000"
    device: dict[str, Any] = field(default_factory=dict)  # name + params
    chip: Optional[int] = None  # device index to pin the channel to
    # (channel-per-chip placement, SURVEY §2.7 P2); None = default device
    sp: int = 1  # scanline sharding: run this channel row-sharded over
    # sp consecutive chips starting at `chip` (or over `chips`); the
    # route to UHD/8K sub-10ms latency (SURVEY §2.7 P5, §5.7)
    chips: Optional[list[int]] = None  # explicit device group for sp>1


@dataclass
class ServerConfig:
    """Whole-server configuration (replaces index.ts:36-92)."""

    channels: list[ConsumerConfig] = field(
        default_factory=lambda: [ConsumerConfig("1080p5000", {"name": "file"})]
    )
    amcp_port: int = 5250
    osc_listen_port: int = 9876
    osc_remote_address: str = "127.0.0.1"
    osc_remote_port: int = 9877
    heads_url: Optional[str] = None
    gamma_mode: str = "analytic"
    col_spec: str = "709"
    media_root: str = "media"

    @classmethod
    def load(cls, path: str | Path) -> "ServerConfig":
        raw = json.loads(Path(path).read_text())
        channels = [
            ConsumerConfig(
                c.get("format", "1080p5000"),
                c.get("device", {}),
                c.get("chip"),
                int(c.get("sp", 1)),
                c.get("chips"),
            )
            for c in raw.get("channels", [])
        ]
        cfg = cls()
        if channels:
            cfg.channels = channels
        for key in (
            "amcp_port",
            "osc_listen_port",
            "osc_remote_address",
            "osc_remote_port",
            "heads_url",
            "gamma_mode",
            "col_spec",
            "media_root",
        ):
            if key in raw:
                setattr(cfg, key, raw[key])
        return cfg
