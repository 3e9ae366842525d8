"""Server composition root (counterpart of phaneron_tpu/server.py;
reference src/index.ts:36-189).

Builds the whole server: config, producer/consumer registries, channels
(each running the port's frame programs on its CUDA device), the AMCP TCP
server, OSC, heads automation and a stdin REPL, all on one asyncio loop.
Run with:

    python -m phaneron_tpu_torch.server [config.json]

Channels run on ``cuda:0``, or on ``cuda:n`` for a config channel's
``chip: n``; without CUDA the server raises: there is no CPU fallback.
``PhaneronServer(config, device="cpu")`` runs every channel in plain
PyTorch on the CPU, as the tests do.  A config channel with ``sp > 1`` or
``chips`` is row-sharded over that device group (runtime/channel.py
``sp_devices``).

The registries hold the JAX server's entries in its order.  Consumers:
file, ffmpeg, mjpeg and stream, screen (preview), decklink.  Producers,
tried in turn: ROUTE, DECKLINK capture (``set_capture_backend``; without
a backend DECKLINK URLs fall through to the test patterns' bars), the
test patterns, MJPEG over HTTP, AVI, WAV, images and image sequences, raw
files, then ffmpeg (with ffmpeg and ffprobe on PATH).  A consumer that
cannot run on the host — ffmpeg without a binary, decklink without an SDI
backend — raises RuntimeError; the server prints it and keeps serving, as
it does for any consumer that fails (the JAX server's fallback from
ffmpeg to the file consumer is not ported).

``start()`` turns the port's tracer on (``utils/metrics.py``): INFO's
render p50 / p99 read its ``channel.tick`` spans, and DIAG prints its
spans and counters.
"""

from __future__ import annotations

import asyncio
import re
import sys
from typing import Optional

import torch

from .config import ServerConfig, get_video_format
from .consumer.consumer import ConsumerRegistry
from .consumer.ffmpeg_consumer import FFmpegConsumer
from .consumer.file_consumer import FileConsumer
from .consumer.mjpeg_consumer import MJPEGConsumer
from .consumer.preview_consumer import PreviewConsumer
from .consumer.sdi_consumer import SDIConsumer
from .control.amcp import AMCPServer
from .control.basic_cmds import BasicCmds
from .control.commands import Commands
from .control.heads import Heads
from .control.mixer_cmds import MixerCmds
from .control.osc import Osc
from .producer.avi_file import create_avi_producer
from .producer.ffmpeg import create_ffmpeg_producer
from .producer.image_seq import create_image_seq_producer
from .producer.mjpeg import create_mjpeg_producer
from .producer.producer import ProducerRegistry
from .producer.raw_file import create_raw_file_producer
from .producer.route import make_route_factory
from .producer.sdi_capture import create_sdi_capture_producer
from .producer.test_pattern import create_test_pattern_producer
from .producer.wav_file import create_wav_producer
from .runtime.channel import Channel
from .utils.metrics import tracer

__all__ = ["PhaneronServer", "default_consumer_registry", "main"]


def default_consumer_registry() -> ConsumerRegistry:
    reg = ConsumerRegistry()
    reg.register("file", FileConsumer)
    reg.register("ffmpeg", FFmpegConsumer)
    reg.register("mjpeg", MJPEGConsumer)
    reg.register("stream", MJPEGConsumer)
    reg.register("screen", PreviewConsumer)
    reg.register("decklink", SDIConsumer)
    return reg


def _server_device(device) -> Optional[torch.device]:
    """None (each channel on its CUDA device) or the one device every
    channel runs on.  Without CUDA, None raises: no CPU fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "PhaneronServer: no CUDA device; pass device='cpu' to run the plain PyTorch path"
            )
        return None
    return torch.device(device)


class PhaneronServer:
    def __init__(self, config: Optional[ServerConfig] = None, device=None):
        self.config = config or ServerConfig()
        self.device = _server_device(device)
        self.channels: dict[int, Channel] = {}
        self.consumer_registry = default_consumer_registry()
        self.producer_registry = ProducerRegistry(
            [
                make_route_factory(lambda n: self.channels.get(n)),
                create_sdi_capture_producer,
                create_test_pattern_producer,
                create_mjpeg_producer,
                create_avi_producer,
                create_wav_producer,
                create_image_seq_producer,
                create_raw_file_producer,
                create_ffmpeg_producer,
            ]
        )
        self.commands = Commands()
        self.commands.add(BasicCmds(self.channels, self.consumer_registry).list())
        self.commands.add(MixerCmds(self.channels).list())
        self.amcp = AMCPServer(self.commands, self.config.amcp_port, server=self)
        self.osc = Osc(
            self.config.osc_listen_port,
            self.config.osc_remote_address,
            self.config.osc_remote_port,
        )
        self.heads: Optional[Heads] = None
        self._stop_event = asyncio.Event()
        self.amcp.on_kill = self._stop_event.set

    def _placement(self, cc) -> tuple:
        """(device, sp_devices) of a config channel: ``chip: n`` is
        ``cuda:(n % device count)`` as the JAX server wraps it (unwrapped
        where no CUDA device is seen: the channel raises); ``sp > 1`` or
        ``chips`` name a device group, each index wrapped the same way (so
        on one card a group names it once a band), or the server's one
        device once a band under its device override."""
        count = torch.cuda.device_count()
        wrap = lambda j: torch.device("cuda", j % count if count else j)
        if cc.sp > 1 or cc.chips:
            idxs = cc.chips or list(range(cc.chip or 0, (cc.chip or 0) + cc.sp))
            if self.device is not None:
                return None, [self.device] * len(idxs)
            return None, [wrap(j) for j in idxs]
        if self.device is not None:
            return self.device, None
        return wrap(cc.chip or 0), None

    async def start(self) -> None:
        tracer.start()
        # channels, one per configured consumer (index.ts:156-168);
        # a failing consumer must not kill the server
        for i, cc in enumerate(self.config.channels, start=1):
            device, sp_devices = self._placement(cc)
            channel = Channel(
                i,
                get_video_format(cc.format),
                self.producer_registry,
                col_spec=self.config.col_spec,
                gamma_mode=self.config.gamma_mode,
                device=device,
                sp_devices=sp_devices,
            )
            params = dict(cc.device)
            name = params.pop("name", None)
            if name:
                try:
                    consumer = self.consumer_registry.create(name, params)
                    await channel.add_consumer(consumer)
                except Exception as err:
                    print(f"Channel {i}: consumer '{name}' failed: {err}")
            self.channels[i] = channel
            channel.start()

        await self.osc.start()
        if self.config.heads_url and 1 in self.channels:
            self.heads = Heads(
                self.osc,
                self.channels[1],
                {"load": "/heads/load", "take": "/heads/take"},
            )
            await self.heads.load_spec(self.config.heads_url)
        print(await self.amcp.start())

    async def shutdown(self) -> None:
        await self.amcp.stop()
        self.osc.close()
        for ch in self.channels.values():
            await ch.shutdown()
        self.channels.clear()

    async def repl(self) -> None:
        """stdin AMCP REPL (index.ts:110-128); 'q' quits."""
        loop = asyncio.get_running_loop()
        token_re = re.compile(r'"[^"]+"|""|\S+')
        while not self._stop_event.is_set():
            try:
                line = await loop.run_in_executor(None, sys.stdin.readline)
            except Exception:
                break
            if not line:
                break
            line = line.strip()
            if line.lower() == "q":
                self._stop_event.set()
                break
            if line:
                print(await self.amcp.process_command(token_re.findall(line)))

    async def run_forever(self) -> None:
        await self.start()
        repl_task = asyncio.create_task(self.repl())
        await self._stop_event.wait()
        repl_task.cancel()
        await self.shutdown()


def main(argv: Optional[list[str]] = None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cfg = ServerConfig.load(argv[0]) if argv else ServerConfig()
    server = PhaneronServer(cfg)  # raises without CUDA

    asyncio.run(server.run_forever())


if __name__ == "__main__":
    main()
