"""The port's server as a whole: the reference's default served load
(configs/quad_1080i_1chip.json: four interlaced channels into two file
consumers, a preview and an MJPEG stream, AMCP and OSC) at a tiny
interlaced format on the CPU, next to the JAX package's server on the same
config; placement, no fallback, and the consumers that need a binary or
hardware (decklink without an SDI backend, ffmpeg without a binary)."""

import asyncio
import json
import socket
from dataclasses import replace
from pathlib import Path

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu import config as jconfig
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.ops.formats import get_format

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TINY_I = ("tiny_i5000", 2, 256, 64, 256, 50, 1, 48000, 2)  # 1080i5000 cut to 256x64
jconfig.VIDEO_FORMATS.setdefault("tiny_i5000", jconfig.VideoFormat(*TINY_I))
tconfig.VIDEO_FORMATS.setdefault("tiny_i5000", tconfig.VideoFormat(*TINY_I))

SCRIPT = [
    *(f"PLAY {n}-1 BARS" for n in range(1, 5)),
    "MIXER 1-1 FILL 0.1 0.05 0.8 0.8", "LOADBG 1-1 RAMP MIX 10", "PLAY 1-1",
    "INFO", "REQ t1 MIXER 2-1 FILL 0 0 0.5 0.5", "REQ t2 PLAY 3-2 RAMP", "ADD 2 DECKLINK", "VERSION",
]


def _default_config(cfg_mod, out_dir: Path, heads_url=None):
    """configs/quad_1080i_1chip.json with the tiny interlaced format, its
    file paths under ``out_dir`` and every port chosen by the OS."""
    cfg = cfg_mod.ServerConfig.load(ROOT / "configs" / "quad_1080i_1chip.json")
    assert [c.format for c in cfg.channels] == ["1080i5000"] * 4
    assert [c.device["name"] for c in cfg.channels] == ["file", "file", "screen", "mjpeg"]
    for cc in cfg.channels:
        cc.format = "tiny_i5000"
        cc.device = dict(cc.device, **({"path": str(out_dir / Path(cc.device["path"]).name)}
                                       if cc.device["name"] == "file" else {"port": 0}))
    cfg.amcp_port = cfg.osc_listen_port = 0
    cfg.heads_url = heads_url
    return cfg


async def _serve(jax_side: bool, out_dir: Path, seconds: float, heads_url=None):
    """Start a server on the default config, send SCRIPT over TCP, run
    paced; returns the response lines, each channel's ticks and its
    consumer's record, and what the preview and MJPEG ports served."""
    if jax_side:
        from phaneron_tpu.server import PhaneronServer

        server = PhaneronServer(_default_config(jconfig, out_dir, heads_url))
    else:
        from phaneron_tpu_torch.server import PhaneronServer

        server = PhaneronServer(_default_config(tconfig, out_dir, heads_url), device="cpu")
    await server.start()
    try:
        port = server.amcp._server.sockets[0].getsockname()[1]
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        lines = []
        for cmd in SCRIPT:
            writer.write(f"{cmd}\r\nREQ sync PING\r\n".encode())
            await writer.drain()
            while (line := (await asyncio.wait_for(reader.readline(), 60)).decode()) != "PONG sync\r\n":
                lines.append(line)
        writer.close()
        await writer.wait_closed()
        mjpeg = server.channels[4].consumers[0]
        r, w = await asyncio.open_connection("127.0.0.1", mjpeg._server.sockets[0].getsockname()[1])
        w.write(b"GET / HTTP/1.1\r\n\r\n")
        await w.drain()
        mjpeg_head = await r.readuntil(b"\r\n\r\n")
        await asyncio.sleep(seconds)
        try:
            import PIL  # noqa: F401  (without it the stream sends no part, as in JAX)

            part_head = await asyncio.wait_for(r.readuntil(b"\r\n\r\n"), 30)
        except ImportError:
            part_head = None
        w.close()
        preview = server.channels[3].consumers[0]
        for _ in range(600):  # until the preview serves a frame with the bars (a loaded CPU is slow)
            r, w = await asyncio.open_connection("127.0.0.1", preview._server.sockets[0].getsockname()[1])
            w.write(b"GET / HTTP/1.1\r\n\r\n")
            await w.drain()
            preview_head = await r.readuntil(b"\r\n\r\n")
            body = await r.readexactly(256 * 64 * 4) if b"200 OK" in preview_head else b""
            w.close()
            if body and (np.frombuffer(body, np.uint8)[3::4] == 255).all():
                break
            await asyncio.sleep(0.05)
        osc_port = server.osc._transport.get_extra_info("sockname")[1]
        for ch in server.channels.values():
            ch.running = False  # each loop ends after a whole tick
        await asyncio.wait_for(asyncio.gather(*(ch._task for ch in server.channels.values())), 30)
        ticks = [ch.timestamp for ch in server.channels.values()]
        stats = [ch.stats() for ch in server.channels.values()]
        return dict(lines=lines, ticks=ticks, stats=stats, mjpeg_head=mjpeg_head, part_head=part_head,
                    preview_head=preview_head, body=body, osc_port=osc_port,
                    consumers=[list(ch.consumers) for ch in server.channels.values()])
    finally:
        await server.shutdown()


def test_default_config_serves_as_the_jax_server(tmp_path, capsys):
    """The same AMCP script gives the same response lines through both
    servers; the port's four channels deliver every tick: each file holds
    one frame a pair of field ticks (its sidecar says interlaced), the
    preview serves an rgba8 frame and the MJPEG port JPEG parts; ADD
    DECKLINK, with no SDI backend here, answers 400 (the SDI consumer's
    RuntimeError, as JAX's) and the server goes on."""
    jax_out = run(_serve(True, tmp_path / "jax", 0.5))
    out = run(_serve(False, tmp_path / "port", 1.0))
    assert out["lines"] == jax_out["lines"]
    assert "".join(out["lines"]).count("202 PLAY OK") == 6
    assert "400 ERROR\r\n" in out["lines"] and "ADD 2 DECKLINK NOT IMPLEMENTED\r\n" in out["lines"]
    assert "SDI output requires DeckLink hardware" in capsys.readouterr().out
    fbytes = get_format("v210").num_bytes(256, 64)[0]
    for n in (1, 2):
        (cons,) = out["consumers"][n - 1]
        assert cons.written == out["ticks"][n - 1] // 2 and cons.leaked_threads == 0
        data = (tmp_path / "port" / f"ch{n}.v210").read_bytes()
        assert len(data) == cons.written * fbytes > 0
        meta = json.loads((tmp_path / "port" / f"ch{n}.v210.json").read_text())
        assert meta == {"format": "v210", "width": 256, "height": 64, "fps": 25.0, "interlaced": True}
        last = np.frombuffer(data[-fbytes:], np.uint32)
        assert last.any()
    assert all(s["layers"] for s in out["stats"])
    assert b"200 OK" in out["preview_head"] and b"X-Width: 256" in out["preview_head"]
    rgba8 = np.frombuffer(out["body"], np.uint8).reshape(64, 256, 4)
    assert (rgba8[..., 3] == 255).all() and rgba8[..., :3].std() > 10  # opaque bars
    if out["part_head"] is not None:
        assert out["part_head"].startswith(b"--phaneronframe\r\nContent-Type: image/jpeg\r\n")
    assert b"multipart/x-mixed-replace" in out["mjpeg_head"]
    assert out["osc_port"] > 0


def test_heads_url_loads_a_rundown_at_start(tmp_path):
    """A config's heads_url: the server loads the rundown onto channel 1
    at start and an OSC take plays it."""
    from phaneron_tpu_torch.control.osc import encode_message
    from phaneron_tpu_torch.server import PhaneronServer

    spec = tmp_path / "rundown.json"
    spec.write_text(json.dumps({"events": [{"layers": [{"layerNum": 5, "url": "RAMP"}]},
                                           {"layers": [{"layerNum": 5, "url": "BARS"}]}]}))
    cfg = _default_config(tconfig, tmp_path, heads_url=str(spec))

    async def main():
        server = PhaneronServer(cfg, device="cpu")
        await server.start()
        try:
            assert server.heads is not None and server.heads.spec is not None
            layer = server.channels[1].layers[5]
            assert layer.cur is not None and layer.cur.paused  # event 0 preloaded
            sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
            sock.sendto(encode_message("/heads/take", 1), ("127.0.0.1", server.osc.listen_port))
            sock.close()
            for _ in range(300):
                if server.heads.event_index == 1:
                    break
                await asyncio.sleep(0.01)
            assert server.heads.event_index == 1 and not layer.cur.paused  # the take played layer 5
        finally:
            await server.shutdown()

    run(main())


def test_no_cpu_fallback_and_placement(tmp_path, monkeypatch):
    """Without CUDA, PhaneronServer() and main() raise; config ``chip: n``
    is cuda:n where no CUDA device is seen (the channel raises); ``sp > 1``
    makes a row-sharded channel, on the server's device once a band under
    its device override."""
    from phaneron_tpu_torch.server import PhaneronServer, main

    cfg = tconfig.ServerConfig.load(ROOT / "configs" / "quad_1080i_1chip.json")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PhaneronServer(cfg)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main([str(ROOT / "configs" / "quad_1080i_1chip.json")])
    server = PhaneronServer(cfg, device="cpu")
    cc = replace(cfg.channels[0], chip=2)
    assert server._placement(cc) == (torch.device("cpu"), None)
    server.device = None  # as PhaneronServer(cfg) places channels on a CUDA machine
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert server._placement(cc) == (torch.device("cuda", 2), None)
    assert server._placement(cfg.channels[0]) == (torch.device("cuda", 0), None)
    assert server._placement(replace(cc, sp=2)) == (None, [torch.device("cuda", 2), torch.device("cuda", 3)])

    sp_cfg = tconfig.ServerConfig(channels=[tconfig.ConsumerConfig("tiny_i5000", {}, sp=2)],
                                  amcp_port=0, osc_listen_port=0)

    async def start_sp():
        server = PhaneronServer(sp_cfg, device="cpu")
        try:
            await server.start()
            return server.channels[1]._sp_mesh
        finally:
            await server.shutdown()

    assert run(start_sp()).flat == [torch.device("cpu")] * 2


@pytest.mark.parametrize("count, chip, want", [(1, 2, 0), (4, 2, 2), (4, 5, 1), (2, 1, 1)])
def test_chip_placement_wraps(monkeypatch, count, chip, want):
    """With CUDA devices seen, config ``chip: n`` is cuda:(n % count), as
    the JAX server wraps ``devices[chip % len(devices)]``: on one card
    configs/quad_1080i_2chip.json runs its four channels on cuda:0."""
    from phaneron_tpu_torch.server import PhaneronServer

    cfg = tconfig.ServerConfig.load(ROOT / "configs" / "quad_1080i_2chip.json")
    server = PhaneronServer(cfg, device="cpu")
    server.device = None  # as PhaneronServer(cfg) places channels on a CUDA machine
    monkeypatch.setattr(torch.cuda, "device_count", lambda: count)
    assert server._placement(replace(cfg.channels[0], chip=chip)) == (torch.device("cuda", want), None)
    placed = {server._placement(cc)[0] for cc in cfg.channels}
    cards = {torch.device("cuda", j) for j in range(min(count, 2))}
    assert placed == cards


@pytest.mark.parametrize("name", ["decklink", "ffmpeg", "DeckLink"])
def test_unported_consumers_raise_naming_a8b(name, monkeypatch, tmp_path):
    """The consumers that need hardware or a binary raise RuntimeError
    (the server prints it and keeps serving): decklink without an SDI
    backend at initialise, as JAX's; ffmpeg without a binary at once (no
    fallback to the file consumer, which JAX's registry makes)."""
    from phaneron_tpu_torch.consumer.ffmpeg_consumer import FFmpegConsumer
    from phaneron_tpu_torch.consumer.sdi_consumer import SDIConsumer
    from phaneron_tpu_torch.server import default_consumer_registry

    monkeypatch.setenv("PATH", str(tmp_path))  # no ffmpeg on it
    registry = default_consumer_registry()
    decklink = name.lower() == "decklink"
    assert registry.factories[name.lower()] is (SDIConsumer if decklink else FFmpegConsumer)

    async def create():
        await registry.create(name, {}).initialise(tconfig.VideoFormat(*TINY_I))

    with pytest.raises(RuntimeError, match="DeckLink hardware" if decklink else "no ffmpeg binary"):
        run(create())
