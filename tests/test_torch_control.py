"""Port parity for the control plane: every AMCP script of
tests/test_control.py (and a few more commands) goes over TCP to the JAX
package's server and to the port's (``device="cpu"``), each on ports the
OS chose, and the response lines must be equal letter for letter; the
OSC codec's bytes equal JAX's; a heads rundown taken over OSC gives equal
frames.

Both servers register the 96x64 ``tiny5000`` format test_control.py
uses.  Each command is followed by ``REQ sync PING`` and its response is
every line before ``PONG sync``, so multi-line bodies (200/201, the 400
echo line) are compared whole without parsing their framing."""

import asyncio
import json
import socket

import numpy as np
import pytest
import torch

from conftest import run_async as run
from phaneron_tpu import config as jconfig
from phaneron_tpu_torch import config as tconfig
from phaneron_tpu_torch.graph.convert import words_to_numpy
from torch_parity import max_code_delta

torch.set_num_threads(1)

TINY = ("tiny5000", 1, 96, 64, 96, 50, 1, 48000, 2)
jconfig.VIDEO_FORMATS.setdefault("tiny5000", jconfig.VideoFormat(*TINY))
tconfig.VIDEO_FORMATS.setdefault("tiny5000", tconfig.VideoFormat(*TINY))


def _config(cfg_mod, n_channels: int = 1, **kw):
    return cfg_mod.ServerConfig(
        channels=[cfg_mod.ConsumerConfig("tiny5000", {}) for _ in range(n_channels)],
        amcp_port=0, osc_listen_port=0, osc_remote_port=9, **kw,
    )


async def _start(jax_side: bool, n_channels: int, **kw):
    """A started server of either package on free ports, and its AMCP port."""
    if jax_side:
        from phaneron_tpu.server import PhaneronServer

        server = PhaneronServer(_config(jconfig, n_channels, **kw))
        await server.start()
        return server, server.amcp._server.sockets[0].getsockname()[1]
    from phaneron_tpu_torch.server import PhaneronServer

    server = PhaneronServer(_config(tconfig, n_channels, **kw), device="cpu")
    await server.start()
    return server, server.amcp.port


async def _session(jax_side: bool, script: list, n_channels: int = 1, **kw) -> list:
    server, port = await _start(jax_side, n_channels, **kw)
    try:
        reader, writer = await asyncio.open_connection("127.0.0.1", port)
        out = []
        for cmd in script:
            writer.write(f"{cmd}\r\nREQ sync PING\r\n".encode())
            await writer.drain()
            lines = []
            while (line := (await asyncio.wait_for(reader.readline(), 30)).decode()) != "PONG sync\r\n":
                lines.append(line)
            out.append((cmd, lines))
        writer.close()
        await writer.wait_closed()
        return out
    finally:
        await server.shutdown()


def _clip(tmp_path, name: str = "clip.96x64.v210", n: int = 4):
    """test_control.py's clip: n v210 frames of the fill_buf ramp, the
    frame number tagged in the first word."""
    from phaneron_tpu_torch.ops.formats import v210

    frames = []
    for k in range(n):
        words = v210.fill_buf(96, 64)[0].copy()
        words[0, 0] = k
        frames.append(words.tobytes())
    clip = tmp_path / name
    clip.write_bytes(b"".join(frames))
    return clip


def _scripts(tmp_path) -> dict:
    clip = _clip(tmp_path)
    media = tmp_path / "media"
    media.mkdir(exist_ok=True)
    (media / "clip.1920x1080.v210").write_bytes(b"x" * 64)
    (media / "clip.1920x1080.v210.json").write_text("{}")
    (media / "other.yuv420p").write_bytes(b"y" * 96)
    return {
        # test_amcp_play_and_mixer, and the other MIXER forms, INFO, the stubs
        "play_mixer": (1, {}, [
            "VERSION", "PLAY 1-1 BARS", "MIXER 1-1 FILL 0.1 0.1 0.5 0.5", "MIXER 1-1 ROTATION 45",
            "MIXER 1-1 FILL", "MIXER 1-1 ANCHOR 0.1 0.2", "MIXER 1-1 VOLUME 0.5", "MIXER 1-9 FILL 0 0 1 1",
            "MIXER 1-1 FILL 0.5", "INFO", "INFO 9", "CINF AMB", "FLS", "TLS", "DIAG",
            "PAUSE 1-1", "RESUME 1-1", "STOP 1-1", "CLEAR 1", "PLAY 9-1 BARS", "NOSUCH 1-1",
            "SWITCH 207", "VERSION", "SWITCH 999", "SWITCH 220", "VERSION", "REQ tok1 PLAY 1-1 RAMP",
            "REQ tok2 NOSUCH", "PING", "REQ tok3 PING", "CALL 1-1 HIGHPASS 120", "CALL 1-1 HIGHPASS OFF",
            "CALL 1-1 ADELAY 480", "CALL 1-1 ACOMPRESSOR 0.2 4", "CALL 1-1 ACOMPRESSOR x",
            f'ADD 1 FILE path {tmp_path / "added.v210"}', "REMOVE 1", "REMOVE 1", "CLEAR 1-5",
        ]),
        # test_amcp_loadbg_transition_tokens, and a wipe, LOAD and AUTO
        "loadbg_transition": (1, {}, [
            "PLAY 1-1 BARS", "LOADBG 1-1 BLACK MIX 10", "PLAY 1-1", "LOADBG 1-1 RAMP WIPE 5",
            "PLAY 1-1", "LOAD 1-2 RAMP", "PLAY 1-2", "LOADBG 1-3 BARS AUTO", "LOADBG 1-3 CUT 1",
            "LOADBG 1-3", "LOAD 9-1 BARS",
        ]),
        # test_swap_layers, and a swap across channels
        "swap": (2, {}, [
            "PLAY 1-1 BARS", "PLAY 1-2 RAMP", "SWAP 1-1 1-2", "SWAP 1-1 9-1", "PLAY 2-1 BLACK",
            "SWAP 1-1 2-1", "SWAP 1-1", "INFO",
        ]),
        # test_cls_lists_real_media, in every protocol version
        "cls": (1, {"media_root": str(media)}, ["CLS", "SWITCH 207", "CLS", "SWITCH 220", "CLS"]),
        # test_call_seek_on_raw_file, and LENGTH / SEEK at load
        "call_seek": (1, {}, [
            f'PLAY 1-1 "{clip}" LOOP', "CALL 1-1 SEEK 2", "CALL 1-1 LOOP 0", "CALL 1-1 NOSUCH 1",
            "CALL 1-1 SEEK", "CALL 1-9 SEEK 1", f'PLAY 1-2 "{clip}" SEEK 1 LENGTH 2',
            f'PLAY 1-3 "{tmp_path / "missing.v210"}"',
        ]),
        # test_decklink_url_falls_back_to_bars
        "decklink": (1, {}, ["PLAY 1-1 DECKLINK 1", "PLAY 1-2 DECKLINK DEVICE 2", "INFO"]),
    }


@pytest.mark.parametrize("name", ["play_mixer", "loadbg_transition", "swap", "cls", "call_seek", "decklink"])
def test_amcp_scripts_answer_as_the_jax_server(tmp_path, name):
    n_channels, kw, script = _scripts(tmp_path)[name]

    async def main():
        return (await _session(True, script, n_channels, **kw),
                await _session(False, script, n_channels, **kw))

    jax_out, port_out = run(main())
    assert port_out == jax_out
    assert all(lines for _, lines in port_out)


def test_stdin_repl_answers_as_the_jax_server(monkeypatch, capsys):
    """The stdin REPL: the same lines give the same printed responses, and
    'q' stops the server."""
    import io

    lines = "VERSION\nPLAY 1-1 BARS\nMIXER 1-1 FILL 0 0 0.5 0.5\nINFO\nNOSUCH\nq\n"

    async def repl(jax_side):
        server, _ = await _start(jax_side, 1)
        try:
            monkeypatch.setattr("sys.stdin", io.StringIO(lines))
            capsys.readouterr()
            await asyncio.wait_for(server.repl(), 30)
            assert server._stop_event.is_set()
            return capsys.readouterr().out
        finally:
            await server.shutdown()

    jax_out, port_out = run(repl(True)), run(repl(False))
    assert port_out == jax_out
    assert "202 PLAY OK" in port_out and "200 INFO OK" in port_out


def test_osc_codec_bytes_equal_jax():
    from phaneron_tpu.control import osc as josc
    from phaneron_tpu_torch.control import osc as tosc

    messages = [
        ("/heads/take", (1,)), ("/heads/load", ("spec.json",)), ("/a/b", (1, 2.5, "go", b"\x01\x02\x03")),
        ("/flag", (True, False)), ("/empty", ()), ("/float", (-0.125, 3.0e9)), ("/pad4", ("abcd", b"")),
    ]
    for address, args in messages:
        data = tosc.encode_message(address, *args)
        assert data == josc.encode_message(address, *args)
        assert tosc.decode_message(data) == josc.decode_message(data)
    with pytest.raises(TypeError):
        tosc.encode_message("/bad", object())


def test_heads_rundown_over_osc_gives_jax_frames(tmp_path):
    """A rundown (a cut, then a dissolve, then two more layers), loaded
    and taken by OSC datagrams to the listener: every rendered frame
    equals JAX's.  Each take preloads the next event's layers; the test
    renders once they are loaded (a preload onto a dissolving layer would
    replace its incoming source at a time the loader thread decides)."""
    from phaneron_tpu.control import heads as jheads
    from phaneron_tpu.control import osc as josc
    from phaneron_tpu.producer import producer as jproducer
    from phaneron_tpu.producer import test_pattern as jpattern
    from phaneron_tpu.runtime import channel as jchannel
    from phaneron_tpu_torch.control import heads as theads
    from phaneron_tpu_torch.control import osc as tosc
    from phaneron_tpu_torch.producer import producer as tproducer
    from phaneron_tpu_torch.producer import test_pattern as tpattern
    from phaneron_tpu_torch.runtime import channel as tchannel

    spec = {
        "events": [
            {"duration": 0, "layers": [{"layerNum": 1, "url": "BARS"}]},
            {"duration": 0, "layers": [{"layerNum": 1, "url": "RAMP",
                                        "transition": {"type": "dissolve", "length": 3}}]},
            {"duration": 0, "layers": [{"layerNum": 2, "url": "BARS", "seek": 5},
                                       {"layerNum": 3, "url": "BLACK"}]},
        ],
    }
    path = tmp_path / "heads.json"
    path.write_text(json.dumps(spec))

    async def preloaded(heads, ch):
        """Wait until the take has loaded the next event's sources."""
        events = spec["events"]
        if heads.running and heads.event_index + 1 < len(events):
            for lay in events[heads.event_index + 1]["layers"]:
                while lay["layerNum"] not in ch.layers or ch.layers[lay["layerNum"]].next is None:
                    await asyncio.sleep(0.01)

    async def rundown(jax_side):
        if jax_side:
            ch = jchannel.Channel(1, jconfig.VIDEO_FORMATS["tiny5000"],
                                  jproducer.ProducerRegistry([jpattern.create_test_pattern_producer]),
                                  use_pallas=False)
            osc, heads_mod, words = josc.Osc(0, "127.0.0.1", 9), jheads, np.asarray
        else:
            ch = tchannel.Channel(1, tconfig.VIDEO_FORMATS["tiny5000"],
                                  tproducer.ProducerRegistry([tpattern.create_test_pattern_producer]), device="cpu")
            osc, heads_mod, words = tosc.Osc(0, "127.0.0.1", 9), theads, words_to_numpy
        await osc.start()
        port = osc._transport.get_extra_info("sockname")[1]
        heads = heads_mod.Heads(osc, ch, {"load": "/heads/load", "take": "/heads/take"})
        frames = []
        sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            sock.sendto(josc.encode_message("/heads/load", str(path)), ("127.0.0.1", port))
            while heads.spec is None or any(  # load_spec preloads event 0 (LOAD)
                    lay["layerNum"] not in ch.layers or ch.layers[lay["layerNum"]].cur is None
                    for lay in spec["events"][0]["layers"]):
                await asyncio.sleep(0.01)
            await heads.run()
            await preloaded(heads, ch)
            for _ in range(3):
                for _ in range(4):
                    frames.append(words((await ch.render_frame()).packed[0]))
                index = heads.event_index
                sock.sendto(josc.encode_message("/heads/take", 1), ("127.0.0.1", port))
                while heads.event_index == index and heads.running:
                    await asyncio.sleep(0.01)
                await preloaded(heads, ch)
            return frames
        finally:
            sock.close()
            osc.close()

    jax_frames, port_frames = run(rundown(True)), run(rundown(False))
    assert len(port_frames) == len(jax_frames) == 12
    for j, t in zip(jax_frames, port_frames):
        assert max_code_delta(j, t, 96, 64) == 0
