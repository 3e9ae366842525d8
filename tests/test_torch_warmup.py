"""The port's prewarm (graph/warmup.py) and its one kernel build.

``dummy_params`` must predict the shapes and types the layers deliver,
and the LOADBG prediction must be the structure PLAY runs (else its
tables are prepared for a structure that never comes); ``prewarm`` on the
CPU builds nothing; threads that ask for the kernel library at once wait
for one build."""

import threading
import time

import pytest
import torch

from conftest import run_async as run
from phaneron_tpu_torch.config import VideoFormat
from phaneron_tpu_torch.graph.pipeline import ChannelSpec, LayerSpec
from phaneron_tpu_torch.graph.warmup import TensorSpec, dummy_params, prewarm
from phaneron_tpu_torch.ops import _build
from phaneron_tpu_torch.producer.producer import LoadParams, ProducerRegistry
from phaneron_tpu_torch.producer.test_pattern import create_test_pattern_producer
from phaneron_tpu_torch.runtime.channel import Channel
from phaneron_tpu_torch.runtime.types import TransitionSpec

torch.set_num_threads(1)

TINY = VideoFormat("tiny", 1, 96, 64, 96, 50, 1, 48000, 2)
TINY_I = VideoFormat("tiny_i", 2, 96, 64, 96, 50, 1, 48000, 2)


def _shapes(tree):
    """params -> the same structure with (shape, dtype) leaves."""
    if isinstance(tree, torch.Tensor):
        return TensorSpec(tuple(tree.shape), tree.dtype)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_shapes(v) for v in tree)
    return {k: _shapes(v) for k, v in tree.items()}


def test_dummy_params_cover_spec_shapes():
    spec = ChannelSpec(
        96, 64, "v210",
        layers=(
            LayerSpec("v210", transition="dissolve", has_transform=True, src_b_format="v210"),
            LayerSpec("yuv422p8"),
            LayerSpec("rgba_f32", deinterlace=True, src_opaque=True),
            LayerSpec("v210", transition="wipe", mask_format="v210"),
        ),
    )
    layers = dummy_params(spec)["layers"]
    assert len(layers) == 4
    assert layers[0]["mix"] == TensorSpec((), torch.float32)
    assert layers[0]["matrix"] == layers[0]["matrix_b"] == TensorSpec((3, 3), torch.float32)
    assert layers[0]["src"] == layers[0]["src_b"] == [TensorSpec((64, 64), torch.int32)]
    assert [p.shape for p in layers[1]["src"]] == [(64, 96), (64, 48), (64, 48)]
    assert layers[1]["src"][0].dtype == torch.uint8
    assert layers[2]["src_ring"] == (TensorSpec((3, 64, 96), torch.float32),) * 3
    assert layers[2]["parity"] == TensorSpec((), torch.int32)
    assert set(layers[3]) == {"src", "src_b", "mask"}


def _drive(fmt, loads, ticks: int):
    """Load and play on a CPU channel; return every (spec, params) the
    frame program was given and every structure prewarm was asked for."""

    async def main():
        ch = Channel(1, fmt, ProducerRegistry([create_test_pattern_producer]), device="cpu")
        seen, predicted = [], []
        orig = ch._dispatch

        def record(spec, contribs):
            seen.append((spec, [c.params for c in contribs]))
            return orig(spec, contribs)

        ch._dispatch = record
        ch._prewarm = predicted.append
        for num, url, transition, fill in loads:
            assert await ch.load_source(num, LoadParams(url), transition=transition)
            for slot in (ch.layer(num).cur, ch.layer(num).next) if fill else ():
                if slot is not None:
                    slot.mixer.set_fill(0.02, 0.0, 0.9, 0.9)
            ch.play(num)
        for _ in range(ticks):
            await ch.render_frame()
        return seen, predicted

    return run(main())


CASES = {
    # a progressive v210 DVE dissolve under a yuv422p8 layer (the entry()
    # structure) and a wipe
    "progressive": (TINY, [(1, "BARS", None, True), (1, "RAMP", TransitionSpec("dissolve", 50), True),
                           (2, "BARS@yuv422p8", None, False), (3, "RAMP", None, False),
                           (3, "BARS", TransitionSpec("wipe", 50, mask_url="RAMP"), False)], 3),
    # an interlaced v210 dissolve with DVE: the slot's pair-deinterlaced
    # fields, alpha-free (src_opaque)
    "interlaced": (TINY_I, [(1, "BARS", None, True), (1, "RAMP", TransitionSpec("dissolve", 50), True)], 6),
}


@pytest.mark.parametrize("case", CASES)
def test_dummy_params_equal_what_the_layers_deliver(case):
    seen, _ = _drive(*CASES[case])
    layered = [(spec, params) for spec, params in seen if spec.layers]
    assert layered
    for spec, params in layered:
        assert _shapes({"layers": params}) == dummy_params(spec)


def test_interlaced_prediction_is_the_structure_play_runs():
    """The LOADBG prediction of an interlaced wire source is the live
    layer's structure: progressive rgba_f32 fields from the slot's pair
    deinterlace, src_opaque from the wire format (JAX's
    tests/test_warmup.py checks the same flag on its ring route)."""
    seen, predicted = _drive(TINY_I, [(1, "BARS", None, False)], 6)
    live = {spec for spec, _ in seen if spec.layers}
    assert live == {ChannelSpec(96, 64, "v210", (LayerSpec("rgba_f32", src_opaque=True),))}
    assert live <= set(predicted)
    layer = live.pop().layers[0]
    assert not layer.deinterlace and layer.src_opaque


def test_prewarm_on_the_cpu_builds_nothing():
    spec = ChannelSpec(96, 64, "v210", layers=(LayerSpec("v210", has_transform=True),))
    run(prewarm(spec, "cpu"))
    run(prewarm(spec._replace(out_format="yuv420p"), "cpu", plain=True))
    assert _build._load.cache_info().currsize == 0


def test_two_threads_share_one_kernel_build(monkeypatch, tmp_path):
    """Two threads that load the kernel library at once run nvcc once."""
    builds = []

    def fake_compile(out, srcs):
        builds.append(out)
        time.sleep(0.2)  # a build in progress when the second thread asks
        return "log"

    class FakeLib:
        def __getattr__(self, name):
            return lambda *a: 0

    monkeypatch.setattr(_build, "build_dir", lambda: tmp_path)
    monkeypatch.setattr(_build, "_compile", fake_compile)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: FakeLib())
    _build._load.cache_clear()
    try:
        libs = []
        threads = [threading.Thread(target=lambda: libs.append(_build.library())) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        assert len(libs) == 2 and libs[0] is libs[1]
        assert len(builds) == 1
        assert _build.build_info().compiled
    finally:
        _build._load.cache_clear()
