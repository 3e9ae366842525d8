"""Port parity for the host audio path: the port's copies of
``audio/engine.py`` and ``audio/filters.py`` and its Mixer's audio chain
give exactly JAX's arrays on seeded numpy inputs (the cases of
tests/test_audio.py and tests/test_audio_filters.py).  Both are numpy on
the host, so the contract is equality."""

import numpy as np
import pytest

from phaneron_tpu.audio import engine as jengine
from phaneron_tpu.audio import filters as jfilters
from phaneron_tpu.runtime.mixer import Mixer as JMixer
from phaneron_tpu_torch.audio import engine as tengine
from phaneron_tpu_torch.audio import filters as tfilters
from phaneron_tpu_torch.runtime.mixer import Mixer as TMixer

Q = tengine.QUANTUM


def _noise(seed: int, channels: int = 2, n: int = Q) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal((channels, n)).astype(np.float32) * 0.5


def _tone(freq: float, n: int = Q * 8, rate: int = 48000, ch: int = 2) -> np.ndarray:
    t = np.arange(n, dtype=np.float32) / rate
    return np.stack([np.sin(2 * np.pi * freq * t).astype(np.float32)] * ch)


def _chunks(x: np.ndarray, step: int = Q):
    return [x[:, o : o + step] for o in range(0, x.shape[1], step)]


# Each case runs one engine call sequence against a module (JAX's or the
# port's) and returns the list of arrays it produced.
ENGINE_CASES = {
    "silence": lambda m: [m.silence(4, 256), m.silence(8)],
    "apply_volume": lambda m: [m.apply_volume(_noise(1), g) for g in (1.0, 0.5, 0.0)],
    "pan": lambda m: [m.pan(_noise(2), np.array([[0, 1], [1, 0]], np.float32)),
                      m.pan(_noise(3, 4), np.random.default_rng(4).random((2, 4), dtype=np.float32))],
    "amix": lambda m: [m.amix([_noise(5), _noise(6)]), m.amix([_noise(5), _noise(6)], normalize=False),
                       m.amix([_noise(7)]), m.amix([_noise(8, n=960) for _ in range(3)])],
    "adapt_channels": lambda m: [m.adapt_channels(_noise(9), 8), m.adapt_channels(_noise(9, 8), 2),
                                 m.adapt_channels(_noise(9, 3), 3)],
    "crossfade": lambda m: [m.crossfade(_noise(10), _noise(11), mix) for mix in (1.0, 0.75, 0.5, 0.25, 0.0)]
    + [m.crossfade(_noise(10), _noise(11), 0.3, constant_power=True)],
    "rechunker": lambda m: _rechunk(m),
    "linear_resampler": lambda m: _resample(m),
    "interleave_s32": lambda m: [m.interleave_s32(_noise(12)),
                                 m.interleave_s32(np.array([[1.0, -1.0], [0.5, 0.25]], np.float32))],
}


def _rechunk(m) -> list:
    r = m.Rechunker(2, 960)
    out = []
    for k, n in enumerate((1024, 1024, 300, 2000, 17)):
        out += r.push(_noise(20 + k, n=n))
    tail = r.flush()
    assert r.flush() is None
    return out + [tail]


def _resample(m) -> list:
    rs = m.LinearResampler(24000, 48000, 2)
    out = [rs.push(c) for c in _chunks(_tone(600.0, 24000, 24000), 700)]
    down = m.LinearResampler(48000, 44100, 1)
    return out + [down.push(c) for c in _chunks(_noise(30, 1, 5000), 1024)]


@pytest.mark.parametrize("case", ENGINE_CASES)
def test_engine_equals_jax(case):
    want, got = ENGINE_CASES[case](jengine), ENGINE_CASES[case](tengine)
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)


FILTER_CASES = {
    "highpass_low": lambda m: m.Highpass(frequency=1000.0),
    "highpass_300": lambda m: m.Highpass(300.0),
    "delay_100": lambda m: m.Delay(samples=100),
    "compressor": lambda m: m.Compressor(threshold=0.1, ratio=4.0, attack=1.0, release=50.0),
    "compressor_default": lambda m: m.Compressor(threshold=0.1, ratio=4.0),
}


@pytest.mark.parametrize("case", FILTER_CASES)
def test_filters_equal_jax_chunk_by_chunk(case):
    """Each filter over a tone and noise, quantum by quantum with carried
    state, and over one whole block."""
    x = _tone(50.0) * 0.8 + _noise(40, n=Q * 8) * 0.1
    f_j, f_t = FILTER_CASES[case](jfilters), FILTER_CASES[case](tfilters)
    for c in _chunks(x):
        np.testing.assert_array_equal(f_t.process(c), f_j.process(c))
    np.testing.assert_array_equal(FILTER_CASES[case](tfilters).process(x), FILTER_CASES[case](jfilters).process(x))


def test_filter_chain_and_mixer_audio_equal_jax():
    """FilterChain order and the Mixer's pan -> filters -> volume chain."""
    for fmod in (jfilters, tfilters):
        ch = fmod.FilterChain()
        ch.set("acompressor", threshold=0.5)
        ch.set("highpass", frequency=100.0)
        assert ch.active == ["highpass", "acompressor"]
    mixers = []
    for cls in (JMixer, TMixer):
        m = cls(1920, 1080)
        m.set_volume(0.5)
        m.set_levels([1.0, 0.25])
        m.set_audio_filter("highpass", frequency=2000.0)
        m.set_audio_filter("adelay", samples=37)
        mixers.append(m)
    for c in _chunks(_tone(50.0, Q * 3) + _noise(41, n=Q * 3)):
        np.testing.assert_array_equal(mixers[1].apply_audio(c), mixers[0].apply_audio(c))
    for m in mixers:
        m.clear_audio_filter()
        m.muted = True
    x = _noise(42)
    np.testing.assert_array_equal(mixers[1].apply_audio(x), mixers[0].apply_audio(x))
