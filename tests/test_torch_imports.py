"""The port imports neither JAX nor the JAX package, and importing it
builds no kernel."""

import subprocess
import sys
from pathlib import Path

import torch

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]

_PROBE = """
import importlib, json, pkgutil, sys
import phaneron_tpu_torch
names = sorted(m.name for m in pkgutil.walk_packages(phaneron_tpu_torch.__path__, 'phaneron_tpu_torch.'))
for name in names:
    importlib.import_module(name)
import chip_smoke
from phaneron_tpu_torch.ops import _build
print(json.dumps({
    "modules": names,
    "jax": sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.') or m == 'jaxlib'),
    "reference": sorted(m for m in sys.modules if m == 'phaneron_tpu' or m.startswith('phaneron_tpu.')),
    "built": _build._load.cache_info().currsize,
}))
"""


def test_port_imports_no_jax_and_builds_nothing():
    import json

    out = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert "phaneron_tpu_torch.graph.pipeline" in res["modules"]
    assert "phaneron_tpu_torch.ops.kernels" in res["modules"]
    assert "phaneron_tpu_torch.ops.warp" in res["modules"]
    assert "phaneron_tpu_torch.ops.yadif" in res["modules"]
    assert "phaneron_tpu_torch.ops.packed_warp" in res["modules"]
    runtime = [
        "config", "audio.engine", "audio.filters", "runtime.stream", "runtime.clock",
        "runtime.types", "runtime.mixer", "runtime.layer", "runtime.channel",
        "producer.producer", "producer.test_pattern", "consumer.consumer", "utils.metrics",
        "graph.warmup",
        # the server and its control plane, and the I/O the default config runs
        "server", "control.chan_layer", "control.commands", "control.osc", "control.responses",
        "control.amcp", "control.mixer_cmds", "control.basic_cmds", "control.heads",
        "utils.hostio", "utils.avi", "consumer.file_consumer", "consumer.preview_consumer",
        "consumer.mjpeg_consumer", "producer.raw_file", "producer.route",
        # the last producers and consumers (A8b)
        "utils.fixtures", "utils.jpeg", "producer.wav_file", "producer.avi_file", "producer.image_seq",
        "producer.mjpeg", "producer.sdi_capture", "consumer.sdi_consumer", "producer.ffmpeg",
        "consumer.ffmpeg_consumer",
        # multi-device (A10)
        "parallel", "parallel.mesh", "parallel.bands", "parallel.dryrun", "parallel.multihost",
    ]
    for name in runtime:
        assert f"phaneron_tpu_torch.{name}" in res["modules"], name
    assert res["jax"] == []
    assert res["reference"] == []
    assert res["built"] == 0


def test_chip_smoke_exits_nonzero_without_cuda():
    """chip_smoke.py prints no result and exits non-zero where CUDA is
    not available."""
    if torch.cuda.is_available():
        return  # the card's own run covers the success path
    out = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode != 0
    assert '"ok"' not in out.stdout
