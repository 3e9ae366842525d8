"""CPU tests of the benchmark's harness: names resolve to files, the
result line's keys, the modules a run loads, the frozen roofline counts.

Run from the root of the checkout: ``python -m pytest bench_h100/tests``.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import types

import pytest

from bench_h100 import roofline
from bench_h100.reference.channel import transform_matrix
from bench_h100.run import loaded_forbidden, result_line
from bench_h100.spec import HERE, ROOT, load_benchmark, load_cell, metric_reader
from bench_h100.sink import Tick

BENCH = load_benchmark()
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_every_name_resolves_to_its_file():
    configs = {c["name"]: c for c in BENCH["configs"]}
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).is_file() and c["file"].startswith(tuple(BENCH["paths"]))
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert w["config"] in configs
        cell = load_cell(w["name"])
        assert cell.traffic["layers"] and cell.limits["code_gap"] >= 0
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "ticks_per_s", "tick_p95_ms"}
        assert cell.per_layer
    for m in BENCH["per_layer"]:
        assert callable(metric_reader(m["name"]))
    # every mix and limit file parses
    for path in list((HERE / "traffic").glob("*.json")) + list((HERE / "limits").glob("*.json")):
        assert json.loads(path.read_text())


def test_a_mix_added_in_a_new_file_is_found_without_editing_one(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(HERE, root / "bench_h100", ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = dict(bench["workloads"][0], name="uhd_rec.new_mix", traffic="new_mix")
    bench["workloads"].append(cell)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    here = root / "bench_h100"
    mix = json.loads((here / "traffic" / "media.json").read_text())
    mix["layers"] = mix["layers"][:2]
    (here / "traffic" / "new_mix.json").write_text(json.dumps(mix))
    (here / "limits" / "uhd_rec.new_mix.json").write_text('{"code_gap": 10}')
    got = load_cell("uhd_rec.new_mix", root=root, here=here)
    assert len(got.traffic["layers"]) == 2 and got.config["name"] == cell["config"]


def _fake_run(trace=None):
    cell = load_cell(BENCH["workloads"][0]["name"])
    ticks = [Tick(c, i, 0.0, None, True, 0.001, 0.004) for c in range(2) for i in range(5)]
    return types.SimpleNamespace(cell=cell, ticks=ticks, failed=0, memory_peak_bytes=123, trace=trace)


def test_the_result_line_carries_the_contract_keys_then_the_checks():
    run = _fake_run()
    gaps = [(0, 1, 0), (1, 3, 0)]
    line = result_line(run, gaps, {"ticks_per_s": 1.5, "setup_s": 2.0}, "NVIDIA H100 80GB HBM3", 1)
    assert list(line) == CONTRACT_KEYS + ["checks"]
    assert line["correct"] is True and line["attempted"] == 10 and line["failed"] == 0
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["metrics"]["ticks_per_s"] == {"value": 1.5, "unit": "ticks/s"}
    assert json.loads(json.dumps(line)) == line
    # a gap over the limit, a channel not compared, a tick out of order: not correct
    limit = run.cell.limits["code_gap"]
    assert not result_line(run, [(0, 1, limit + 1), (1, 3, 0)], {}, "x", 1)["correct"]
    assert not result_line(run, [(0, 1, 0)], {}, "x", 1)["correct"]
    run.ticks[3].index = 9
    assert not result_line(run, gaps, {}, "x", 1)["correct"]


def test_forbidden_modules_compare_the_whole_top_level_name(monkeypatch):
    fake = dict(sys.modules)
    for name in ("jax.numpy", "phaneron_tpu.ops", "flax", "phaneron_tpu_torch.ops", "jaxtyping_x"):
        fake[name] = types.ModuleType(name)
    monkeypatch.setattr(sys, "modules", fake)
    got = loaded_forbidden()
    assert {"jax.numpy", "phaneron_tpu.ops", "flax"} <= set(got)
    assert not {m for m in got if m.split(".")[0] in ("phaneron_tpu_torch", "jaxtyping_x")}


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole CPU run of the benchmarked cell in a fresh interpreter:
    afterwards no module whose top-level name is jax, jaxlib, flax or
    phaneron_tpu is loaded, and the reference loaded nothing of the
    program before the run imported it."""
    code = (
        "import asyncio, sys\n"
        "import bench_h100.reference.channel, bench_h100.roofline\n"
        "early = sorted(m for m in sys.modules if m.split('.')[0] in ('phaneron_tpu_torch', 'jax', 'phaneron_tpu'))\n"
        "from bench_h100.drive import run_cell, reference_gaps\n"
        "from bench_h100.run import loaded_forbidden\n"
        "from bench_h100.spec import load_benchmark, load_cell\n"
        "cell = load_cell(load_benchmark()['workloads'][0]['name'])\n"
        "run, bank, plan = asyncio.run(run_cell(cell, 2**31 + 9, 0.3, True, 'cpu', geometry=(96, 54)))\n"
        "reference_gaps(run, bank, plan)\n"
        "print(early, loaded_forbidden())\n"
    )
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[] []"


@pytest.mark.parametrize("stage, nbytes, ops, least_ms", [
    # PERF.md §6: K5 over v210 words, the progressive 4-layer frame at UHD: ops 0.1055 (7.07 GOP)
    ("composite", None, 7.07e9, 0.1055),
    # K3 10-bit 1080p: 0.0124 (41.5 MB); B12 1080p: 0.0108 (36.3 MB); B11 10-bit 1080p: 0.0099 (33.2 MB)
    ("unpack.planar422", 41.5e6, None, 0.0124),
    ("unpack.planar420", 36.3e6, None, 0.0108),
    ("pack.planar422", 33.2e6, None, 0.0099),
])
def test_frozen_roofline_counts_give_the_kernel_tables_figures(stage, nbytes, ops, least_ms):
    if stage == "composite":
        w, h = 3840, 2160
        mats = [transform_matrix(w, h, offset_x=0.02 + 0.003 * i, scale_x=0.9, scale_y=0.9) for i in range(4)]
        b, o = roofline.composite_bytes_ops([2] * 4, mats, w, h, "packed")
    elif stage == "unpack.planar422":
        b, o = roofline.unpack_bytes_ops("yuv422p10le", 1920, 1080)
    elif stage == "unpack.planar420":
        b, o = roofline.unpack_bytes_ops("yuv420p", 1920, 1080)
    else:
        b, o = roofline.pack_bytes_ops("yuv422p10le", 1920, 1080)
    if nbytes is not None:
        assert round(b / 1e6, 1) == nbytes / 1e6
    if ops is not None:
        assert round(o / 1e9, 2) == ops / 1e9
    assert round(roofline.least_s(b, o) * 1e3, 4) == least_ms


def test_kernel_names_map_to_stage_kinds():
    assert roofline.kernel_kind("void (anonymous namespace)::words_kernel<4, true>(int)") == "composite"
    assert roofline.kernel_kind("void (anonymous namespace)::planar422_pack_kernel<unsigned short>(x)") \
        == "pack.planar422"
    assert roofline.kernel_kind("void at::native::vectorized_elementwise_kernel<4>(int)") is None
    assert roofline.is_torch_op("void at::native::vectorized_elementwise_kernel<4>(int)")
    assert roofline.is_torch_op("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy")
    assert not roofline.is_torch_op("void (anonymous namespace)::warp_kernel<4, 1, false>(float const*)")


def test_the_staged_media_tick_counts_its_port_stages():
    """The media mix's tick: K3, two B12, the warp pair, the combine in
    torch ops, B11 (the route the traced runs launch)."""
    w, h = 3840, 2160
    box = transform_matrix(w, h, offset_x=0.2, offset_y=-0.15, scale_x=0.5, scale_y=0.5)
    layers = [{"sources": [("yuv422p10le", w, h)], "matrix": None},
              {"sources": [("yuv420p", w, h), ("nv12", w, h)], "matrix": box},
              {"sources": [("rgba8", w, h)], "matrix": None}]
    kinds = [s.kind for s in roofline.tick_stages(layers, "yuv422p10le", w, h)]
    assert kinds == ["unpack.planar422", "unpack.planar420", "unpack.planar420", "unpack.rgb8", "warp",
                     "combine", "pack.planar422"]
