"""CPU tests of what decides ``correct``: the plain reference equals the
port's plain channel at a tiny geometry in every cell's mix and in the
generator's other paths; the control (the reference in bfloat16 in the
program's place) fails the limit; and a run whose timed path is broken underneath comes out not
correct.  Each drives the harness's run on the CPU (it skips the look
for a chip) at 96x54 or 192x108, a short window, a large seed.

Run from the root of the checkout: ``python -m pytest bench_h100/tests``.
"""

from __future__ import annotations

import asyncio

import pytest
import torch

from bench_h100.drive import control_gaps, reference_gaps, run_cell
from bench_h100.faults import FAULTS, planted
from bench_h100.run import judge
from bench_h100.spec import Cell, load_benchmark, load_cell

SEED = 2**31 + 977
# on the card a window's ticks reach thousands, where a frozen MIX weight
# has drifted far off; a tiny run gets past the first hundreds by warm-up
FAULT_WARMUP_TICKS = 200
BENCHED = [w["name"] for w in load_benchmark()["workloads"]]

# the generator's other paths, which a cell added as data alone would
# take: v210 sources decoded at the taps of a packed composite, and an
# off-size clip pair stretched to the channel under a keyed graphic, into
# v210 (a configuration and a mix each, given here rather than as files)
_V210_CONFIG = {"name": "v210_out", "video_format": "2160p5000", "width": 3840, "height": 2160,
                "channels": 2, "out_format": "v210", "col_spec": "709"}
_MIX = {"in_flight": 2, "source_frames": 4, "warmup_ticks": 4, "sample_ticks": 4,
        "transition": {"type": "dissolve", "length": 16384}}
GENERATOR_PATHS = {
    "v210_words_dve": (_V210_CONFIG, dict(_MIX, layers=[
        {"from": {"format": "v210"}, "to": {"format": "v210"}, "fill": [0.02, 0.0, 0.9, 0.9],
         "fill_per_layer": [0.003, 0.0, 0.0, 0.0], "fill_per_channel": [0.0007, 0.0, 0.0, 0.0]}] * 2)),
    "offsize_pair_keyed": (_V210_CONFIG, dict(_MIX, layers=[
        {"from": {"format": "yuv422p10le"}, "fill": [0.25, 0.25, 0.5, 0.5]},
        {"from": {"format": "yuv420p", "size": [1280, 720]}, "to": {"format": "nv12", "size": [1280, 720]},
         "fill": [-0.25, 0.25, 0.5, 0.5]},
        {"from": {"format": "rgba8", "box": [0.1, 0.62, 0.9, 0.9], "soft": 12}, "fill": [0.0, 0.0, 0.95, 0.95]}])),
}


def _cell(name: str) -> Cell:
    if name in GENERATOR_PATHS:
        config, mix = GENERATOR_PATHS[name]
        return Cell(name, config, mix, {"code_gap": 0}, [], [])
    return load_cell(name)


def _run(cell, geometry=(96, 54), seconds=0.3):
    return asyncio.run(run_cell(cell, SEED, seconds, False, "cpu", geometry=geometry))


@pytest.mark.parametrize("name", BENCHED + sorted(GENERATOR_PATHS))
def test_the_reference_equals_the_ports_plain_channel(name):
    run, bank, plan = _run(_cell(name), geometry=(192, 108), seconds=1.5)
    gaps = reference_gaps(run, bank, plan)
    assert run.ticks and len({c for c, _, _ in gaps}) == run.cell.config["channels"]
    assert max(g for _, _, g in gaps) == 0, gaps


@pytest.mark.parametrize("cell_name", BENCHED)
def test_the_bfloat16_control_fails_the_limit(cell_name):
    cell = load_cell(cell_name)
    run, bank, plan = _run(cell)
    program = reference_gaps(run, bank, plan)
    control = control_gaps(run, bank, plan)
    limit = cell.limits["code_gap"]
    assert judge(run, program)[0]
    assert min(g for _, _, g in control) > limit
    assert not judge(run, control)[0]


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell_name", BENCHED)
def test_a_broken_timed_path_comes_out_not_correct(cell_name, fault):
    cell = load_cell(cell_name)
    cell.traffic = dict(cell.traffic, warmup_ticks=FAULT_WARMUP_TICKS)
    with planted(fault):
        run, bank, plan = _run(cell)
    correct, failed, checks = judge(run, reference_gaps(run, bank, plan))
    assert not correct and failed > 0
    assert checks["code_gap"]["value"] > checks["code_gap"]["limit"]


def test_the_control_is_the_reference_in_a_lower_precision():
    """The control's codes move with the precision alone: the same
    reference in float32 reads 0 against itself."""
    cell = load_cell(BENCHED[0])
    run, bank, plan = _run(cell)
    assert max(g for _, _, g in control_gaps(run, bank, plan, dt=torch.float32)) == 0
