"""Each cell's comparison fails what it must fail. A whole run at tiny size
on the CPU, past the look for a card, with the timed path broken
underneath, comes out not correct: the step that leaves its state
unchanged, the loss over half the batch, the teacher's answer altered where
it is made; so does the control (the program's own int8 teacher path, the
precision below the configuration's bf16). A sound run comes out correct.
The readings at the cells' own size, from which the limits were set, are
in PERF.md (portbench/calibrate.py on the card)."""

import json
import types

import pytest
import torch

from portbench import run as bench_run

SEED = 2 ** 31 + 2024
FAULTS = {"sds_default": ["unchanged", "half_batch", "altered"],
          "sds_exact": ["unchanged", "half_batch", "altered"],
          "generate_grid": ["half_batch", "altered"]}


def _line(cell, **kw):
    args = types.SimpleNamespace(workload=cell, seed=SEED, seconds=0.1,
                                 trace=0)
    lines = []
    assert bench_run.run(args, torch, device="cpu", tiny=True,
                         out=lines.append, err=lambda s: None, **kw) == 0
    return json.loads(lines[-1])


def _cells():
    from portbench import harness

    return [w["name"] for w in
            harness.load_json(harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", _cells())
def test_a_sound_run_is_correct(cell):
    line = _line(cell)
    assert line["correct"], line["check"]


@pytest.mark.parametrize("cell,fault", [(c, f) for c in FAULTS
                                        for f in FAULTS[c]])
def test_a_planted_fault_is_not_correct(cell, fault):
    if cell not in _cells():
        pytest.skip(f"{cell} is not a cell of BENCHMARK.json")
    line = _line(cell, fault=fault)
    assert not line["correct"], line["check"]


@pytest.mark.parametrize("cell", _cells())
def test_the_control_is_not_correct(cell):
    line = _line(cell, control=True)
    assert not line["correct"], line["check"]
