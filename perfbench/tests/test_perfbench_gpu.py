"""On the card: each cell runs briefly through the command the driver runs
and comes out correct, the traced run reports the cell's per-layer metrics,
and the cell's control (perfbench/control.py) comes out not correct at the
limits of the cell's file.  Skips without a CUDA device (decided in a
fixture)."""

import json
import subprocess
import sys

import pytest

from perfbench.lib import config as cfgmod

CELLS = [w["name"] for w in cfgmod.benchmark()["workloads"]]


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU with CUDA")


@pytest.mark.gpu
@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct_on_the_card(card, cell, trace):
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         "3141592653", "--seconds", "6", "--trace", str(trace)],
        cwd=cfgmod.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], out.stderr[-3000:]
    assert res["device"]["platform"] == "gpu"
    if trace:
        want = {m["name"] for m in cfgmod.benchmark()["per_layer"]
                if cell in m["workloads"]}
        assert want <= set(res["metrics"]), out.stderr[-3000:]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_fails_each_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "perfbench/control.py", "--workload", cell,
         "--seconds", "6", "2718281828", "3141592653", "1618033988"],
        cwd=cfgmod.REPO, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    runs = [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]
    assert len(runs) == 3 and not any(r["correct"] for r in runs), runs
