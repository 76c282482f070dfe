"""The control: the reference put in the program's place one precision
lower than the configuration states (float8 e4m3 convolutions for the
bfloat16 detector, bfloat16 for the float32 team branch). At CPU size it
fails one of each cell's numbers while the program passes all of them;
at the cell's own size it runs on the GPU through benchmark/control.py."""

import json
import os
import subprocess
import sys

import pytest

from benchmark.harness.cell import ROOT
from benchmark.tests.conftest import run_small


@pytest.mark.parametrize("cell", ["classify-fused", "detect-only", "puck-sliced"])
def test_control_fails_where_the_program_passes(cell):
    _, out = run_small(cell, control=True)
    limits = {c.name: c.limit for c in out.checks}
    assert all(c.ok for c in out.checks)
    failed = [k for k, v in out.notes["control"].items() if v > limits[k]]
    assert failed, (out.notes["control"], limits)


@pytest.mark.card
@pytest.mark.parametrize("cell", ["classify-fused", "detect-only", "puck-sliced"])
def test_control_at_cell_size(card, cell, tmp_path):
    """Three seeds at the cell's own size on the GPU: every program
    reading within its limit, the control above one limit on each seed."""
    out = tmp_path / "control.json"
    subprocess.run([sys.executable, os.path.join(ROOT, "benchmark", "control.py"),
                    "--workload", cell, "--seeds", "101", "102", "103",
                    "--out", str(out)], check=True, timeout=1200, cwd=ROOT)
    limits = json.load(open(os.path.join(ROOT, "benchmark", "workloads",
                                         f"{cell}.json")))["limits"]
    for row in json.load(open(out)):
        assert all(v <= limits[k] for k, v in row["program"].items()), row
        assert any(v > limits[k] for k, v in row["control"].items()), row
