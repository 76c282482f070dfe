"""Shared pieces of the benchmark's CPU tests: a cell cut to a size the
CPU runs in seconds (270x480 frames, the player model at 320, frame
batch 2; 540x960 frames in 320-px tiles for the puck), and the `card`
marker of tests that need a GPU, which skip here from inside the test."""

from __future__ import annotations

import os
import sys
import time

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark.harness import cell as cellmod  # noqa: E402


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA GPU; skips without one")


@pytest.fixture
def card():
    """Skips the test where there is no GPU (decided when the test runs)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return "cuda"


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def small_cell(name: str) -> cellmod.Cell:
    """The cell `name` with its sizes cut for the CPU; its limits are the
    cell's own."""
    cell = cellmod.Cell.load(name)
    w = cell.workload
    w["traffic"].update(frames=12, frame_hw=[270, 480], heights=[60, 90], speed=3.0)
    w["program"] = dict(frame_batch=2, detection_imgsz=320, use_device_tracker=True,
                        initialization_stride=2, max_initialization_frames=3,
                        puck_slice_size=160)
    w.update(warmup_batches=1, trace_batches=2, sample_batches=2)
    if "size" in w["reference"]:
        # the puck keeps its drawn size, so its frames and tiles are cut
        # less, for the tiles to hold it as the cell's do
        w["traffic"].update(frame_hw=[540, 960], heights=[110, 170], speed=5.0,
                            puck={"start": [120.0, 300.0], "step": [12.0, 2.0]})
        w["program"]["puck_slice_size"] = 320
        w["reference"]["size"] = 320
    else:
        w["reference"]["imgsz"] = 320
    return cell


def run_small(name: str, seed: int = 2**31 + 17, trace: bool = False,
              control: bool = False, seconds: float = 0.5):
    """A whole run of the cut cell on the CPU, past the harness's look for
    a GPU: (cell, Outcome)."""
    cell = small_cell(name)
    driver = cellmod.load_module(
        os.path.join(cellmod.BENCH_DIR, "drivers", f"{cell.workload['driver']}.py"),
        f"bench_driver_{cell.workload['driver']}")
    out = driver.run(cell, seed=seed, seconds=seconds, trace=trace, device="cpu",
                     t_start=time.perf_counter(), control=control)
    return cell, out


def correct(out) -> bool:
    return all(c.ok for c in out.checks) and out.failed == 0
