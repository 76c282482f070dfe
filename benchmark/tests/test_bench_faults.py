"""A whole run of each serving cell, cut to CPU size and past the
harness's look for a GPU, with the timed path broken underneath: each
fault has to turn `correct` false, and the unbroken run has to be
correct. The faults: a tracker step that returns its state unchanged,
half of each batch's detections left out, and an answer altered where it
is produced (boxes moved, every third box moved a little, a track id or
the puck's centre changed)."""

import numpy as np
import pytest
import torch

from benchmark.tests.conftest import correct, run_small
from hockey_tpu_torch.models import detector as det_mod
from hockey_tpu_torch.ops.nms import Detections
from hockey_tpu_torch.slicing import sahi


def _half_out(det: Detections) -> Detections:
    keep = torch.ones_like(det.valid)
    keep[det.valid.shape[0] // 2:] = False
    return det._replace(valid=det.valid & keep, scores=torch.where(keep, det.scores, -1.0))


def _moved(det: Detections) -> Detections:
    return det._replace(boxes=det.boxes + 12.0)


def _third_moved(det: Detections) -> Detections:
    """Every third detection slot's box moved 8 px: fewer than half of the
    boxes move, so a median gap alone would not see it."""
    shift = torch.zeros(det.boxes.shape[-2], 1, dtype=det.boxes.dtype)
    shift[::3] = 8.0
    return det._replace(boxes=det.boxes + shift)


def on_core(monkeypatch, change):
    real = det_mod.DetectCore.__call__

    def call(self, model, frames):
        out = real(self, model, frames)
        return change(out) if isinstance(out, Detections) else (change(out[0]), out[1])

    monkeypatch.setattr(det_mod.DetectCore, "__call__", call)


def state_unchanged(monkeypatch):
    real = det_mod.tracker_scan
    monkeypatch.setattr(det_mod, "tracker_scan",
                        lambda state, *a, **k: (state, real(state, *a, **k)[1]))


def track_id_altered(monkeypatch):
    real = det_mod.tracker_scan

    def scan(state, *a, **k):
        new, tids = real(state, *a, **k)
        return new, torch.where(tids >= 0, tids + 1, tids)

    monkeypatch.setattr(det_mod, "tracker_scan", scan)


def merge_changed(change):
    def apply(monkeypatch):
        real = sahi.SlicedDetector.merge
        monkeypatch.setattr(sahi.SlicedDetector, "merge",
                            lambda self, det: change(real(self, det)))
    return apply


def centre_moved(monkeypatch):
    real = sahi.PuckPipeline.ingest

    def ingest(self, boxes, scores):
        c, d, i = real(self, boxes, scores)
        return (None if c is None else (c[0] + 2.0, c[1])), d, i

    monkeypatch.setattr(sahi.PuckPipeline, "ingest", ingest)


FAULTS = {
    ("classify-fused", "state_unchanged"): state_unchanged,
    ("classify-fused", "track_id_altered"): track_id_altered,
    ("classify-fused", "half_batch_left_out"): lambda mp: on_core(mp, _half_out),
    ("classify-fused", "boxes_moved"): lambda mp: on_core(mp, _moved),
    ("classify-fused", "third_of_boxes_moved"): lambda mp: on_core(mp, _third_moved),
    ("detect-only", "half_batch_left_out"): lambda mp: on_core(mp, _half_out),
    ("detect-only", "boxes_moved"): lambda mp: on_core(mp, _moved),
    ("detect-only", "third_of_boxes_moved"): lambda mp: on_core(mp, _third_moved),
    ("puck-sliced", "half_batch_left_out"): merge_changed(_half_out),
    ("puck-sliced", "boxes_moved"): merge_changed(_moved),
    ("puck-sliced", "third_of_boxes_moved"): merge_changed(_third_moved),
    ("puck-sliced", "centre_moved"): centre_moved,
}


@pytest.mark.parametrize("cell", ["classify-fused", "detect-only", "puck-sliced"])
def test_sound_run_is_correct(cell):
    _, out = run_small(cell)
    assert correct(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted > 0 and out.metrics["frames_per_s"] > 0


@pytest.mark.parametrize("cell,fault", sorted(FAULTS))
def test_fault_is_caught(monkeypatch, cell, fault):
    FAULTS[cell, fault](monkeypatch)
    _, out = run_small(cell)
    assert not correct(out), [(c.name, c.value, c.limit) for c in out.checks]


def test_traced_run_reads_its_layers():
    """A traced run reads the counters and host spans it can read on the
    CPU, and no device metric (no device here)."""
    from benchmark.harness.cell import read_layers
    cell, out = run_small("classify-fused", trace=True)
    got = read_layers(cell, out.run)
    assert got["tracker_syncs_per_batch"]["value"] > 0
    assert got["tracker_host_ms"]["value"] > 0
    assert np.isfinite(got["pipeline_host_ms"]["value"])
    for name in ("upload_ms", "forward_ms", "device_idle_share.serve", "mfu.serve",
                 "nms_roofline"):
        assert name not in got
