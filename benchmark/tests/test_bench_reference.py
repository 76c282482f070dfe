"""The plain reference against hockey_tpu_torch at a tiny size on the CPU,
both in float32 on the same inputs: the weight reader, the detector, the
sliced detector, the tracker, the team branch and fit, the puck tracker."""

import numpy as np
import pytest
import torch

from benchmark.reference import puck as ref_puck
from benchmark.reference import teams as ref_teams
from benchmark.reference import tracker as ref_tracker
from benchmark.reference.compare import match, padded_rows
from benchmark.reference.msgpack import load_tree
from benchmark.reference.yolo import Detector, SlicedDetector
from benchmark.traffic import scenes
from hockey_tpu_torch.core.config import Config
from hockey_tpu_torch.models import checkpoint
from hockey_tpu_torch.models.detector import Detector as ProgDetector
from hockey_tpu_torch.models.detector import team_features
from hockey_tpu_torch.slicing.sahi import PuckTracker, SlicedDetector as ProgSliced
from hockey_tpu_torch.teams.segmentation import SegmentationTeamClassifier
from hockey_tpu_torch.tracking import device_tracker

PLAYER = "hockey-player-detection"
PUCK = "hockey-puck-detection"
HW = (270, 480)


def frames(seed=3, n=2, puck=False):
    kw = dict(players=10, hw=HW, heights=(60, 90), speed=3.0)
    if puck:
        return scenes.puck_scene(seed, n, (60.0, 150.0), (6.0, 1.0), **kw)
    return scenes.synthetic_frames(seed, n, **kw)


def test_weight_reader():
    ref = load_tree(checkpoint.shipped_weights_path(PUCK))
    prog = checkpoint.load_params(checkpoint.shipped_weights_path(PUCK))
    a, b = checkpoint.flatten_tree(ref), checkpoint.flatten_tree(prog)
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("conf", [0.1, 0.4])
def test_detector(conf):
    f = frames()
    cfg = Config(nms_pre_topk=256)
    prog = ProgDetector(PLAYER, cfg, frame_hw=HW, imgsz=320, conf=conf, device="cpu",
                        dtype=torch.float32)
    d = prog.detect_batch(f)
    got = padded_rows(d.boxes.numpy(), d.scores.numpy(), d.classes.numpy(), d.valid.numpy())
    ref = Detector(checkpoint.shipped_weights_path(PLAYER), "cpu", imgsz=320, conf=conf,
                   iou=0.45, containment=0.5, pre_topk=256, max_det=64)(f)
    assert sum(len(r["boxes"]) for r in ref) >= 4
    m = match(got, ref)
    assert m["box"].max() < 0.01 and m["score"].max() < 1e-4, m
    assert m["unmatched"].size == 0, m


def test_sliced_detector():
    f = frames(puck=True)
    cfg = Config(puck_slice_size=160)
    prog = ProgSliced(cfg, HW, device="cpu", dtype=torch.float32)
    boxes, scores, valid = prog.detect_frames(f)
    got = [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]],
            "classes": np.zeros(int(valid[i].sum()))} for i in range(len(f))]
    ref, tiles = SlicedDetector(
        checkpoint.shipped_weights_path(PUCK), "cpu", size=160, overlap=0.2, conf=0.25,
        iou=0.45, containment=0.5, pre_topk=256, tile_max_det=8, merge_iou=0.5,
        merge_topk=64, merge_max_det=4)(f)
    assert len(tiles) == 2 * 8
    m = match(got, ref)
    assert m["box"].max() < 0.01 and m["score"].max() < 1e-4, m
    assert m["unmatched"].size == 0, m


def test_tracker():
    """Eight steps of both trackers on the same drifting detections."""
    g = torch.Generator().manual_seed(0)
    kw = dict(activation_thresh=0.4, match_thresh=0.95, max_time_lost=30,
              min_consecutive=2, duplicate_kill_iomin=0.55, lost_dup_kill_iomin=0.55)
    base = torch.rand(16, 2, generator=g) * 400
    size = 40 + torch.rand(16, 2, generator=g) * 60
    sp = device_tracker.init_state(32, "cpu")
    sr = ref_tracker.init_state(32, "cpu")
    for t in range(8):
        xy = base + t * 3.0 + torch.randn(16, 2, generator=g)
        boxes = torch.cat([xy, xy + size], 1)[None]
        scores = torch.rand(1, 16, generator=g)
        classes = (torch.rand(1, 16, generator=g) < 0.2).int()
        valid = torch.rand(1, 16, generator=g) < 0.9
        sp, tp = device_tracker.tracker_scan(sp, boxes, scores, classes, valid, **kw)
        sr, tr = ref_tracker.tracker_scan(sr, boxes, scores, classes, valid, **kw)
        assert torch.equal(tp, tr)
        for a, b in zip(sp, sr):
            assert torch.equal(a, b)
    assert int(sp.next_id) > 1


def test_team_branch_and_fit():
    f = frames(n=2)
    ref = Detector(checkpoint.shipped_weights_path(PLAYER), "cpu", imgsz=320, conf=0.4,
                   iou=0.45, containment=0.5, pre_topk=256, max_det=64)(f)
    boxes = torch.zeros(2, 16, 4)
    for i, r in enumerate(ref):
        boxes[i, :len(r["boxes"])] = torch.from_numpy(r["boxes"])
    x = torch.from_numpy(f)
    prog = team_features(x, boxes).numpy()
    got = ref_teams.team_features(x, boxes).numpy()
    np.testing.assert_array_equal(prog[..., 1], got[..., 1])
    assert np.abs(prog - got).max(axis=(0, 1)).tolist() <= [1e-4, 0, 1e-2, 1e-2]
    crops = [c for fr, r in zip(f, ref)
             for c in ref_teams.host_crops(fr, r["boxes"][r["classes"] == 0])]
    clf = SegmentationTeamClassifier(device="cpu")
    clf.fit(crops)
    np.testing.assert_allclose(ref_teams.fit_centres(crops),
                               clf.kmeans.cluster_centers_, rtol=1e-6, atol=1e-6)


def test_puck_tracker():
    rng = np.random.default_rng(1)
    a, b = PuckTracker(trail_length=30), ref_puck.PuckTracker(trail_length=30)
    for t in range(60):
        n = int(rng.integers(0, 3))
        c = np.array([100 + 9 * t, 200 + 2 * t]) + rng.normal(0, 30, (n, 2)) * (rng.random((n, 1)) < 0.3)
        boxes = np.concatenate([c - 6, c + 6], 1).astype(np.float32)
        scores = rng.uniform(0.3, 0.9, n).astype(np.float32)
        assert a.ingest(boxes, scores) == b.ingest(boxes, scores)


def test_margin_adds_only_detections_under_the_floor():
    """With a score margin the reference gives the same detections and the
    same suppression work above its floor, and more just under it."""
    f = frames()
    kw = dict(imgsz=320, conf=0.4, iou=0.45, containment=0.5, pre_topk=256, max_det=64)
    path = checkpoint.shipped_weights_path(PLAYER)
    plain, wide = Detector(path, "cpu", **kw)(f), Detector(path, "cpu", margin=0.3, **kw)(f)
    assert sum(len(w["scores"]) for w in wide) > sum(len(p["scores"]) for p in plain)
    for p, w in zip(plain, wide):
        over = w["scores"] > 0.4
        np.testing.assert_array_equal(w["boxes"][over], p["boxes"])
        np.testing.assert_array_equal(w["scores"][over], p["scores"])
        assert w["tail"] == p["tail"]


def test_unmatched_counts_outside_the_margin():
    """A reference detection missing from the other side counts from the
    floor plus the margin up; one of the other side's matched to a
    reference detection under the floor counts as matched."""
    box = np.array([[0.0, 0.0, 10.0, 10.0], [20.0, 0.0, 30.0, 10.0]])
    ref = [{"boxes": box, "scores": np.array([0.42, 0.38]), "classes": np.zeros(2)}]
    side = [{"boxes": box[1:], "scores": np.array([0.41]), "classes": np.zeros(1)}]
    assert match(side, ref, floor=0.4)["unmatched"].size == 0
    assert match(side, ref)["unmatched"].size == 1
    ref[0]["scores"] = np.array([0.46, 0.38])
    assert match(side, ref, floor=0.4)["unmatched"].tolist() == [0.46]
