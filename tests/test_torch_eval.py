"""Held-out validation in the port (hockey_tpu_torch/train/) against the
JAX package (hockey_tpu/train/) on the CPU:

- both accumulators fed the same numpy-seeded predictions and ground
  truth (empty images, wrong classes, duplicates, invisible keypoints,
  `_ap_101`'s envelope): the metric dicts are equal, exactly;
- `evaluate_detector` with a tiny random checkpoint (YOLOv8n, carried
  across by `params_from_jax` through the checkpoint file) on 10 images
  of a pool (one padded tail), and both in-training evaluators on the
  same parameters, against the JAX ones with their programs at f32 on the
  BN-folded f32 weights: kept sets and classes equal and boxes within
  1e-3 px (tests/test_torch_detector.py's tolerance), so the metric dicts
  agree within METRIC_TOL (a score within 1e-4 may reorder two near-tied
  detections); the caller's model is left unchanged;
- the YOLO-directory reader, the pool reader and every corruption at
  severities 1, 3 and 5: equal to JAX, bit for bit.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hockey_tpu.models import yolov8 as J  # noqa: E402
from hockey_tpu.models.checkpoint import save_params as jax_save_params  # noqa: E402
from hockey_tpu.models.detector import build_detect_fn as jax_build_detect_fn  # noqa: E402
from hockey_tpu.models.layers import fuse_model as jax_fuse_model  # noqa: E402
from hockey_tpu.train import corruptions as jcor  # noqa: E402
from hockey_tpu.train import data as jdata  # noqa: E402
from hockey_tpu.train import eval as jeval  # noqa: E402
from hockey_tpu.train.scenes import HardSyntheticHockeyDataset  # noqa: E402
from hockey_tpu_torch.models import yolov8 as P  # noqa: E402
from hockey_tpu_torch.models.detector import Detector  # noqa: E402
from hockey_tpu_torch.ops.nms_kernel import suppress  # noqa: E402
from hockey_tpu_torch.train import corruptions as tcor  # noqa: E402
from hockey_tpu_torch.train import data as tdata  # noqa: E402
from hockey_tpu_torch.train import eval as teval  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "scripts"))
import render_val_set  # noqa: E402

# metric dicts of the f32 detector runs: equal up to this (see above)
METRIC_TOL = 1e-4
S = 160  # pool image size: 525 anchors, so K = 384 at the in-training site


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def assert_metrics_equal(got, want, tol=0.0):
    assert got.keys() == want.keys()
    for k in want:
        if np.isnan(want[k]):
            assert np.isnan(got[k]), k
        else:
            assert abs(got[k] - want[k]) <= tol, (k, got[k], want[k])


# ---------------------------------------------------------------------------
# the accumulators

def _random_image(rng, n_pred, n_gt, nc):
    gt = rng.uniform(0, 200, (n_gt, 2))
    gt = np.concatenate([gt, gt + rng.uniform(10, 60, (n_gt, 2))], 1)
    gtc = rng.integers(0, nc, n_gt)
    # predictions: jittered copies of gt (some of wrong class), duplicates
    # and strays
    src = gt[rng.integers(0, max(n_gt, 1), n_pred)] if n_gt else \
        rng.uniform(0, 200, (n_pred, 4))
    pred = src + rng.normal(0, 4, src.shape)
    pred[:, 2:] = np.maximum(pred[:, 2:], pred[:, :2] + 1)
    if n_pred > 2:
        pred[-1] = pred[0]                   # an exact duplicate
        pred[-2] = [500, 500, 520, 530]      # a stray
    cls = rng.integers(0, nc, n_pred)
    scores = np.round(rng.uniform(0, 1, n_pred), 2)  # ties included
    return pred, scores, cls, gt, gtc


@pytest.mark.parametrize("nc", [1, 2, 3])
def test_eval_accumulator_matches_jax(nc):
    rng = np.random.default_rng(nc)
    ours, theirs = teval.EvalAccumulator(nc), jeval.EvalAccumulator(nc)
    sizes = [(0, 0), (0, 3), (5, 0), (1, 1), (12, 6), (30, 10), (3, 8)]
    for n_pred, n_gt in sizes * 2:
        args = _random_image(rng, n_pred, n_gt, nc)
        ours.add_image(*args)
        theirs.add_image(*args)
    got, want = ours.compute(), theirs.compute()
    assert_metrics_equal(got, want)
    assert 0 < got["mAP50"] < 1


def test_eval_accumulator_edge_cases_match_jax():
    gt = np.asarray([[0, 0, 10, 10.0], [20, 20, 40, 40]])
    cases = [
        [],                                                    # no images
        [(np.zeros((0, 4)), np.zeros(0), np.zeros(0), gt, [0, 1])],
        [(gt, [0.9, 0.8], [1, 0], gt, [0, 1])],                # wrong classes
        [(np.repeat(gt[:1], 3, 0), [0.9, 0.8, 0.7], [0, 0, 0], gt[:1], [0])],
        [(gt, [0.5, 0.5], [0, 0], np.zeros((0, 4)), [])],      # no ground truth
    ]
    for images in cases:
        for nc in (1, 2):
            ours, theirs = teval.EvalAccumulator(nc), jeval.EvalAccumulator(nc)
            for im in images:
                ours.add_image(*im)
                theirs.add_image(*im)
            assert_metrics_equal(ours.compute(), theirs.compute())


def test_ap_101_and_iou_match_jax():
    rng = np.random.default_rng(5)
    for n in (1, 2, 7, 50):
        recall = np.sort(rng.uniform(0, 1, n))
        recall[-1] = 1.0 if n > 3 else recall[-1]
        recall[n // 2:n // 2 + 2] = recall[n // 2]             # repeated recall
        precision = rng.uniform(0, 1, n)                       # not monotone
        assert teval._ap_101(recall, precision) == jeval._ap_101(recall, precision)
    np.testing.assert_array_equal(teval.IOU_THRESHOLDS, jeval.IOU_THRESHOLDS)
    a, b = _random_image(rng, 9, 7, 2)[0], _random_image(rng, 9, 7, 2)[3]
    np.testing.assert_array_equal(teval._iou_matrix(a, b), jeval._iou_matrix(a, b))
    assert teval._iou_matrix(a[:0], b).shape == (0, 7)


def test_pose_accumulator_matches_jax():
    rng = np.random.default_rng(2)
    for thr in (0.05, 0.02):
        ours, theirs = teval.PoseEvalAccumulator(thr), jeval.PoseEvalAccumulator(thr)
        assert_metrics_equal(ours.compute(), theirs.compute())  # nothing yet
        for i in range(6):
            gt = np.concatenate([rng.uniform(0, 300, (56, 2)),
                                 rng.integers(0, 2, (56, 1))], 1)
            if i == 2:
                gt[:, 2] = 0                                   # all invisible
            pred = gt + np.concatenate([rng.normal(0, 15, (56, 2)),
                                        rng.uniform(0, 1, (56, 1))], 1)
            hw = (300, 400) if i % 2 else (512, 512)
            ours.add_image(pred, gt, hw)
            theirs.add_image(pred, gt, hw)
        assert_metrics_equal(ours.compute(), theirs.compute())


def test_stub_detector_branch_matches_jax():
    """`evaluate_detector` with a detector that has no `detect_batch`
    (the JAX tests' oracles): per-image `detect`, the conf filter."""
    rng = np.random.default_rng(8)
    items = []
    for _ in range(4):
        b, c, m = jdata.pad_targets(*[_random_image(rng, 0, 5, 2)[k] for k in (3, 4)])
        items.append({"images": rng.uniform(0, 1, (32, 32, 3)).astype(np.float32),
                      "boxes": b, "classes": c, "mask": m})

    class Oracle:
        class cfg:
            num_classes = 2

        def __init__(self, host_cls):
            self.host_cls, self.i = host_cls, 0

        def detect(self, img):
            it = items[self.i]
            self.i += 1
            m = it["mask"]
            return self.host_cls(it["boxes"][m] + 1.0,
                                 np.linspace(0.0005, 0.9, m.sum()).astype(np.float32),
                                 it["classes"][m])

    from hockey_tpu.models.detector import HostDetections as JH
    from hockey_tpu_torch.models.detector import HostDetections as TH

    got = teval.evaluate_detector(Oracle(TH), items, range(4))
    want = jeval.evaluate_detector(Oracle(JH), items, range(4))
    assert_metrics_equal(got, want)


# ---------------------------------------------------------------------------
# the detector through evaluate_detector and the in-training evaluators

class Items:
    """A dataset over a list of items."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


def _f32_detect_fn(**kw):
    return jax_build_detect_fn(**kw, dtype=jnp.float32)


def _padded(items):
    imgs = np.stack([(it["images"] * 255).astype(np.uint8) for it in items])
    return np.concatenate([imgs, np.repeat(imgs[-1:], -len(imgs) % 8, 0)])


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """Random-init YOLOv8n detect (2 classes) and pose (56 keypoints)
    checkpoints, and 10 generator-A images at S px relabelled so the
    metrics are not 0: each image's ground truth is the JAX f32
    detector's first 6 detections moved by about 2 px, one of them with
    the other class, as JAX items and as a pool."""
    d = tmp_path_factory.mktemp("tiny")
    pc = J.YoloConfig("n", num_classes=2)
    rc = J.YoloConfig("n", num_classes=1, num_keypoints=56)
    pp, rp = J.init_params(pc, 0), J.init_params(rc, 1)
    jax_save_params(str(d / "p.msgpack"), pp)
    ds = HardSyntheticHockeyDataset(imgsz=S, seed=3, pool_size=10)
    ds.pregenerate(workers=2)
    items = [ds.load(i) for i in range(10)]
    fn = _f32_detect_fn(cfg=pc, imgsz=S, frame_hw=(S, S), conf=0.001)
    det = fn(jax.tree_util.tree_map(jnp.asarray, jax_fuse_model(pp)),
             jnp.asarray(_padded(items)))
    rng = np.random.default_rng(7)
    for j, it in enumerate(items):
        boxes = np.asarray(det.boxes[j])[np.asarray(det.valid[j])][:6]
        classes = np.asarray(det.classes[j])[np.asarray(det.valid[j])][:6]
        classes[0] = 1 - classes[0]
        boxes = boxes + rng.normal(0, 2.0, boxes.shape).astype(np.float32)
        it["boxes"], it["classes"], it["mask"] = jdata.pad_targets(boxes, classes)
    pool = str(d / "pool.npz")
    render_val_set.write(pool, render_val_set.pool_arrays(Items(items), 10),
                         "t", 3, "a")
    return pc, rc, pp, rp, str(d / "p.msgpack"), Items(items), pool


def test_evaluate_detector_matches_jax(tiny, monkeypatch):
    from hockey_tpu.models import detector as jdet

    pc, _, pp, _, p_path, jds, pool = tiny
    monkeypatch.setitem(P.MODEL_ZOO, "tiny-player", P.YoloConfig("n", num_classes=2))
    monkeypatch.setitem(J.MODEL_ZOO, "tiny-player", pc)
    monkeypatch.setattr(jdet, "fuse_for_inference", jax_fuse_model)
    monkeypatch.setattr(jdet, "build_detect_fn",
                        lambda cfg, **kw: _f32_detect_fn(cfg=cfg, **kw))
    from hockey_tpu.core.config import Config as JaxConfig
    from hockey_tpu_torch.core.config import Config

    jd = jdet.Detector("tiny-player", JaxConfig(), frame_hw=(S, S), imgsz=S,
                       conf=0.001, checkpoint=p_path)
    want = jeval.evaluate_detector(jd, jds, range(10))
    d = Detector("tiny-player", Config(), frame_hw=(S, S), imgsz=S, conf=0.001,
                 checkpoint=p_path, device="cpu")
    assert d.dtype == torch.float32
    suppress.launches = 0
    got = teval.evaluate_detector(d, tdata.PoolDataset(pool), range(10))
    assert suppress.launches == 0  # CPU tensors take the plain suppression
    assert_metrics_equal(got, want, METRIC_TOL)
    assert 0.2 < want["mAP50_95"] < want["mAP50"] < 1.0


def test_in_training_evaluator_matches_jax(tiny, monkeypatch):
    import hockey_tpu.models.layers as jlayers

    pc, _, pp, _, _, jds, pool = tiny
    ev = jeval.InTrainingEvaluator(pc, S)
    ev._fn = _f32_detect_fn(cfg=pc, imgsz=S, frame_hw=(S, S), conf=0.001,
                            rect=False, max_det=96, pre_topk=384)
    monkeypatch.setattr(jlayers, "fuse_for_inference", jax_fuse_model)
    want = ev.evaluate(jax.tree_util.tree_map(jnp.asarray, pp), jds, range(10))

    cfg = P.YoloConfig("n", num_classes=2)
    model = P.build_model(cfg, pp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ours = teval.InTrainingEvaluator(cfg, S, device="cpu")
    assert (ours.core.pre_topk, ours.core.max_det, ours.core.rect) == (384, 96, False)
    got = ours.evaluate(model, tdata.PoolDataset(pool), range(10))
    assert_metrics_equal(got, want, METRIC_TOL)
    assert 0.2 < want["mAP50_95"] < want["mAP50"] < 1.0
    # the caller's model: BN unfolded, every tensor as it was
    after = model.state_dict()
    assert after.keys() == before.keys() and any(".bn." in k for k in after)
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(v.dtype == torch.float32 for v in after.values())


def test_in_training_pose_evaluator_matches_jax(tiny, monkeypatch):
    """On 10 rink views whose visible keypoints are the JAX f32 pose
    model's own, moved by about 4 px: PCK equal, the mean error within
    1e-3 px."""
    import hockey_tpu.models.layers as jlayers
    from hockey_tpu.train.data import SyntheticRinkDataset

    _, rc, _, rp, _, _, _ = tiny
    rink = SyntheticRinkDataset(imgsz=S, seed=5)
    items = [rink.load(i) for i in range(10)]
    fn = _f32_detect_fn(cfg=rc, imgsz=S, frame_hw=(S, S), conf=0.001,
                        rect=False, max_det=8, pre_topk=64, with_keypoints=True)
    params = jax.tree_util.tree_map(jnp.asarray, rp)
    _, kpts = fn(jax_fuse_model(params), jnp.asarray(_padded(items)))
    rng = np.random.default_rng(3)
    for j, it in enumerate(items):
        it["keypoints"][0, :, :2] = (np.asarray(kpts[j])[:, :2]
                                     + rng.normal(0, 4.0, (56, 2)))
    ev = jeval.InTrainingPoseEvaluator(rc, S)
    ev._fn = fn
    monkeypatch.setattr(jlayers, "fuse_for_inference", jax_fuse_model)
    want = ev.evaluate(params, Items(items), range(10))

    cfg = P.YoloConfig("n", num_classes=1, num_keypoints=56)
    model = P.build_model(cfg, rp)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    ours = teval.InTrainingPoseEvaluator(cfg, S, device="cpu")
    assert (ours.core.pre_topk, ours.core.max_det) == (64, 8)
    got = ours.evaluate(model, Items(items), range(10))
    assert got.keys() == want.keys()
    assert got["pck"] == want["pck"] and 0.2 < want["pck"] < 1.0
    assert abs(got["mean_kpt_error_px"] - want["mean_kpt_error_px"]) <= 1e-3
    assert all(torch.equal(before[k], v) for k, v in model.state_dict().items())


def test_evaluators_need_cuda_unless_asked_for_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = P.YoloConfig("n", num_classes=2)
    for cls in (teval.InTrainingEvaluator, teval.InTrainingPoseEvaluator):
        with pytest.raises(RuntimeError, match="CUDA"):
            cls(cfg, 64)


# ---------------------------------------------------------------------------
# the readers

def test_yolo_labels_and_pad_targets_match_jax(tmp_path):
    p = tmp_path / "a.txt"
    p.write_text("0 0.5 0.5 0.2 0.4\n1 0.1 0.2 0.05 0.05\nbad line\n\n"
                 "1 0.9 0.9 0.1 0.1 0.77\n")
    for path in (str(p), str(tmp_path / "missing.txt")):
        for got, want in zip(tdata.load_yolo_labels(path, 640, 360),
                             jdata.load_yolo_labels(path, 640, 360)):
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
    boxes, classes = jdata.load_yolo_labels(str(p), 640, 360)
    for max_gt in (1, 3, 64):
        for got, want in zip(tdata.pad_targets(boxes, classes, max_gt),
                             jdata.pad_targets(boxes, classes, max_gt)):
            np.testing.assert_array_equal(got, want)
    assert tdata.MAX_GT == jdata.MAX_GT


def test_yolo_dataset_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    img_dir, lbl_dir = tmp_path / "images", tmp_path / "labels"
    img_dir.mkdir()
    lbl_dir.mkdir()
    for i, (h, w) in enumerate([(90, 160), (200, 120), (64, 64)]):
        cv2.imwrite(str(img_dir / f"f{i}.png"),
                    rng.integers(0, 255, (h, w, 3), dtype=np.uint8))
        if i != 2:  # the last image has no label file
            rows = [f"{i % 2} {x:.4f} {y:.4f} 0.1 0.2"
                    for x, y in rng.uniform(0.2, 0.8, (3, 2))]
            (lbl_dir / f"f{i}.txt").write_text("\n".join(rows))
    ours = tdata.YoloDataset(str(img_dir), imgsz=96)
    theirs = jdata.YoloDataset(str(img_dir), imgsz=96)
    assert ours.files == theirs.files and len(ours) == 3
    for i in range(3):
        got, want = ours.load(i), theirs.load(i)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(FileNotFoundError):
        tdata.YoloDataset(str(lbl_dir))


def test_pool_dataset_matches_jax_cache(tmp_path):
    """A pool written by the JAX `save_cache` reads as JAX `load_cache` +
    `load` gives it; a pool of scripts/render_val_set.py (compressed, with
    keypoints for a rink set) as the JAX dataset's own `load`."""
    ds = HardSyntheticHockeyDataset(imgsz=96, seed=4, pool_size=3, pucks=True)
    path = str(tmp_path / "cache.npz")
    ds.save_cache(path)
    again = HardSyntheticHockeyDataset(imgsz=96, seed=4, pool_size=3, pucks=True)
    assert again.load_cache(path)
    pool = tdata.PoolDataset(path)
    assert len(pool) == 3 and pool.imgsz == 96 and pool.meta == {}
    for i in range(3):
        got, want = pool.load(i), again.load(i)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])

    rink = jdata.SyntheticRinkDataset(imgsz=64, seed=9)
    path = str(tmp_path / "rink.npz")
    render_val_set.write(path, render_val_set.pool_arrays(rink, 3), "rink", 9, "a")
    pool = tdata.PoolDataset(path)
    assert pool.meta == {"name": "rink", "seed": 9, "generator": "a"}
    for i in range(3):
        got, want = pool.load(i), rink.load(i)
        np.testing.assert_array_equal(got["images"], want["images"])
        np.testing.assert_array_equal(got["keypoints"], want["keypoints"][:1])
        np.testing.assert_array_equal(got["boxes"][:1], want["boxes"][:1])
        assert got["mask"].sum() == 1 and got["boxes"].shape == (64, 4)


# ---------------------------------------------------------------------------
# the corruptions

@pytest.mark.parametrize("name", sorted(jcor.CORRUPTIONS))
def test_corruptions_match_jax_bit_for_bit(name):
    assert tcor.CORRUPTIONS.keys() == jcor.CORRUPTIONS.keys()
    rng = np.random.default_rng(0)
    img = rng.integers(0, 255, (97, 131, 3), dtype=np.uint8)
    img[20:60, 30:90] = (40, 200, 120)  # flat and edged regions
    for sev in (1, 3, 5):
        got = tcor.CORRUPTIONS[name](img.copy(), sev)
        want = jcor.CORRUPTIONS[name](img.copy(), sev)
        assert got.dtype == np.uint8 and got.shape == img.shape
        np.testing.assert_array_equal(got, want)
    base = [{"images": img.astype(np.float32) / 255.0, "mask": np.zeros(2, bool)}]

    class Base:
        def __len__(self):
            return 1

        def load(self, i):
            return base[i]

    got = tcor.CorruptedDataset(Base(), name, 3).load(0)
    want = jcor.CorruptedDataset(Base(), name, 3).load(0)
    np.testing.assert_array_equal(got["images"], want["images"])
    assert got["mask"] is base[0]["mask"] and len(tcor.CorruptedDataset(Base(), name, 1)) == 1
    assert set(tcor.CV2_CORRUPTIONS) <= set(tcor.CORRUPTIONS)
    for bad in ((name, 0), (name, 6), ("fog", 1)):
        with pytest.raises(ValueError):
            tcor.CorruptedDataset(Base(), *bad)
