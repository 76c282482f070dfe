"""Training ops of the port (hockey_tpu_torch ops/iou.py `ciou`,
train/assigner.py, train/losses.py) against the JAX package on the CPU,
in f32, on numpy-seeded inputs.

Tolerances: `ciou` within 1e-6 (values in [-1, 1]) and its gradients
within 1e-5; the assigner's `fg` and `target_gt_idx` (on fg) equal, its
target boxes equal and scores within 1e-6; each loss component within
1e-5 relative and the gradients with respect to the raw head maps within
1e-4 of the largest magnitude (f32 reductions over A anchors in another
order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.models.yolov8 import YoloConfig as JYoloConfig
from hockey_tpu.models.yolov8 import anchor_points
from hockey_tpu.ops.iou import ciou as jax_ciou
from hockey_tpu.train.assigner import assign_batch as jax_assign
from hockey_tpu.train.losses import detection_loss as jax_loss
from hockey_tpu_torch.models.yolov8 import YoloConfig
from hockey_tpu_torch.ops.iou import ciou
from hockey_tpu_torch.train.assigner import assign_batch
from hockey_tpu_torch.train.losses import detection_loss
from tests.test_torch_session import one_torch_thread  # noqa: F401

IMGSZ = 64
DET = (JYoloConfig("n", num_classes=2), YoloConfig("n", num_classes=2))
POSE = (JYoloConfig("n", num_classes=1, num_keypoints=5),
        YoloConfig("n", num_classes=1, num_keypoints=5))
COMPONENTS = ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg")
POSE_COMPONENTS = COMPONENTS + ("kpt_loss", "kobj_loss")


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def _close(got, want, rel):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    assert float(np.abs(got - want).max()) <= rel * scale


def _boxes(rng, shape, lo=0.0, hi=60.0):
    xy = rng.uniform(lo, hi, shape + (2,))
    wh = rng.uniform(0.5, 30.0, shape + (2,))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def test_ciou_values_and_gradients():
    rng = np.random.default_rng(1)
    a, b = _boxes(rng, (64,)), _boxes(rng, (64,))
    b[:8] = a[:8]                       # identical boxes
    b[8:16, :2] = b[8:16, 2:] + 5.0     # degenerate (negative extent) boxes
    want = np.asarray(jax_ciou(jnp.asarray(a), jnp.asarray(b)))
    ta = torch.from_numpy(a).requires_grad_(True)
    tb = torch.from_numpy(b).requires_grad_(True)
    got = ciou(ta, tb)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=0, atol=1e-6)
    got.sum().backward()
    ga, gb = jax.grad(lambda x, y: jnp.sum(jax_ciou(x, y)), argnums=(0, 1))(
        jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(ga), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tb.grad.numpy(), np.asarray(gb), rtol=0, atol=1e-5)


def _assign_inputs(rng, b=3, m=6, n_gt=(4, 0, 6)):
    pts, strides = anchor_points(IMGSZ)
    pts_px = (pts * strides[:, None]).astype(np.float32)
    a = len(pts_px)
    scores = rng.uniform(0, 1, (b, a, 2)).astype(np.float32)
    # predictions near the anchors, some exactly on a gt box
    pred = np.concatenate([pts_px - rng.uniform(2, 20, (b, a, 2)),
                           pts_px + rng.uniform(2, 20, (b, a, 2))], -1)
    gt = _boxes(rng, (b, m), 0, 40)
    cls = rng.integers(0, 2, (b, m)).astype(np.int32)
    mask = np.zeros((b, m), bool)
    for i, n in enumerate(n_gt):
        mask[i, :n] = True
    pred[0, :4] = gt[0, 0]
    return (scores, pred.astype(np.float32), pts_px, gt, cls, mask)


@pytest.mark.parametrize("case", ["random", "empty_gt_table"])
def test_assigner_matches_jax(case):
    rng = np.random.default_rng(2)
    ins = _assign_inputs(rng) if case == "random" else \
        _assign_inputs(rng, n_gt=(0, 0, 0))
    want = jax_assign(*map(jnp.asarray, ins), num_classes=2)
    got = assign_batch(*map(torch.from_numpy, ins), num_classes=2)
    fg = np.asarray(want.fg_mask)
    np.testing.assert_array_equal(got.fg_mask.numpy(), fg)
    assert fg.sum() > 0 if case == "random" else fg.sum() == 0
    np.testing.assert_array_equal(got.target_gt_idx.numpy()[fg],
                                  np.asarray(want.target_gt_idx)[fg])
    np.testing.assert_array_equal(got.target_boxes.numpy(),
                                  np.asarray(want.target_boxes))
    np.testing.assert_allclose(got.target_scores.numpy(),
                               np.asarray(want.target_scores), rtol=0, atol=1e-6)


def _raw(rng, cfg, b=2, scale=0.5):
    """Random NHWC head maps at IMGSZ (numpy)."""
    sizes = [IMGSZ // s for s in (8, 16, 32)]
    raw = {"box": [scale * rng.standard_normal((b, s, s, 4 * cfg.reg_max))
                   for s in sizes],
           "cls": [scale * rng.standard_normal((b, s, s, cfg.num_classes)) - 1.0
                   for s in sizes]}
    if cfg.num_keypoints:
        raw["kpt"] = [scale * rng.standard_normal((b, s, s, 3 * cfg.num_keypoints))
                      for s in sizes]
    return {k: [v.astype(np.float32) for v in vs] for k, vs in raw.items()}


def _batch(rng, cfg, b=2, m=4, n_gt=2):
    boxes = np.zeros((b, m, 4), np.float32)
    boxes[:, :n_gt] = _boxes(rng, (b, n_gt), 4, 30)
    boxes[:, :n_gt, 2:] = np.minimum(boxes[:, :n_gt, :2] + rng.uniform(
        12, 30, (b, n_gt, 2)), 63)
    mask = np.zeros((b, m), bool)
    mask[:, :n_gt] = True
    out = {"boxes": boxes, "classes": rng.integers(
        0, cfg.num_classes, (b, m)).astype(np.int32), "mask": mask}
    if cfg.num_keypoints:
        k = cfg.num_keypoints
        kp = np.zeros((b, m, k, 3), np.float32)
        kp[..., :2] = rng.uniform(0, IMGSZ, (b, m, k, 2))
        kp[..., 2] = rng.uniform(0, 1, (b, m, k)) < 0.7
        out["keypoints"] = kp
    return out


def _port(raw, batch, cfg):
    traw = {k: [torch.from_numpy(v).requires_grad_(True) for v in vs]
            for k, vs in raw.items()}
    loss, m = detection_loss(traw, {k: torch.from_numpy(v) for k, v in batch.items()},
                             cfg, IMGSZ)
    return traw, loss, m


@pytest.mark.parametrize("kind", ["detect", "pose", "empty_gt_table"])
def test_loss_components_and_gradients_match_jax(kind):
    rng = np.random.default_rng(3)
    jcfg, cfg = POSE if kind == "pose" else DET
    raw = _raw(rng, cfg)
    batch = _batch(rng, cfg, n_gt=0 if kind == "empty_gt_table" else 2)

    def jloss(r):
        return jax_loss(r, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg, IMGSZ)

    (_, want), grads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, raw))
    traw, loss, got = _port(raw, batch, cfg)
    keys = POSE_COMPONENTS if kind == "pose" else COMPONENTS
    assert set(got) == set(want) == set(keys)
    for k in keys:
        np.testing.assert_allclose(float(got[k].detach()), float(want[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    if kind == "empty_gt_table":
        assert float(got["num_fg"]) == 0 and float(got["box_loss"]) == 0
    else:
        assert float(got["num_fg"]) > 0
    loss.backward()
    for key in traw:
        for t, g in zip(traw[key], grads[key]):
            _close(t.grad.numpy(), g, 1e-4)


@pytest.mark.parametrize("loss_keys,grad_of", [
    (("box_loss", "dfl_loss"), "cls"), (("cls_loss",), "box")])
def test_assignment_carries_no_gradient(loss_keys, grad_of):
    """tests/test_train.py TestTALStopGradient on the port: box and dfl
    losses have no gradient in the class logits, and the cls loss none in
    the box logits (the assignment runs on detached predictions)."""
    rng = np.random.default_rng(0)
    raw = _raw(rng, DET[1], scale=0.1)
    traw, _, m = _port(raw, _batch(rng, DET[1]), DET[1])
    assert float(m["num_fg"]) > 0
    sum(m[k] for k in loss_keys).backward()
    for t in traw[grad_of]:
        assert t.grad is None or not t.grad.any()
