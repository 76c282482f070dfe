"""Detection and keypoint evaluation: mAP50, mAP50-95, precision, recall
and PCK. Port of hockey_tpu/train/eval.py (`IOU_THRESHOLDS`,
`_iou_matrix`, `EvalAccumulator`, `_ap_101`, `PoseEvalAccumulator`,
`evaluate_detector`, `InTrainingEvaluator`, `InTrainingPoseEvaluator`).

The metrics are the reference's validation metrics (ultralytics
`yolo mode=val`): greedy per-image matching at IoU 0.50:0.95:0.05,
101-point interpolated AP per class, P and R at IoU 0.50. They run on the
host in numpy, step for step as the JAX package's, so the same
predictions give the same metric dicts. The detector's forward, NMS (the
CUDA kernel on a CUDA device) and box un-mapping run on the device, one
call per batch of 8 images, and each batch's padded detections cross to
the host once.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

IOU_THRESHOLDS = np.arange(0.50, 0.96, 0.05)


def _iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return (inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-9)).astype(np.float32)


@dataclasses.dataclass
class EvalAccumulator:
    """Streaming accumulator: feed per-image predictions and ground truth."""

    num_classes: int

    def __post_init__(self):
        # per prediction: (score, class, tp-flags per IoU threshold)
        self._scores: List[np.ndarray] = []
        self._classes: List[np.ndarray] = []
        self._tps: List[np.ndarray] = []
        self._gt_per_class = np.zeros(self.num_classes, np.int64)

    def add_image(
        self,
        pred_boxes: np.ndarray, pred_scores: np.ndarray, pred_classes: np.ndarray,
        gt_boxes: np.ndarray, gt_classes: np.ndarray,
    ) -> None:
        pred_boxes = np.asarray(pred_boxes, np.float32).reshape(-1, 4)
        gt_boxes = np.asarray(gt_boxes, np.float32).reshape(-1, 4)
        pred_scores = np.asarray(pred_scores, np.float32).reshape(-1)
        pred_classes = np.asarray(pred_classes, np.int64).reshape(-1)
        gt_classes = np.asarray(gt_classes, np.int64).reshape(-1)
        for c in gt_classes:
            if 0 <= c < self.num_classes:
                self._gt_per_class[c] += 1

        n, t = len(pred_boxes), len(IOU_THRESHOLDS)
        tp = np.zeros((n, t), bool)
        if n and len(gt_boxes):
            order = np.argsort(-pred_scores)
            iou = _iou_matrix(pred_boxes, gt_boxes)
            same = pred_classes[:, None] == gt_classes[None, :]
            iou = np.where(same, iou, 0.0)
            for ti, thr in enumerate(IOU_THRESHOLDS):
                taken = np.zeros(len(gt_boxes), bool)
                for i in order:
                    j = int(np.argmax(np.where(taken, -1.0, iou[i])))
                    if iou[i, j] >= thr and not taken[j]:
                        taken[j] = True
                        tp[i, ti] = True
        self._scores.append(pred_scores)
        self._classes.append(pred_classes)
        self._tps.append(tp)

    def compute(self) -> Dict[str, float]:
        if not self._scores:
            return {"mAP50": 0.0, "mAP50_95": 0.0, "precision": 0.0, "recall": 0.0}
        scores = np.concatenate(self._scores)
        classes = np.concatenate(self._classes)
        tps = np.concatenate(self._tps, axis=0)
        order = np.argsort(-scores)
        classes, tps = classes[order], tps[order]

        ap = np.zeros((self.num_classes, len(IOU_THRESHOLDS)))
        p50 = np.zeros(self.num_classes)
        r50 = np.zeros(self.num_classes)
        for c in range(self.num_classes):
            m = classes == c
            n_gt = self._gt_per_class[c]
            if n_gt == 0:
                ap[c] = np.nan
                p50[c] = r50[c] = np.nan
                continue
            if not m.any():
                continue
            tp_c = tps[m]
            cum_tp = np.cumsum(tp_c, axis=0)
            cum_fp = np.cumsum(~tp_c, axis=0)
            recall = cum_tp / n_gt
            precision = cum_tp / np.maximum(cum_tp + cum_fp, 1e-9)
            for ti in range(len(IOU_THRESHOLDS)):
                ap[c, ti] = _ap_101(recall[:, ti], precision[:, ti])
            # P/R at the score that maximizes F1 (ultralytics convention)
            f1 = 2 * precision[:, 0] * recall[:, 0] / np.maximum(
                precision[:, 0] + recall[:, 0], 1e-9)
            best = int(np.argmax(f1))
            p50[c] = precision[best, 0]
            r50[c] = recall[best, 0]

        out = {
            "mAP50": float(np.nanmean(ap[:, 0])),
            "mAP50_95": float(np.nanmean(ap)),
            "precision": float(np.nanmean(p50)),
            "recall": float(np.nanmean(r50)),
        }
        for c in range(self.num_classes):
            out[f"AP50_class{c}"] = float(ap[c, 0])
            out[f"AP50_95_class{c}"] = float(np.mean(ap[c]))
        return out


def _ap_101(recall: np.ndarray, precision: np.ndarray) -> float:
    """COCO 101-point interpolated average precision: precision at recall
    point r = monotone-envelope precision of the first sample with
    recall >= r (pycocotools semantics; searchsorted avoids the
    duplicate-x ambiguity of interp at recall exactly 1.0)."""
    mpre = np.maximum.accumulate(precision[::-1])[::-1]
    x = np.linspace(0, 1, 101)
    idx = np.searchsorted(recall, x, side="left")
    valid = idx < len(recall)
    vals = np.where(valid, mpre[np.minimum(idx, len(recall) - 1)], 0.0)
    return float(np.mean(vals))


@dataclasses.dataclass
class PoseEvalAccumulator:
    """Keypoint metrics of the rink pose model: mean pixel error over
    visible keypoints and PCK@t (the fraction within t * image diagonal)."""

    pck_threshold: float = 0.05

    def __post_init__(self):
        self._errs: List[np.ndarray] = []
        self._diags: List[float] = []

    def add_image(self, pred_kpts: np.ndarray, gt_kpts: np.ndarray,
                  image_hw: Tuple[int, int]) -> None:
        """pred/gt: (K, 3) with (x, y, conf/visible)."""
        pred_kpts = np.asarray(pred_kpts, np.float32)
        gt_kpts = np.asarray(gt_kpts, np.float32)
        vis = gt_kpts[:, 2] > 0.5
        if not vis.any():
            return
        err = np.linalg.norm(pred_kpts[vis, :2] - gt_kpts[vis, :2], axis=1)
        self._errs.append(err)
        self._diags.append(float(np.hypot(*image_hw)))

    def compute(self) -> Dict[str, float]:
        if not self._errs:
            return {"mean_kpt_error_px": float("nan"), "pck": 0.0}
        errs = np.concatenate(self._errs)
        norm = np.concatenate([
            np.full(len(e), d) for e, d in zip(self._errs, self._diags)])
        return {
            "mean_kpt_error_px": float(errs.mean()),
            "pck": float((errs <= self.pck_threshold * norm).mean()),
        }


def _load(dataset, i):
    return dataset.load(int(i)) if hasattr(dataset, "load") else dataset[i]


def padded_batches(dataset, indices: Sequence[int], batch: int):
    """(items, uint8 images (batch, S, S, 3)) per chunk of `batch` indices;
    a short tail is padded by repeating its last image, so every device
    call has the same shape and each image keeps the reference's position
    in its batch (hockey_tpu eval.py:207-214)."""
    idx = list(indices)
    for k in range(0, len(idx), batch):
        items = [_load(dataset, i) for i in idx[k: k + batch]]
        imgs = np.stack([(it["images"] * 255).astype(np.uint8) for it in items])
        if len(items) < batch:
            imgs = np.concatenate(
                [imgs, np.repeat(imgs[-1:], batch - len(items), 0)])
        yield items, imgs


def evaluate_detector(
    detector,
    dataset,
    indices: Sequence[int],
    conf: float = 0.001,
    batch: int = 8,
) -> Dict[str, float]:
    """Run a `Detector` (models/detector.py) over dataset items and compute
    the metrics. `dataset` yields dicts with 'images' (S, S, 3) f32 [0, 1]
    and padded ground truth; a detection counts if it is valid and scores
    at least `conf`. Batches of `batch` images, the tail padded, each
    brought to the host in one copy (`fetch_batch`)."""
    acc = EvalAccumulator(detector.cfg.num_classes)
    if not hasattr(detector, "fetch_batch"):  # stub detectors (tests)
        for i in indices:
            item = _load(dataset, i)
            img = (item["images"] * 255).astype(np.uint8)
            det = detector.detect(img)
            keep = det.scores >= conf
            gt_m = item["mask"]
            acc.add_image(det.boxes[keep], det.scores[keep],
                          det.classes[keep],
                          item["boxes"][gt_m], item["classes"][gt_m])
        return acc.compute()
    for items, imgs in padded_batches(dataset, indices, batch):
        h = detector.fetch_batch(imgs)
        for j, it in enumerate(items):
            keep = h.valid[j] & (h.scores[j] >= conf)
            gt_m = it["mask"]
            acc.add_image(h.boxes[j][keep], h.scores[j][keep], h.classes[j][keep],
                          it["boxes"][gt_m], it["classes"][gt_m])
    return acc.compute()


def inference_copy(model: torch.nn.Module, device: torch.device,
                   dtype: torch.dtype) -> torch.nn.Module:
    """A copy of a YOLOv8 `model` in training form (BN unfolded) with BN
    folded and its weights cast to `dtype` on `device`, channels_last
    (hockey_tpu eval.py:250 `fuse_for_inference(params)`); `model` itself
    is left as it was."""
    from ..models.layers import fuse_for_inference

    with torch.no_grad():
        fused = fuse_for_inference(copy.deepcopy(model).to(device).eval(), dtype)
    return fused.to(memory_format=torch.channels_last)


class _InTrainingBase:
    """One `DetectCore` (models/detector.py), built once and reused by
    every evaluation, on the square letterbox: the counterpart of the JAX
    package's one compiled detect program per evaluator. 8 images per
    device call."""

    BATCH = 8

    def __init__(self, cfg, imgsz: int, conf: float, device, dtype, **core_kw):
        from ..core.device import compute_dtype, resolve_device
        from ..models.detector import DetectCore

        self.cfg, self.imgsz, self.conf = cfg, imgsz, conf
        self.device = resolve_device(device)
        self.dtype = compute_dtype(self.device, dtype)
        self.core = DetectCore(cfg, imgsz=imgsz, frame_hw=(imgsz, imgsz),
                               conf=conf, rect=False, dtype=self.dtype,
                               **core_kw)

    def _outputs(self, model, dataset, indices):
        """(items, the core's output on the host, a HostBatch) per padded
        batch, `model` folded once into a copy on the device."""
        fused = inference_copy(model, self.device, self.dtype)
        for items, imgs in padded_batches(dataset, indices, self.BATCH):
            with torch.inference_mode():
                out = self.core(fused, torch.from_numpy(imgs).to(self.device))
            yield items, self.core.to_host(out)


class InTrainingEvaluator(_InTrainingBase):
    """Periodic mAP evaluation during training (hockey_tpu eval.py:230):
    `max_det` 96 of `pre_topk` 384 candidates per image, every valid
    detection counted."""

    def __init__(self, cfg, imgsz: int, conf: float = 0.001, device="cuda",
                 dtype=None):
        super().__init__(cfg, imgsz, conf, device, dtype, max_det=96,
                         pre_topk=384)

    def evaluate(self, model, dataset, indices: Sequence[int]) -> Dict[str, float]:
        """Metrics of YOLOv8 `model` (training form, BN unfolded; left
        unchanged) on `dataset`'s `indices`."""
        acc = EvalAccumulator(self.cfg.num_classes)
        for items, h in self._outputs(model, dataset, indices):
            for j, it in enumerate(items):
                v = h.valid[j]
                gt_m = it["mask"]
                acc.add_image(h.boxes[j][v], h.scores[j][v], h.classes[j][v],
                              it["boxes"][gt_m], it["classes"][gt_m])
        return acc.compute()


class InTrainingPoseEvaluator(_InTrainingBase):
    """Periodic keypoint evaluation during pose (rink) training
    (hockey_tpu eval.py:274): `max_det` 8 of `pre_topk` 64 candidates,
    the best anchor's keypoints against each image's first instance."""

    def __init__(self, cfg, imgsz: int, conf: float = 0.001, device="cuda",
                 dtype=None):
        super().__init__(cfg, imgsz, conf, device, dtype, max_det=8,
                         pre_topk=64, with_keypoints=True)

    def evaluate(self, model, dataset, indices: Sequence[int]) -> Dict[str, float]:
        """PCK and mean keypoint error of YOLOv8-pose `model` (training
        form; left unchanged) on `dataset`'s `indices`."""
        acc = PoseEvalAccumulator()
        for items, h in self._outputs(model, dataset, indices):
            for j, it in enumerate(items):
                acc.add_image(h.block[j], it["keypoints"][0],
                              (self.imgsz, self.imgsz))
        return acc.compute()
