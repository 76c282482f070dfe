"""Batched fixed-shape NMS: port of hockey_tpu/ops/nms.py.

The JAX package vmaps a single-image `nms`; here the batch dimension is
written out. Per frame:

1. the top `pre_topk` candidates by score, by a stable descending sort so
   that ties keep the lower anchor index first, as `jax.lax.top_k` does
   (`torch.topk` promises no order among ties);
2. one (K, K) suppression matrix: IoU with the 1e4 class offset, or, with
   containment on, `max(iou - iou_thr, iomin - containment_thr)`
   thresholded at 0 (hockey_tpu nms.py:106-121);
3. greedy suppression through the CUDA kernel wrapper (`nms_kernel.py`),
   or YOLACT-style fast suppression;
4. exactly `max_det` output slots with a validity mask.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .iou import box_iou
from .nms_kernel import suppress

_CLASS_OFFSET = 1e4  # larger than any letterboxed coordinate


class Detections(NamedTuple):
    """Fixed-capacity detections of a frame batch. Invalid slots have
    score -1, class -1 and zero boxes."""

    boxes: torch.Tensor    # (B, max_det, 4) xyxy
    scores: torch.Tensor   # (B, max_det)
    classes: torch.Tensor  # (B, max_det) int32
    valid: torch.Tensor    # (B, max_det) bool


def top_k_stable(x: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Largest k along the last dim, ties broken toward the lower index
    (jax.lax.top_k's order)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def suppress_fast(m: torch.Tensor, keep0: torch.Tensor, thr: float) -> torch.Tensor:
    """One-shot matrix suppression (YOLACT fast-NMS): drop any candidate
    that overlaps a higher-ranked valid one, whether or not that survives."""
    k = m.shape[-1]
    higher = torch.tril(torch.ones(k, k, dtype=torch.bool, device=m.device), -1)
    suppressed = torch.any((m > thr) & higher & keep0[:, None, :], dim=-1)
    return keep0 & ~suppressed


def suppression_matrix(boxes: torch.Tensor, iou_threshold: float,
                       containment_threshold: float) -> Tuple[torch.Tensor, float]:
    """(B, K, 4) class-offset boxes -> ((B, K, K) f32 matrix, threshold)."""
    iou = box_iou(boxes, boxes)
    if containment_threshold <= 0.0:
        return iou, iou_threshold
    # suppress iff iou > iou_thr OR iomin > containment_thr, folded into one
    # matrix thresholded at 0; class-offset boxes never intersect across
    # classes, so the containment term is class-aware too
    tl = torch.maximum(boxes[:, :, None, :2], boxes[:, None, :, :2])
    br = torch.minimum(boxes[:, :, None, 2:], boxes[:, None, :, 2:])
    wh = torch.clamp(br - tl, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    side = torch.clamp(boxes[..., 2:] - boxes[..., :2], min=0.0)
    area = side[..., 0] * side[..., 1]
    iomin = inter / torch.clamp(
        torch.minimum(area[:, :, None], area[:, None, :]), min=1e-9)
    return torch.maximum(iou - iou_threshold,
                         iomin - containment_threshold), 0.0


class Candidates(NamedTuple):
    """The top-K candidates of each frame and what suppression needs."""

    boxes: torch.Tensor    # (B, K, 4) letterboxed xyxy, score-sorted
    scores: torch.Tensor   # (B, K)
    classes: torch.Tensor  # (B, K) int32
    matrix: torch.Tensor   # (B, K, K) f32 suppression matrix, contiguous
    thr: float             # suppress j by i iff matrix[i, j] > thr
    keep0: torch.Tensor    # (B, K) bool, score > score_threshold


def nms_candidates(boxes: torch.Tensor, scores: torch.Tensor,
                   classes: torch.Tensor, *, score_threshold: float = 0.25,
                   iou_threshold: float = 0.45,
                   containment_threshold: float = 0.0, pre_topk: int = 256,
                   class_aware: bool = True) -> Candidates:
    """Steps 1-2 of `nms`: top-K selection and the suppression matrix."""
    k = min(pre_topk, scores.shape[-1])
    top_scores, idx = top_k_stable(scores.float(), k)
    top_boxes = torch.gather(boxes.float(), 1, idx[..., None].expand(-1, -1, 4))
    top_classes = torch.gather(classes, 1, idx).int()

    nms_boxes = top_boxes
    if class_aware:
        nms_boxes = top_boxes + (top_classes.float() * _CLASS_OFFSET)[..., None]
    sup_mat, sup_thr = suppression_matrix(nms_boxes, iou_threshold,
                                          containment_threshold)
    return Candidates(top_boxes, top_scores, top_classes, sup_mat.contiguous(),
                      sup_thr, top_scores > score_threshold)


def nms(boxes: torch.Tensor, scores: torch.Tensor, classes: torch.Tensor, *,
        score_threshold: float = 0.25, iou_threshold: float = 0.45,
        containment_threshold: float = 0.0, pre_topk: int = 256,
        max_det: int = 64, class_aware: bool = True,
        exact: bool = True) -> Detections:
    """Batched NMS. boxes (B, A, 4), scores (B, A), classes (B, A) int.

    `exact=True` gives the kept set of sequential greedy NMS; on a CUDA
    tensor it runs the hand-written suppression kernel."""
    c = nms_candidates(boxes, scores, classes, score_threshold=score_threshold,
                       iou_threshold=iou_threshold,
                       containment_threshold=containment_threshold,
                       pre_topk=pre_topk, class_aware=class_aware)
    if exact:
        keep = suppress(c.matrix, c.keep0, c.thr)
    else:
        keep = suppress_fast(c.matrix, c.keep0, c.thr)
    return nms_select(c, keep, score_threshold=score_threshold, max_det=max_det)


def nms_select(c: Candidates, keep: torch.Tensor, *,
               score_threshold: float = 0.25, max_det: int = 64) -> Detections:
    """Step 4 of `nms`: the `max_det` best kept candidates, padded."""
    final_scores = torch.where(keep, c.scores, -1.0)
    top_boxes, top_classes = c.boxes, c.classes
    k = final_scores.shape[-1]
    if k < max_det:  # fewer candidates than output slots: pad with invalid
        pad = max_det - k
        final_scores = F.pad(final_scores, (0, pad), value=-1.0)
        top_boxes = F.pad(top_boxes, (0, 0, 0, pad))
        top_classes = F.pad(top_classes, (0, pad), value=-1)
    out_scores, out_idx = top_k_stable(final_scores, max_det)
    out_valid = out_scores > score_threshold
    sel_boxes = torch.gather(top_boxes, 1, out_idx[..., None].expand(-1, -1, 4))
    out_boxes = torch.where(out_valid[..., None], sel_boxes, 0.0)
    out_classes = torch.where(out_valid, torch.gather(top_classes, 1, out_idx), -1)
    out_scores = torch.where(out_valid, out_scores, -1.0)
    return Detections(out_boxes, out_scores, out_classes.int(), out_valid)
