"""Task-aligned label assignment (TAL) for anchor-free YOLOv8 training:
port of hockey_tpu/train/assigner.py, batched over the images (B) where
the JAX function vmaps one image's assignment.

align = score^alpha * iou^beta over the anchors whose centre lies
strictly inside a gt box, the top-k anchors per gt, an anchor claimed by
several gts kept by the highest IoU (the first gt on a tie), target
scores normalised per gt by max_iou / max_align. Shapes are fixed (a
padded gt table and its mask). The caller passes detached predictions:
the assignment carries no gradient (train/losses.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..ops.iou import box_iou


class AssignResult(NamedTuple):
    target_boxes: torch.Tensor   # (B, A, 4) xyxy assigned gt box per anchor
    target_scores: torch.Tensor  # (B, A, nc) soft class targets
    fg_mask: torch.Tensor        # (B, A) bool: the anchor has an assignment
    target_gt_idx: torch.Tensor  # (B, A) int64 assigned gt row (valid on fg)


def assign_batch(
    pred_scores: torch.Tensor,    # (B, A, nc) sigmoid probabilities
    pred_boxes: torch.Tensor,     # (B, A, 4) xyxy, any consistent unit
    anchor_points: torch.Tensor,  # (A, 2) in the same unit
    gt_boxes: torch.Tensor,       # (B, M, 4) xyxy, padded
    gt_classes: torch.Tensor,     # (B, M) int
    gt_mask: torch.Tensor,        # (B, M) bool
    num_classes: int = 2,
    topk: int = 10,
    alpha: float = 0.5,
    beta: float = 6.0,
) -> AssignResult:
    b, a, _ = pred_boxes.shape
    m = gt_boxes.shape[1]

    # candidates: anchor centre strictly inside the gt box
    px, py = anchor_points[:, 0], anchor_points[:, 1]
    inside = ((px > gt_boxes[..., 0:1]) & (px < gt_boxes[..., 2:3])
              & (py > gt_boxes[..., 1:2]) & (py < gt_boxes[..., 3:4]))
    inside &= gt_mask[..., None]                                     # (B, M, A)

    ious = torch.clamp(box_iou(gt_boxes, pred_boxes), min=0.0)      # (B, M, A)
    cls = torch.clamp(gt_classes.long(), 0, num_classes - 1)
    cls_score = torch.gather(pred_scores.transpose(1, 2), 1,
                             cls[..., None].expand(b, m, a))         # (B, M, A)
    align = (cls_score ** alpha) * (ious ** beta)
    align = torch.where(inside, align, 0.0)

    # top-k per gt: only the k-th value counts, and no epsilon floor (an
    # early align ~1e-11 must stay assignable)
    k = min(topk, a)
    kth = torch.topk(align, k, dim=-1).values[..., k - 1:k]          # (B, M, 1)
    cand = inside & (align >= kth) & (align > 0)

    # an anchor claimed by several gts keeps the highest-IoU one
    iou_masked = torch.where(cand, ious, -1.0)
    best_gt = torch.argmax(iou_masked, dim=1)                        # (B, A)
    fg = torch.amax(iou_masked, dim=1) > 0

    rows = best_gt[:, None, :]
    tgt_boxes = torch.gather(gt_boxes, 1, best_gt[..., None].expand(b, a, 4))
    tgt_cls = torch.gather(cls, 1, best_gt)
    tgt_iou = torch.where(fg, torch.gather(ious, 1, rows)[:, 0], 0.0)
    tgt_align = torch.where(fg, torch.gather(align, 1, rows)[:, 0], 0.0)

    # per-gt normalisation: t = align / max_align(gt) * max_iou(gt)
    onehot = (rows == torch.arange(m, device=best_gt.device)[None, :, None]) \
        & fg[:, None, :]                                             # (B, M, A)
    max_align = torch.amax(torch.where(onehot, tgt_align[:, None, :], 0.0), -1)
    max_iou = torch.amax(torch.where(onehot, tgt_iou[:, None, :], 0.0), -1)
    norm = max_iou / torch.clamp(max_align, min=1e-9)
    t = tgt_align * torch.gather(norm, 1, best_gt)                   # (B, A)

    scores = F.one_hot(tgt_cls, num_classes).to(t.dtype) * t[..., None]
    scores = torch.where(fg[..., None], scores, 0.0)
    return AssignResult(tgt_boxes, scores, fg, best_gt)
