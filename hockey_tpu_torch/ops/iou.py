"""Box IoU: port of hockey_tpu/ops/iou.py (box_area, box_iou with a
leading batch dimension allowed, and the training loss's ciou)."""

from __future__ import annotations

import math

import torch

EPS = 1e-7


def box_area(boxes: torch.Tensor) -> torch.Tensor:
    """Area of (..., 4) xyxy boxes."""
    w = torch.clamp(boxes[..., 2] - boxes[..., 0], min=0.0)
    h = torch.clamp(boxes[..., 3] - boxes[..., 1], min=0.0)
    return w * h


def box_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Pairwise IoU. a: (..., N, 4), b: (..., M, 4) xyxy -> (..., N, M)."""
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a)[..., :, None] + box_area(b)[..., None, :] - inter
    return inter / torch.clamp(union, min=EPS)


def ciou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Elementwise Complete-IoU between aligned (..., 4) xyxy boxes: IoU
    minus the centre-distance and aspect-ratio penalties of the YOLOv8
    box loss (hockey_tpu/ops/iou.py:33-66). `alpha` is not detached: the
    gradient flows through it as in the JAX function."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    wh = torch.clamp(rb - lt, min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = box_area(a) + box_area(b) - inter
    iou = inter / torch.clamp(union, min=EPS)

    # smallest enclosing box
    c_lt = torch.minimum(a[..., :2], b[..., :2])
    c_rb = torch.maximum(a[..., 2:], b[..., 2:])
    c_wh = torch.clamp(c_rb - c_lt, min=0.0)
    c2 = c_wh[..., 0] ** 2 + c_wh[..., 1] ** 2 + EPS

    # centre distance
    a_c = (a[..., :2] + a[..., 2:]) * 0.5
    b_c = (b[..., :2] + b[..., 2:]) * 0.5
    rho2 = torch.sum((a_c - b_c) ** 2, dim=-1)

    # aspect-ratio consistency
    aw = torch.clamp(a[..., 2] - a[..., 0], min=EPS)
    ah = torch.clamp(a[..., 3] - a[..., 1], min=EPS)
    bw = torch.clamp(b[..., 2] - b[..., 0], min=EPS)
    bh = torch.clamp(b[..., 3] - b[..., 1], min=EPS)
    v = (4.0 / math.pi ** 2) * (torch.atan(bw / bh) - torch.atan(aw / ah)) ** 2
    alpha = v / torch.clamp(1.0 - iou + v, min=EPS)
    return iou - rho2 / c2 - alpha * v
