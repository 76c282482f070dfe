"""Box IoU: port of hockey_tpu/ops/iou.py (box_area, box_iou), with a
leading batch dimension allowed."""

from __future__ import annotations

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
