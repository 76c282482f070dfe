"""YOLOv8 detection loss, BCE cls + CIoU box + distribution focal loss,
and the v8-pose keypoint loss: port of hockey_tpu/train/losses.py.

Weights are the published v8 defaults (box 7.5, cls 0.5, dfl 1.5; kpt
12, kobj 1). Boxes are decoded in grid units and assigned in pixels; all
of it in f32 whatever the forward's dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from ..core.device import device_constant
from ..models.yolov8 import YoloConfig, anchor_points
from ..ops.iou import ciou
from ..utils.profiling import annotate
from .assigner import assign_batch

BOX_W, CLS_W, DFL_W = 7.5, 0.5, 1.5
KPT_W, KOBJ_W = 12.0, 1.0  # published v8-pose defaults


def _dfl_loss(pred_dist: torch.Tensor, target: torch.Tensor, reg_max: int) -> torch.Tensor:
    """Distribution focal loss per side. pred_dist (..., reg_max) logits,
    target (...) continuous in [0, reg_max-1]: cross-entropy against the
    two straddling bins, linearly weighted."""
    tl = torch.clamp(torch.floor(target), 0, reg_max - 1)
    tr = torch.clamp(tl + 1, 0, reg_max - 1)
    wl = tr - target
    wr = 1.0 - wl
    logp = torch.log_softmax(pred_dist, dim=-1)
    ll = torch.gather(logp, -1, tl[..., None].long())[..., 0]
    lr = torch.gather(logp, -1, tr[..., None].long())[..., 0]
    return -(ll * wl + lr * wr)


def _anchors(imgsz, device) -> Tuple[torch.Tensor, torch.Tensor]:
    hw = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    pts = device_constant(("anchor_points", hw), lambda: anchor_points(hw)[0],
                          device, torch.float32)
    strides = device_constant(("anchor_strides", hw),
                              lambda: anchor_points(hw)[1], device, torch.float32)
    return pts, strides


def _batch_total(t: torch.Tensor) -> torch.Tensor:
    return t


def detection_loss(raw: Dict, batch: Dict[str, torch.Tensor], cfg: YoloConfig,
                   imgsz: int, global_sum: Callable = _batch_total
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """raw: `forward_raw`'s NHWC head maps. batch: 'boxes' (B, M, 4) xyxy
    px, 'classes' (B, M) int, 'mask' (B, M) bool, and for a pose model
    'keypoints' (B, M, K, 3). Returns (loss, metrics).

    `global_sum(t)` is the global batch's sum of a gradient-free sum `t` over
    this batch, for the normalisers: this batch's own sum here; over a
    dp-sharded batch the sum over the dp ranks (parallel/sharding.py), so
    that each rank's loss and metrics are its share of the global ones."""
    b = raw["box"][0].shape[0]
    reg_max, nc = cfg.reg_max, cfg.num_classes
    box_flat = torch.cat([m.reshape(b, -1, 4 * reg_max) for m in raw["box"]],
                         1).float()                                  # (B, A, 4*rm)
    cls_flat = torch.cat([m.reshape(b, -1, nc) for m in raw["cls"]],
                         1).float()                                  # (B, A, nc)
    pts, strides = _anchors(imgsz, box_flat.device)                   # grid units

    # predicted boxes in grid units, then in px for the assignment
    dist = box_flat.reshape(b, -1, 4, reg_max)
    bins = torch.arange(reg_max, dtype=torch.float32, device=dist.device)
    dist_e = torch.sum(torch.softmax(dist, dim=-1) * bins, dim=-1)   # (B, A, 4)
    pred_xyxy_grid = torch.cat([pts[None] - dist_e[..., :2],
                                pts[None] + dist_e[..., 2:]], dim=-1)
    pts_px = pts * strides[:, None]
    pred_xyxy_px = pred_xyxy_grid * strides[None, :, None]

    # the assignment is gradient-free: with gradients through the soft
    # targets t = align / max_align * max_iou the optimiser shrinks the
    # targets by making predictions worse (TAL's degenerate minimum;
    # hockey_tpu/train/loop.py:9-14)
    with torch.no_grad(), annotate("tal_assign"):
        assign = assign_batch(torch.sigmoid(cls_flat).detach(),
                              pred_xyxy_px.detach(), pts_px, batch["boxes"],
                              batch["classes"], batch["mask"], num_classes=nc)
    fg = assign.fg_mask                                               # (B, A)
    tgt_scores = assign.target_scores                                 # (B, A, nc)
    tgt_sum = torch.clamp(global_sum(torch.sum(tgt_scores)), min=1.0)

    # cls: BCE over all anchors
    cls_loss = torch.sum(sigmoid_bce(cls_flat, tgt_scores)) / tgt_sum

    # box: CIoU on fg, weighted by the target score
    w = torch.sum(tgt_scores, dim=-1)                                 # (B, A)
    iou_term = 1.0 - ciou(pred_xyxy_px, assign.target_boxes)
    box_loss = torch.sum(iou_term * w * fg) / tgt_sum

    # dfl: per-side cross-entropy on fg
    tgt_grid = assign.target_boxes / strides[None, :, None]
    lt = pts[None] - tgt_grid[..., :2]
    rb = tgt_grid[..., 2:] - pts[None]
    tgt_ltrb = torch.clamp(torch.cat([lt, rb], -1), 0, reg_max - 1.01)
    dfl = _dfl_loss(dist, tgt_ltrb, reg_max)                          # (B, A, 4)
    dfl_loss = torch.sum(torch.mean(dfl, dim=-1) * w * fg) / tgt_sum

    total = BOX_W * box_loss + CLS_W * cls_loss + DFL_W * dfl_loss
    metrics = {"loss": total, "box_loss": box_loss, "cls_loss": cls_loss,
               "dfl_loss": dfl_loss, "num_fg": torch.sum(fg.float())}

    if "kpt" in raw and "keypoints" in batch:
        kpt_loc, kpt_vis = _keypoint_loss(raw, batch, cfg, assign, fg, w,
                                          pts, strides, global_sum)
        total = total + KPT_W * kpt_loc + KOBJ_W * kpt_vis
        metrics.update(loss=total, kpt_loss=kpt_loc, kobj_loss=kpt_vis)
    return total, metrics


def _keypoint_loss(raw, batch, cfg, assign, fg, w, pts, strides, global_sum):
    """v8-pose keypoint loss on fg anchors: the OKS-style location term
    1 - exp(-d^2 / (2 * max(area, 1))) over visible keypoints, and BCE on
    each keypoint's visibility logit. batch['keypoints']: (B, M, K, 3)
    holding (x px, y px, visible)."""
    b = raw["kpt"][0].shape[0]
    k = cfg.num_keypoints
    kpt_raw = torch.cat([m.reshape(b, -1, k, 3) for m in raw["kpt"]],
                        1).float()                                    # (B, A, K, 3)
    p = pts[None, :, None, :]
    s = strides[None, :, None, None]
    pred_xy = (kpt_raw[..., :2] * 2.0 + (p - 0.5)) * s
    vis_logit = kpt_raw[..., 2]

    gt_kpts = batch["keypoints"]                                      # (B, M, K, 3)
    a = assign.target_gt_idx.shape[1]
    idx = assign.target_gt_idx[..., None, None].expand(b, a, k, 3)
    tgt = torch.gather(gt_kpts, 1, idx)
    tgt_xy, tgt_vis = tgt[..., :2], tgt[..., 2]

    area = box_area_xyxy(assign.target_boxes)                         # (B, A)
    d2 = torch.sum((pred_xy - tgt_xy) ** 2, dim=-1)                   # (B, A, K)
    e = d2 / (2.0 * torch.clamp(area[..., None], min=1.0))
    oks_term = 1.0 - torch.exp(-e)
    vis_mask = (tgt_vis > 0.5).float()
    anchor_w = (w * fg)[..., None]
    loc = torch.sum(oks_term * vis_mask * anchor_w) / torch.clamp(
        global_sum(torch.sum(vis_mask * anchor_w)), min=1.0)
    vis_bce = sigmoid_bce(vis_logit, vis_mask)
    vis = torch.sum(vis_bce * fg[..., None]) / torch.clamp(
        global_sum(torch.sum(fg.float())) * k, min=1.0)
    return loc, vis


def box_area_xyxy(boxes: torch.Tensor) -> torch.Tensor:
    return (torch.clamp(boxes[..., 2] - boxes[..., 0], min=0)
            * torch.clamp(boxes[..., 3] - boxes[..., 1], min=0))


def sigmoid_bce(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Numerically stable elementwise sigmoid BCE
    (hockey_tpu losses.py `optax_sigmoid_bce`)."""
    return (torch.clamp(logits, min=0) - logits * targets
            + torch.log1p(torch.exp(-torch.abs(logits))))
