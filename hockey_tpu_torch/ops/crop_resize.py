"""Batched crop-and-resize of player boxes: port of
hockey_tpu/ops/crop_resize.py.

Every crop is sampled bilinearly at the centres of an (oh, ow) grid over
its box, edge-clamped, so variable boxes give crops of one static shape.
`crop_and_resize` gathers the four corners of each sample;
`crop_and_resize_mm` writes the same sampling as two interpolation-matrix
products per box, which the fused team branch of the detect step uses on
a downscaled frame.
"""

from __future__ import annotations

from typing import Tuple

import torch


def crop_and_resize(frame: torch.Tensor, boxes: torch.Tensor,
                    out_hw: Tuple[int, int] = (128, 64)) -> torch.Tensor:
    """frame (H, W, C) any dtype, boxes (N, 4) xyxy in pixels (fractional
    or zero-padded) -> (N, oh, ow, C) f32. A zero-area box samples pixel
    (0, 0) everywhere; callers mask by validity."""
    h, w = frame.shape[0], frame.shape[1]
    oh, ow = out_hw
    flat = frame.reshape(h * w, -1).float()
    bx = boxes.float()
    x1, y1, x2, y2 = bx[:, 0:1], bx[:, 1:2], bx[:, 2:3], bx[:, 3:4]
    gy = torch.arange(oh, dtype=torch.float32, device=bx.device)[None]
    gx = torch.arange(ow, dtype=torch.float32, device=bx.device)[None]
    ys = y1 + (gy + 0.5) * (y2 - y1) / oh - 0.5             # (N, oh)
    xs = x1 + (gx + 0.5) * (x2 - x1) / ow - 0.5             # (N, ow)
    y0 = torch.clamp(torch.floor(ys), 0, h - 1)
    x0 = torch.clamp(torch.floor(xs), 0, w - 1)
    y1i = torch.clamp(y0 + 1, 0, h - 1).long()
    x1i = torch.clamp(x0 + 1, 0, w - 1).long()
    wy = torch.clamp(ys - y0, 0.0, 1.0)[:, :, None, None]
    wx = torch.clamp(xs - x0, 0.0, 1.0)[:, None, :, None]
    y0, x0 = y0.long(), x0.long()

    def at(yi, xi):  # (N, oh, ow, C)
        return flat[yi[:, :, None] * w + xi[:, None, :]]

    tl, tr = at(y0, x0), at(y0, x1i)
    bl, br = at(y1i, x0), at(y1i, x1i)
    top = tl + (tr - tl) * wx
    bot = bl + (br - bl) * wx
    return top + (bot - top) * wy


def _hat_weights(lo: torch.Tensor, hi: torch.Tensor, size: int,
                 n_src: int) -> torch.Tensor:
    """(..., size, n_src) bilinear weights of `size` samples spread over
    [lo, hi] on a source axis of n_src pixels (the hat function on the
    integer grid, positions clamped to the axis)."""
    grid = torch.arange(size, dtype=torch.float32, device=lo.device)
    pos = lo[..., None] + (grid + 0.5) * (hi - lo)[..., None] / size - 0.5
    pos = torch.clamp(pos, 0.0, n_src - 1.0)
    src = torch.arange(n_src, dtype=torch.float32, device=lo.device)
    return torch.clamp(1.0 - torch.abs(src - pos[..., None]), 0.0, 1.0)


def crop_and_resize_mm(frame: torch.Tensor, boxes: torch.Tensor,
                       out_hw: Tuple[int, int] = (128, 64)) -> torch.Tensor:
    """Crop-and-resize as two interpolation-matrix products per box.

    frame (h, w, C) with boxes (N, 4), or a batch (B, h, w, C) with boxes
    (B, N, 4), xyxy in the frame's pixels -> (N, oh, ow, C) or
    (B, N, oh, ow, C) f32: the sampling of `crop_and_resize`. The batch
    runs as one batched product per axis over all B * N boxes, with no host
    sync; the larger temporary is (B, N, ow, h, C) f32."""
    single = frame.dim() == 3
    if single:
        frame, boxes = frame[None], boxes[None]
    b, h, w, c = frame.shape
    n = boxes.shape[1]
    oh, ow = out_hw
    bx = boxes.float()
    wy = _hat_weights(bx[..., 1], bx[..., 3], oh, h)        # (B, N, oh, h)
    wx = _hat_weights(bx[..., 0], bx[..., 2], ow, w)        # (B, N, ow, w)
    img = frame.float().permute(0, 2, 1, 3).reshape(b, w, h * c)
    tmp = torch.bmm(wx.reshape(b, n * ow, w), img)          # (B, N*ow, h*C)
    tmp = tmp.reshape(b * n, ow, h, c).permute(0, 2, 1, 3).reshape(
        b * n, h, ow * c)
    out = torch.bmm(wy.reshape(b * n, oh, h), tmp).reshape(b, n, oh, ow, c)
    return out[0] if single else out


def crop_jersey_boxes(boxes: torch.Tensor,
                      v: Tuple[float, float] = (0.25, 0.75),
                      u: Tuple[float, float] = (0.30, 0.70)) -> torch.Tensor:
    """Shrink player boxes (..., 4) to the torso / jersey region: rows
    v[0]-v[1] and columns u[0]-u[1] of each box (the simple classifier's
    geometry by default)."""
    x1, y1, x2, y2 = boxes.unbind(-1)
    w = x2 - x1
    h = y2 - y1
    return torch.stack([x1 + u[0] * w, y1 + v[0] * h,
                        x1 + u[1] * w, y1 + v[1] * h], dim=-1)
