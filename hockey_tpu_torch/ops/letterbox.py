"""Batched letterbox + normalize: port of hockey_tpu/ops/letterbox.py.

uint8 NHWC frames on the device -> `dtype` NHWC in [0, 1], aspect kept,
gray-114 padding, ultralytics LetterBox geometry. The bilinear resize is
two dense interpolation-matrix products, as in the JAX package; each
matrix is built on its device once per shape and dtype
(`core.device.device_constant`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.device import device_constant

PAD_VALUE = 114.0 / 255.0


def letterbox_params(h: int, w: int, imgsz: int
                     ) -> Tuple[float, int, int, int, int]:
    """(ratio, new_h, new_w, pad_top, pad_left) of the square letterbox:
    r = min(s/h, s/w), round(dim * r), extra pixel to bottom/right."""
    r = min(imgsz / h, imgsz / w)
    new_h, new_w = round(h * r), round(w * r)
    dh, dw = (imgsz - new_h) / 2, (imgsz - new_w) / 2
    pad_top, pad_left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return r, new_h, new_w, pad_top, pad_left


def rect_shape(h: int, w: int, imgsz: int, stride: int = 32) -> Tuple[int, int]:
    """Minimal-rectangle network input: long side to imgsz, each side
    rounded up to the stride ((736, 1280) for 1080p at 1280)."""
    r = min(imgsz / h, imgsz / w)
    new_h, new_w = round(h * r), round(w * r)
    return (-(-new_h // stride) * stride, -(-new_w // stride) * stride)


def rect_letterbox_params(h: int, w: int, imgsz: int, stride: int = 32
                          ) -> Tuple[float, int, int, int, int, int, int]:
    """(ratio, new_h, new_w, pad_top, pad_left, in_h, in_w) for the
    minimal-rectangle letterbox."""
    in_h, in_w = rect_shape(h, w, imgsz, stride)
    r = min(imgsz / h, imgsz / w)
    new_h, new_w = round(h * r), round(w * r)
    dh, dw = (in_h - new_h) / 2, (in_w - new_w) / 2
    pad_top, pad_left = int(round(dh - 0.1)), int(round(dw - 0.1))
    return r, new_h, new_w, pad_top, pad_left, in_h, in_w


def _resize_matrix(src: int, dst: int) -> np.ndarray:
    """(dst, src) bilinear interpolation matrix: half-pixel centres, edge
    clamp (hockey_tpu letterbox.py:63-78)."""
    m = np.zeros((dst, src), np.float32)
    scale = src / dst
    pos = (np.arange(dst) + 0.5) * scale - 0.5
    lo = np.floor(pos).astype(np.int64)
    frac = pos - lo
    lo_c = np.clip(lo, 0, src - 1)
    hi_c = np.clip(lo + 1, 0, src - 1)
    m[np.arange(dst), lo_c] += 1.0 - frac
    m[np.arange(dst), hi_c] += frac
    return m


def _resize(frames: torch.Tensor, out_h: int, out_w: int, dtype
            ) -> torch.Tensor:
    """(B, H, W, C) -> (B, out_h, out_w, C) `dtype`, the separable bilinear
    resize as two products with the (out_h, H) and (W, out_w)
    interpolation matrices."""
    _, h, w, _ = frames.shape
    dev = frames.device
    ah = device_constant(("resize", h, out_h),
                         lambda: _resize_matrix(h, out_h), dev, dtype)
    aw = device_constant(("resize_t", w, out_w),
                         lambda: _resize_matrix(w, out_w).T, dev, dtype)
    x = torch.einsum("rh,bhwc->brwc", ah, frames.to(dtype))
    return torch.einsum("brwc,wk->brkc", x, aw)


def resize_batch(frames: torch.Tensor, out_hw: Tuple[int, int],
                 dtype=torch.float32) -> torch.Tensor:
    """Plain separable bilinear resize, no pad or normalisation:
    (B, H, W, C) -> (B, oh, ow, C) `dtype`, values kept in [0, 255]
    (hockey_tpu letterbox.py:145-160). f32 by default; on CUDA the f32
    products run without TF32 (PyTorch's default), as JAX's HIGHEST."""
    return _resize(frames, out_hw[0], out_hw[1], dtype)


def _letterbox(frames: torch.Tensor, new_h: int, new_w: int, pad_top: int,
               pad_left: int, out_h: int, out_w: int, dtype) -> torch.Tensor:
    b, _, _, c = frames.shape
    dev = frames.device
    # the scale is rounded to `dtype` first, as JAX rounds its weak-typed
    # Python scalar, so a bf16 letterbox equals the JAX package's bit for
    # bit (multiplying by the f32 constant moves ~87% of bf16 values by an
    # ulp)
    x = _resize(frames, new_h, new_w, dtype) * torch.tensor(1.0 / 255.0, dtype=dtype)
    out = torch.full((b, out_h, out_w, c), PAD_VALUE, dtype=dtype, device=dev)
    out[:, pad_top:pad_top + new_h, pad_left:pad_left + new_w] = x
    return out


def letterbox_batch(frames: torch.Tensor, imgsz: int,
                    dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, imgsz, imgsz, 3) `dtype` in [0, 1]."""
    _, h, w, _ = frames.shape
    _, new_h, new_w, pt, pl = letterbox_params(h, w, imgsz)
    return _letterbox(frames, new_h, new_w, pt, pl, imgsz, imgsz, dtype)


def letterbox_rect_batch(frames: torch.Tensor, imgsz: int, stride: int = 32,
                         dtype=torch.bfloat16) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, in_h, in_w, 3) minimal-rectangle letterbox."""
    _, h, w, _ = frames.shape
    _, new_h, new_w, pt, pl, in_h, in_w = rect_letterbox_params(h, w, imgsz,
                                                                stride)
    return _letterbox(frames, new_h, new_w, pt, pl, in_h, in_w, dtype)
