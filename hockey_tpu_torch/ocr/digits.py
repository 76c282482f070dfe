"""The jersey-number recognizer, inference half: port of
hockey_tpu/ocr/digits.py (`forward` as `DigitNet`, `normalize_crop`,
`predict`, `load_default_params`).

A small convnet over 48x48 contrast-normalised gray torso crops with two
heads: the tens digit (0-9, or 10 for "single digit") and the ones digit.
The shipped checkpoint (`hockey_tpu/data/weights/jersey_digits.msgpack`)
is read in place. The net runs in f32 with TF32 off, as the JAX package
runs it at `Precision.HIGHEST`.

`normalize_crop` needs no OpenCV: the gray conversion and the 48x48
bilinear resize follow OpenCV's fixed-point arithmetic for uint8, so the
crop equals the JAX package's `cv2` chain bit for bit. (The team crops'
f32 resize, `teams/base.resize_crop`, is within 1 of `cv2.resize` per
pixel; after the percentile stretch that moved 2 of 200 rendered crops
to another number.) The training half of the JAX module (synthetic
crops, `train`) is not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..models.checkpoint import load_params, shipped_weights_path
from ..models.layers import Conv
from ..models.yolov8 import params_from_jax

CROP = 48
TENS_NONE = 10  # tens-head class meaning "single digit"
# (name, in, out, kernel, stride) of hockey_tpu digits.py:34-61
LAYERS = (("c0", 1, 16, 3, 1), ("c1", 16, 32, 3, 2), ("c2", 32, 64, 3, 2),
          ("c3", 64, 128, 3, 2), ("c4", 128, 192, 3, 2))
# OpenCV's fixed-point BGR -> gray for uint8 (15-bit weights of B, G, R)
# and its 11-bit bilinear weights; both checked bit for bit against cv2 in
# tests/test_torch_ocr.py
_GRAY_BGR, _GRAY_SHIFT = (3735, 19235, 9798), 15
_COEF_SCALE = 2048


class DigitNet(nn.Module):
    """(N, 48, 48, 1) f32 -> (tens logits (N, 11), ones logits (N, 10)):
    five 3x3 convs with bias and SiLU, global average pooling, two 1x1
    heads without activation (hockey_tpu digits.py:48-61)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, stride in LAYERS:
            setattr(self, name, Conv(cin, cout, k, stride, bn=False, bias=True))
        self.tens = Conv(192, 11, 1, bn=False, bias=True, act=False)
        self.ones = Conv(192, 10, 1, bn=False, bias=True, act=False)

    @classmethod
    def from_params(cls, params: Dict) -> "DigitNet":
        """The net in eval mode from the JAX-layout tree {c0..c4, tens,
        ones: {w HWIO, b}}."""
        net = cls().eval()
        net.load_state_dict(params_from_jax(params), strict=True)
        return net

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            h = x.permute(0, 3, 1, 2)
            for name, *_ in LAYERS:
                h = getattr(self, name)(h)
            h = h.mean(dim=(2, 3), keepdim=True)
            return self.tens(h)[:, :, 0, 0], self.ones(h)[:, :, 0, 0]


def load_default_params() -> Optional[Dict]:
    """The shipped checkpoint's tree, or None where it is absent."""
    path = shipped_weights_path("jersey_digits")
    return None if path is None else load_params(path)


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 BGR -> (h, w) uint8, as cv2.COLOR_BGR2GRAY rounds."""
    x = img.astype(np.int32)
    cb, cg, cr = _GRAY_BGR
    g = (x[..., 0] * cb + x[..., 1] * cg + x[..., 2] * cr
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return g.astype(np.uint8)


def _taps(src: int, dst: int, clamp_weight: bool):
    """(first source index, second, weight of first, weight of second) of
    each of `dst` samples over `src` pixels: half-pixel centres, weights
    rounded to 1/2048. Where a sample falls past an edge, the columns
    (`clamp_weight`) move it onto the edge pixel; the rows keep its weight
    and read the edge row twice, as OpenCV does."""
    scale = np.float64(1.0) / (np.float64(dst) / np.float64(src))
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(np.float32)).astype(np.float32)
    if clamp_weight:
        out = (i < 0) | (i >= src - 1)
        f[out] = 0.0
        i = np.clip(i, 0, src - 1)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), w0, w1


def resize_gray(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(h, w) uint8 -> (oh, ow) uint8 as cv2.resize INTER_LINEAR gives it:
    columns then rows in fixed point, the rows' products taken at 16-bit
    grade as OpenCV's vector path does (an exact 2x shrink, which OpenCV
    runs as INTER_AREA, comes out the same)."""
    x = img.astype(np.int64)
    c0, c1, a0, a1 = _taps(img.shape[1], out_hw[1], True)
    horiz = x[:, c0] * a0 + x[:, c1] * a1
    r0, r1, b0, b1 = _taps(img.shape[0], out_hw[0], False)
    v = ((((horiz[r0] >> 4) * b0[:, None]) >> 16)
         + (((horiz[r1] >> 4) * b1[:, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def normalize_crop(crop_bgr: np.ndarray) -> np.ndarray:
    """Torso crop (h, w, 3) uint8 BGR -> (48, 48, 1) f32 contrast-normalised
    gray: 5th and 95th percentiles stretched to [0, 1]
    (hockey_tpu digits.py:64-72)."""
    g = resize_gray(bgr_to_gray(crop_bgr), (CROP, CROP)).astype(np.float32)
    lo, hi = np.percentile(g, 5), np.percentile(g, 95)
    g = np.clip((g - lo) / max(hi - lo, 1.0), 0.0, 1.0)
    return g[..., None].astype(np.float32)


def predict(net: DigitNet, crops: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """(N, 48, 48, 1) crops -> each crop's number string and confidence
    P(tens) * P(ones): one forward on the net's device, the softmax on the
    host in f32 (hockey_tpu digits.py:75-94; no padding to a bucket, since
    eager PyTorch has no compiled shapes to keep)."""
    dev = next(net.buffers()).device
    with torch.inference_mode():
        tens_l, ones_l = net(torch.as_tensor(np.asarray(crops, np.float32)).to(dev))
    pt = torch.softmax(tens_l.float().cpu(), dim=-1).numpy()
    po = torch.softmax(ones_l.float().cpu(), dim=-1).numpy()
    t, o = pt.argmax(-1), po.argmax(-1)
    conf = pt.max(-1) * po.max(-1)
    out = [str(oi) if ti == TENS_NONE else f"{ti}{oi}" for ti, oi in zip(t, o)]
    return out, conf
