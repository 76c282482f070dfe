"""The jersey-number recognizer, inference half: port of
hockey_tpu/ocr/digits.py (`forward` as `DigitNet`, `normalize_crop`,
`predict`, `load_default_params`).

A small convnet over 48x48 contrast-normalised gray torso crops with two
heads: the tens digit (0-9, or 10 for "single digit") and the ones digit.
The shipped checkpoint (`hockey_tpu/data/weights/jersey_digits.msgpack`)
is read in place. The net runs in f32 with TF32 off, as the JAX package
runs it at `Precision.HIGHEST`.

`normalize_crop` needs no OpenCV: the gray conversion and the 48x48
bilinear resize (`ops/gray.py`) follow OpenCV's fixed-point arithmetic for
uint8, so the crop equals the JAX package's `cv2` chain bit for bit. (The team crops'
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
from ..ops.gray import gray_resize

CROP = 48
TENS_NONE = 10  # tens-head class meaning "single digit"
# (name, in, out, kernel, stride) of hockey_tpu digits.py:34-61
LAYERS = (("c0", 1, 16, 3, 1), ("c1", 16, 32, 3, 2), ("c2", 32, 64, 3, 2),
          ("c3", 64, 128, 3, 2), ("c4", 128, 192, 3, 2))


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


def normalize_crop(crop_bgr: np.ndarray) -> np.ndarray:
    """Torso crop (h, w, 3) uint8 BGR -> (48, 48, 1) f32 contrast-normalised
    gray: 5th and 95th percentiles stretched to [0, 1]
    (hockey_tpu digits.py:64-72)."""
    g = gray_resize(crop_bgr, (CROP, CROP)).astype(np.float32)
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
