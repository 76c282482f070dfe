"""YOLOv8 detect and pose models: port of hockey_tpu/models/yolov8.py.

Public functions keep the JAX package's layout: `forward_raw` takes an
NHWC batch and returns NHWC head maps, `decode_boxes` returns (B, A, 4)
xyxy boxes and (B, A, nc) sigmoid scores, `decode_keypoints` a pose
model's (B, A, K, 3) keypoints. Inside, the network runs
NCHW-shaped tensors in channels_last memory (the same bytes as NHWC), the
layout cuDNN's bf16 tensor-core convolutions prefer.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..core.device import device_constant
from .checkpoint import flatten_tree
from .layers import C2f, SPPF, Conv, make_divisible, upsample2x

# depth multiple, width multiple, P5-channel ratio
VARIANTS = {
    "n": (1 / 3, 0.25, 2.0),
    "s": (1 / 3, 0.50, 2.0),
    "m": (2 / 3, 0.75, 1.5),
    "l": (1.0, 1.00, 1.0),
    "x": (1.0, 1.25, 1.0),
}

STRIDES = (8, 16, 32)
REG_MAX = 16


@dataclasses.dataclass(frozen=True)
class YoloConfig:
    variant: str = "l"
    num_classes: int = 2
    num_keypoints: int = 0          # 0 = detect model; 56 for the rink model
    reg_max: int = REG_MAX

    @property
    def depth(self) -> float:
        return VARIANTS[self.variant][0]

    @property
    def width(self) -> float:
        return VARIANTS[self.variant][1]

    @property
    def ratio(self) -> float:
        return VARIANTS[self.variant][2]

    def ch(self, base: int) -> int:
        return make_divisible(base * self.width, 8)

    @property
    def channels(self) -> Tuple[int, int, int, int, int]:
        """(c1..c4, c5) backbone stage output channels."""
        c = self.ch
        return (c(64), c(128), c(256), c(512),
                make_divisible(512 * self.width * self.ratio, 8))

    def n_rep(self, base: int) -> int:
        return max(round(base * self.depth), 1)

    @property
    def head_channels(self) -> Tuple[int, int, int]:
        _, _, c3, c4, c5 = self.channels
        return (c3, c4, c5)


# The JAX package's model zoo (hockey_tpu/models/yolov8.py MODEL_ZOO).
MODEL_ZOO = {
    "hockey-player-detection": YoloConfig("x", num_classes=2),
    "hockey-detection": YoloConfig("s", num_classes=1, num_keypoints=56),
    "hockey-puck-detection": YoloConfig("s", num_classes=1),
}


class Branch(nn.Module):
    """One head branch: two 3x3 convs and a 1x1 output conv with bias."""

    def __init__(self, cin: int, c: int, cout: int):
        super().__init__()
        self.cv1 = Conv(cin, c, 3)
        self.cv2 = Conv(c, c, 3)
        self.out = Conv(c, cout, 1, bn=False, bias=True, act=False)

    def forward(self, x):
        return self.out(self.cv2(self.cv1(x)))


class YOLOv8(nn.Module):
    """Backbone (C2f/SPPF) + PAN neck + decoupled DFL head. Module names
    follow the JAX parameter tree (`backbone.stem`, `neck.c2f_up1`,
    `head.reg.0`, ...)."""

    def __init__(self, cfg: YoloConfig):
        super().__init__()
        self.cfg = cfg
        c1, c2, c3, c4, c5 = cfg.channels
        n3, n6 = cfg.n_rep(3), cfg.n_rep(6)
        self.backbone = nn.ModuleDict(dict(
            stem=Conv(3, c1, 3, 2),
            down1=Conv(c1, c2, 3, 2),
            c2f1=C2f(c2, c2, n3, True),
            down2=Conv(c2, c3, 3, 2),
            c2f2=C2f(c3, c3, n6, True),
            down3=Conv(c3, c4, 3, 2),
            c2f3=C2f(c4, c4, n6, True),
            down4=Conv(c4, c5, 3, 2),
            c2f4=C2f(c5, c5, n3, True),
            sppf=SPPF(c5, c5),
        ))
        self.neck = nn.ModuleDict(dict(
            c2f_up1=C2f(c5 + c4, c4, n3, False),
            c2f_up2=C2f(c4 + c3, c3, n3, False),
            down_p3=Conv(c3, c3, 3, 2),
            c2f_d1=C2f(c3 + c4, c4, n3, False),
            down_p4=Conv(c4, c4, 3, 2),
            c2f_d2=C2f(c4 + c5, c5, n3, False),
        ))
        ch = cfg.head_channels
        creg = max(16, ch[0] // 4, cfg.reg_max * 4)
        ccls = max(ch[0], min(cfg.num_classes, 100))
        self.head = nn.ModuleDict(dict(
            reg=nn.ModuleList(Branch(c, creg, 4 * cfg.reg_max) for c in ch),
            cls=nn.ModuleList(Branch(c, ccls, cfg.num_classes) for c in ch),
        ))
        if cfg.num_keypoints:  # pose head (hockey_tpu yolov8.py:176-185)
            nk = 3 * cfg.num_keypoints
            ckpt = max(ch[0] // 4, nk)
            self.head["kpt"] = nn.ModuleList(Branch(c, ckpt, nk) for c in ch)

    def forward(self, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
        """x: (B, 3, H, W) -> per-level NCHW head maps {'box', 'cls'} and,
        for a pose model, 'kpt' (B, 3K, Hi, Wi)."""
        b, n = self.backbone, self.neck
        y = b["down1"](b["stem"](x))
        y = b["c2f1"](y)
        p3 = b["c2f2"](b["down2"](y))
        p4 = b["c2f3"](b["down3"](p3))
        p5 = b["sppf"](b["c2f4"](b["down4"](p4)))
        t4 = n["c2f_up1"](torch.cat([upsample2x(p5), p4], 1))
        o3 = n["c2f_up2"](torch.cat([upsample2x(t4), p3], 1))
        o4 = n["c2f_d1"](torch.cat([n["down_p3"](o3), t4], 1))
        o5 = n["c2f_d2"](torch.cat([n["down_p4"](o4), p5], 1))
        feats = (o3, o4, o5)
        return {name: [m(f) for m, f in zip(self.head[key], feats)]
                for name, key in (("box", "reg"), ("cls", "cls"), ("kpt", "kpt"))
                if key in self.head}


def params_from_jax(tree) -> Dict[str, torch.Tensor]:
    """JAX-layout parameter tree (nested dicts/lists of numpy arrays) ->
    a state dict for the port's modules: names joined with '.', HWIO conv
    kernels transposed to OIHW, BN leaves kept as they are."""
    state = {}
    for path, leaf in flatten_tree(tree).items():
        a = np.asarray(leaf)
        if path[-1] == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        state[".".join(path)] = torch.from_numpy(a.copy())  # own, writable
    return state


def build_model(cfg: YoloConfig, params) -> YOLOv8:
    """YOLOv8 in eval mode from a JAX-layout parameter tree."""
    model = YOLOv8(cfg).eval()
    model.load_state_dict(params_from_jax(params), strict=True)
    return model


def forward_raw(model: YOLOv8, x: torch.Tensor) -> Dict[str, List[torch.Tensor]]:
    """(B, H, W, 3) NHWC input -> per-level NHWC raw head maps: 'box'
    (B, Hi, Wi, 4*reg_max), 'cls' (B, Hi, Wi, nc) and for a pose model
    'kpt' (B, Hi, Wi, 3K), as the JAX forward_raw returns them. The maps
    are NHWC-shaped views; `decode_*` flattens them in that order."""
    out = model(x.permute(0, 3, 1, 2))  # NCHW shape, NHWC bytes
    return {k: [m.permute(0, 2, 3, 1) for m in v] for k, v in out.items()}


def anchor_points(hw, strides: Sequence[int] = STRIDES
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(A, 2) grid-cell centres in stride units and (A,) stride per anchor,
    concatenated over levels; `hw` is an int or an (in_h, in_w) tuple."""
    in_h, in_w = (hw, hw) if isinstance(hw, int) else hw
    pts, strs = [], []
    for s in strides:
        gh, gw = in_h // s, in_w // s
        ys, xs = np.meshgrid(np.arange(gh) + 0.5, np.arange(gw) + 0.5,
                             indexing="ij")
        pts.append(np.stack([xs.ravel(), ys.ravel()], axis=-1))
        strs.append(np.full((gh * gw,), s, np.float32))
    return (np.concatenate(pts).astype(np.float32), np.concatenate(strs))


def decode_boxes(raw: Dict[str, List[torch.Tensor]], cfg: YoloConfig, imgsz
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Raw NHWC head maps -> (boxes xyxy (B, A, 4) in letterboxed px,
    sigmoid class scores (B, A, nc)); the DFL box is the softmax
    expectation over reg_max distance bins per side
    (hockey_tpu yolov8.py:293-320)."""
    b = raw["box"][0].shape[0]
    box_flat = torch.cat([m.reshape(b, -1, 4 * cfg.reg_max)
                          for m in raw["box"]], 1).float()
    cls_flat = torch.cat([m.reshape(b, -1, cfg.num_classes)
                          for m in raw["cls"]], 1).float()
    dev = box_flat.device
    in_hw = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    pts = device_constant(("anchor_points", in_hw),
                          lambda: anchor_points(in_hw)[0], dev, torch.float32)
    strs = device_constant(("anchor_strides", in_hw),
                           lambda: anchor_points(in_hw)[1], dev, torch.float32)

    dist = box_flat.reshape(b, -1, 4, cfg.reg_max)
    bins = torch.arange(cfg.reg_max, dtype=torch.float32, device=dev)
    dist = torch.sum(torch.softmax(dist, dim=-1) * bins, dim=-1)  # (B,A,4)

    x1y1 = pts[None] - dist[..., :2]
    x2y2 = pts[None] + dist[..., 2:]
    boxes = torch.cat([x1y1, x2y2], dim=-1) * strs[None, :, None]
    return boxes, torch.sigmoid(cls_flat)


def decode_keypoints(raw: Dict[str, List[torch.Tensor]], cfg: YoloConfig,
                     imgsz) -> torch.Tensor:
    """Raw NHWC 'kpt' maps -> (B, A, K, 3): x, y in letterboxed px and the
    sigmoid confidence, xy = (kpt * 2 + (anchor - 0.5)) * stride
    (hockey_tpu yolov8.py:323-338). Each (B, Hi, Wi, 3K) map is flattened
    in NHWC order, so a row holds one anchor's K (x, y, conf) triples."""
    b = raw["kpt"][0].shape[0]
    k = cfg.num_keypoints
    kpt = torch.cat([m.reshape(b, -1, k, 3) for m in raw["kpt"]], 1).float()
    dev = kpt.device
    in_hw = (imgsz, imgsz) if isinstance(imgsz, int) else tuple(imgsz)
    pts = device_constant(("anchor_points", in_hw),
                          lambda: anchor_points(in_hw)[0], dev, torch.float32)
    strs = device_constant(("anchor_strides", in_hw),
                           lambda: anchor_points(in_hw)[1], dev, torch.float32)
    xy = (kpt[..., :2] * 2.0 + (pts[None, :, None] - 0.5)) * strs[None, :, None, None]
    return torch.cat([xy, torch.sigmoid(kpt[..., 2:3])], dim=-1)
