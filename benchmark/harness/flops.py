"""Operations of a YOLOv8 forward, counted from a configuration's own
layer shapes (ultralytics/cfg/models/v8/yolov8.yaml): 2 x the
multiply-accumulates of every convolution at the input size, the DFL's
fixed expectation left out. At 640 x 640 with 80 classes this is
Ultralytics' published 257.8 GFLOPs for scale x and 28.6 for scale s.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

# (repeats, channels) of the backbone's and the neck's C2f blocks and
# the channels of each stride-2 conv, as the yaml states them at scale 1
BACKBONE = ((64, None), (128, 3), (256, 6), (512, 6), (1024, 3))
NECK_UP = (512, 256)
NECK_DOWN = (512, 1024)


def _div8(x: float) -> int:
    return int(math.ceil(x / 8) * 8)


def yolov8_flops(cfg: Dict, in_hw: Tuple[int, int]) -> float:
    """FLOPs of one image's forward. `cfg`: depth_multiple,
    width_multiple, max_channels, nc, reg_max."""
    d, wm, mc = cfg["depth_multiple"], cfg["width_multiple"], cfg["max_channels"]
    nc, reg = cfg["nc"], cfg.get("reg_max", 16)
    ch = lambda c: _div8(min(c, mc) * wm)  # noqa: E731
    rep = lambda n: max(round(n * d), 1)  # noqa: E731
    macs: List[float] = []

    def conv(cin, cout, k, hw):
        macs.append(hw[0] * hw[1] * cout * cin * k * k)

    def c2f(cin, cout, n, hw):
        c = cout // 2
        conv(cin, 2 * c, 1, hw)
        for _ in range(n):
            conv(c, c, 3, hw)
            conv(c, c, 3, hw)
        conv((2 + n) * c, cout, 1, hw)

    h, w = in_hw
    cin, hw = 3, (h, w)
    levels = []
    for c, n in BACKBONE:
        hw = (hw[0] // 2, hw[1] // 2)
        conv(cin, ch(c), 3, hw)
        cin = ch(c)
        if n:
            c2f(cin, cin, rep(n), hw)
        levels.append((cin, hw))
    c5, hw5 = levels[-1]
    conv(c5, c5 // 2, 1, hw5)                      # SPPF
    conv(c5 // 2 * 4, c5, 1, hw5)
    (c3, hw3), (c4, hw4) = levels[2], levels[3]
    n3 = rep(3)
    t4 = ch(NECK_UP[0])
    c2f(c5 + c4, t4, n3, hw4)
    o3 = ch(NECK_UP[1])
    c2f(t4 + c3, o3, n3, hw3)
    conv(o3, o3, 3, hw4)
    o4 = ch(NECK_DOWN[0])
    c2f(o3 + t4, o4, n3, hw4)
    conv(o4, o4, 3, hw5)
    o5 = ch(NECK_DOWN[1])
    c2f(o4 + c5, o5, n3, hw5)
    feats = ((o3, hw3), (o4, hw4), (o5, hw5))
    creg = max(16, o3 // 4, reg * 4)
    ccls = max(o3, min(nc, 100))
    for c, hwl in feats:
        for mid, out in ((creg, 4 * reg), (ccls, nc)):
            conv(c, mid, 3, hwl)
            conv(mid, mid, 3, hwl)
            conv(mid, out, 1, hwl)
    return 2.0 * sum(macs)
