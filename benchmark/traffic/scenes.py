"""The benchmark's traffic generator: seeded numpy drawings of hockey
scenes, needing no OpenCV.

The drawers are frozen copies of chip_smoke.py's (`_ellipse`, `_player`,
`_skaters`, `synthetic_frames`, `puck_path`, `puck_scene`), with the sizes
that chip_smoke.py fixes made parameters; at their defaults they draw the
same pixels for a seed. `clip` reads a traffic file's parameters, and
`PingPong` plays a clip forward and backward in a loop, so that motion
stays continuous for a tracker.
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np

FRAME_HW = (1080, 1920)
KITS = (((200, 160, 40), (40, 40, 40)), ((30, 30, 200), (230, 230, 230)))


def _ellipse(img, cx, cy, ax, ay, color):
    h, w = img.shape[:2]
    x0, x1 = max(int(cx - ax), 0), min(int(cx + ax) + 1, w)
    y0, y1 = max(int(cy - ay), 0), min(int(cy + ay) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0] = color


def _player(img, fx, fy, hpx, jersey, pants):
    bw = 0.42 * hpx
    for s in (-1, 1):
        _ellipse(img, fx + s * 0.2 * bw, fy - 0.16 * hpx, 0.14 * bw, 0.17 * hpx, (38, 38, 42))
        _ellipse(img, fx + s * 0.2 * bw, fy - 0.03 * hpx, 0.22 * bw, 0.03 * hpx, (24, 24, 28))
    _ellipse(img, fx, fy - 0.50 * hpx, 0.55 * bw, 0.11 * hpx, pants)
    _ellipse(img, fx, fy - 0.66 * hpx, 0.5 * bw, 0.2 * hpx, jersey)
    for s in (-1, 1):
        _ellipse(img, fx + s * 0.55 * bw, fy - 0.62 * hpx, 0.13 * bw, 0.16 * hpx, jersey)
    _ellipse(img, fx, fy - 0.9 * hpx, 0.2 * bw, 0.08 * hpx, (150, 150, 150))


def _skaters(rng, players: int, hw=FRAME_HW, heights=(150, 230), speed=10.0):
    """(foot (P, 2), velocity (P, 2) px per frame, height (P,))."""
    h, w = hw
    foot = rng.uniform([150, 0.4 * h], [w - 150, h - 40], (players, 2))
    vel = rng.uniform(-speed, speed, (players, 2))
    size = rng.uniform(heights[0], heights[1], players)
    return foot, vel, size


def _reflect(x: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """x folded into [lo, hi] as a path that bounces off both ends."""
    span = hi - lo
    k = np.mod(x - lo, 2 * span)
    return lo + np.where(k > span, 2 * span - k, k)


def synthetic_frames(seed: int, n: int, players: int = 10, hw=FRAME_HW,
                     heights=(150, 230), speed=10.0, bounce: bool = False,
                     kits=KITS) -> np.ndarray:
    """(n, h, w, 3) uint8 BGR: `players` skaters in two kits (player j in
    kit j % 2) over a white rink with a red centre line, two blue lines
    and a dark band on top, moving at constant velocity; with `bounce`
    they bounce off the borders of the area their feet start in, so every
    skater stays in every frame. `kits` are the two teams' (jersey,
    pants) colours."""
    rng = np.random.default_rng(seed)
    h, w = hw
    base = np.full((h, w, 3), 228, np.uint8)
    base[..., 0] = 236
    base[:, w // 2 - 6:w // 2 + 6] = (40, 40, 200)
    for x in (w // 3, 2 * w // 3):
        base[:, x - 8:x + 8] = (200, 90, 30)
    base[:int(0.18 * h)] = (60, 70, 80)
    foot, vel, size = _skaters(rng, players, hw, heights, speed)
    out = np.empty((n, h, w, 3), np.uint8)
    lo, hi = np.array([150, 0.4 * h]), np.array([w - 150, h - 40])
    for t in range(n):
        f = base.copy()
        pos = foot + vel * t
        if bounce:
            pos = _reflect(pos, lo, hi)
        for j in np.argsort(pos[:, 1] if bounce else foot[:, 1]):
            fx, fy = pos[j]
            _player(f, fx, fy, size[j] * (0.6 + 0.4 * fy / h), *kits[j % 2])
        out[t] = f
    return out


def puck_path(n: int, start=(420.0, 560.0), step=(22.0, 4.0)) -> np.ndarray:
    """(n, 2) centres of a puck on a straight pass."""
    return np.array(start) + np.arange(n)[:, None] * list(step)


def puck_scene(seed: int, n: int, start=(420.0, 560.0), step=(22.0, 4.0),
               **kw) -> np.ndarray:
    """`synthetic_frames` with a puck drawn over the players on
    `puck_path`: a dark ellipse (20, 18, 18), 11 x 7 px half-axes."""
    out = synthetic_frames(seed, n, **kw)
    for f, (x, y) in zip(out, puck_path(n, start, step)):
        _ellipse(f, x, y, 11, 7, (20, 18, 18))
    return out


def clip(params: Dict, seed: int) -> Tuple[np.ndarray, int]:
    """A traffic file's clip for `seed`, and the frame of its ping-pong
    play to start from. The skaters' paths come from the file's
    `layout_seed`: `players` skaters (`heights` px, up to `speed` px per
    frame, bouncing off the borders with `bounce`) over `frames` frames
    at `frame_hw`, with a puck when `puck` names its `start` and `step`,
    the two teams in `kits` ([[jersey BGR], [pants BGR]] each; KITS where
    the file names none). `seed` mirrors the scene or not, swaps the two
    kits or not, and picks the starting frame: every seed gets the same
    encounters of the same skaters, so the same work for the tracker, in
    another order."""
    kw = dict(players=params["players"], hw=tuple(params["frame_hw"]),
              heights=tuple(params["heights"]), speed=params["speed"],
              bounce=params.get("bounce", False))
    rng = np.random.default_rng(seed)
    mirror, swap = rng.integers(2, size=2)
    start = int(rng.integers(max(2 * params["frames"] - 2, 1)))
    kits = tuple(tuple(tuple(c) for c in kit) for kit in params.get("kits", KITS))
    kw["kits"] = kits[::-1] if swap else kits
    puck = params.get("puck")
    if puck:
        out = puck_scene(params["layout_seed"], params["frames"], tuple(puck["start"]),
                         tuple(puck["step"]), **kw)
    else:
        out = synthetic_frames(params["layout_seed"], params["frames"], **kw)
    return (np.ascontiguousarray(out[:, :, ::-1]) if mirror else out), start


def pingpong(i: int, n: int) -> int:
    """The clip index of the i-th frame when n frames play forward, then
    backward, in a loop (period 2n - 2)."""
    if n == 1:
        return 0
    k = i % (2 * n - 2)
    return k if k < n else 2 * n - 2 - k


class PingPong:
    """An endless iterator over a clip played forward and backward from
    frame `start` of that play; it notes the host clock at which each
    frame is pulled (`pulled[i]`)."""

    def __init__(self, frames: np.ndarray, start: int = 0):
        self.frames, self.start = frames, start
        self.pulled: List[float] = []

    def __iter__(self):
        return self

    def __next__(self) -> np.ndarray:
        i = len(self.pulled)
        self.pulled.append(time.perf_counter())
        return self.frames[self.index(i)]

    def index(self, i: int) -> int:
        """The clip index of the i-th frame pulled."""
        return pingpong(self.start + i, len(self.frames))
