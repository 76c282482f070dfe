"""Shared parts of the team classifiers: crop standardisation and the
temporal majority vote. Port of hockey_tpu/teams/base.py.

The JAX package resizes host crops with cv2.resize INTER_LINEAR. The port
resizes them without OpenCV, by the same bilinear geometry (half-pixel
centres, edge clamp: `F.interpolate` bilinear without antialiasing) in f32
and rounds uint8 input back to the uint8 grid; OpenCV's 11-bit
fixed-point weights make its uint8 result differ from this by at most 1
per value.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# Every classifier takes crops of one shape (h, w), the hybrid
# classifier's MobileNet input (reference team_hybrid.py:33).
CROP_H, CROP_W = 128, 64


def resize_crop(crop: np.ndarray, out_hw=(CROP_H, CROP_W)) -> np.ndarray:
    """(h, w, C) -> (oh, ow, C) f32 bilinear resize with cv2's INTER_LINEAR
    geometry (half-pixel centres, edge clamp; the same two-tap weights as
    the letterbox's resize matrices, on the CPU); uint8 input is rounded
    back onto [0, 255] integers, as cv2.resize returns it."""
    x = torch.from_numpy(np.asarray(crop, np.float32)).permute(2, 0, 1)[None]
    out = F.interpolate(x, size=tuple(out_hw), mode="bilinear",
                        align_corners=False)[0].permute(1, 2, 0).numpy()
    if crop.dtype == np.uint8:
        out = np.clip(np.rint(out), 0, 255)
    return out.astype(np.float32)


def host_crops(frame: np.ndarray, boxes: np.ndarray) -> List[np.ndarray]:
    """The frame's (h, w, C) views under xyxy `boxes` (N, 4), corners cut
    to ints and clipped to the frame, as the reference crops players."""
    h, w = frame.shape[:2]
    return [frame[max(int(b[1]), 0):min(int(b[3]), h),
                  max(int(b[0]), 0):min(int(b[2]), w)]
            for b in np.asarray(boxes).reshape(-1, 4)]


def standardize_crops(crops: Sequence[np.ndarray]) -> np.ndarray:
    """Variable-size BGR crops -> (N, 128, 64, 3) f32; an empty or None
    crop stays zeros. Host-side: the detect step samples its crops on the
    device (ops/crop_resize.py)."""
    out = np.zeros((len(crops), CROP_H, CROP_W, 3), np.float32)
    for i, c in enumerate(crops):
        if c is None or c.size == 0:
            continue
        c = np.asarray(c)
        out[i] = resize_crop(c if c.ndim == 3 else c[..., None])
    return out


class MajorityVote:
    """Per-tracker temporal majority vote over the last `window` teams,
    applied once a tracker has `min_votes` of them (the consistency rule
    every reference classifier shares, e.g. team.py:281-298)."""

    def __init__(self, window: int = 10, min_votes: int = 3):
        self.window = window
        self.min_votes = min_votes
        self.history: Dict[int, List[int]] = defaultdict(list)

    def update(self, tracker_ids: Optional[np.ndarray], teams: np.ndarray) -> np.ndarray:
        teams = np.asarray(teams).copy()
        if tracker_ids is None:
            return teams
        for i, tid in enumerate(tracker_ids):
            if tid is None or i >= len(teams):
                continue
            h = self.history[int(tid)]
            h.append(int(teams[i]))
            if len(h) > self.window:
                del h[: len(h) - self.window]
            if len(h) >= self.min_votes:
                teams[i] = np.argmax(np.bincount(h))
        return teams

    def reset(self) -> None:
        self.history.clear()


def to_device_batch(crops, device) -> torch.Tensor:
    """A list of crops (standardised here) or an (N, h, w, 3) array ->
    f32 tensor on `device`."""
    if isinstance(crops, (list, tuple)):
        crops = standardize_crops(crops)
    return torch.as_tensor(np.asarray(crops, np.float32)).to(device)
