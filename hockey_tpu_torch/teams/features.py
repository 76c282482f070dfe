"""Batched jersey features: port of hockey_tpu/teams/features.py (the
hybrid classifier's 49-dim colour vector, the segmentation classifier's
4-dim feature, its colour-prior masks, the simple classifier's statistics
and the host GrabCut mask).

Each function runs over a whole (N, h, w, 3) BGR crop batch at once in
PyTorch ops, with no host sync, so the detect step can hold it. Layouts
and thresholds are those of the JAX package, which keeps them
bit-compatible with the reference's OpenCV definitions.
"""

from __future__ import annotations

import torch

from ..ops.color import bgr_to_hsv, bgr_to_lab


def _hist(values: torch.Tensor, weights: torch.Tensor, nbins: int,
          vmax: float) -> torch.Tensor:
    """Weighted histograms: values and weights (N, P) -> (N, nbins), each
    row normalised to sum 1 (cv2.calcHist then / sum). A scatter-add of the
    weights into each row's bins, where the JAX package reduces a one-hot
    (N, P, nbins) tensor. With 0/1 weights every bin is an integer below
    2^24, exact in any order of addition."""
    idx = torch.clamp((values * (nbins / vmax)).to(torch.int64), 0, nbins - 1)
    h = torch.zeros(values.shape[0], nbins, dtype=torch.float32,
                    device=values.device)
    h.scatter_add_(1, idx, weights.float())
    return h / (h.sum(dim=1, keepdim=True) + 1e-7)


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row mean of x (N, P) over the weights mask (N, P) -> (N,)."""
    return (x * mask).sum(dim=1) / torch.clamp(mask.sum(dim=1), min=1e-7)


def _masked_std(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row standard deviation of x (N, P) over the weights mask."""
    mu = _masked_mean(x, mask)
    var = _masked_mean((x - mu[:, None]) ** 2, mask)
    return torch.sqrt(torch.clamp(var, min=0.0))


def hybrid_color_features(crops: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR crops and (N, h, w) pixel weights -> (N, 49), the
    layout of team_hybrid.py:127-138: [H hist 18, S hist 8, V hist 8,
    HSV mean / 255 x 3, HSV std / 255 x 3, LAB mean / 255 x 3, LAB std / 255
    x 3, low_sat_ratio (S < 30), high_sat_ratio (S > 100), white_ratio
    (V > 200 and S < 30)]. All-ones weights are the reference's."""
    n_crops = crops.shape[0]
    hsv = bgr_to_hsv(crops).reshape(n_crops, -1, 3)
    lab = bgr_to_lab(crops).reshape(n_crops, -1, 3)
    m = masks.reshape(n_crops, -1).float()
    s, v = hsv[..., 1], hsv[..., 2]
    return torch.cat([
        _hist(hsv[..., 0], m, 18, 180.0), _hist(s, m, 8, 256.0),
        _hist(v, m, 8, 256.0),
        torch.stack([_masked_mean(hsv[..., i], m) for i in range(3)], 1) / 255.0,
        torch.stack([_masked_std(hsv[..., i], m) for i in range(3)], 1) / 255.0,
        torch.stack([_masked_mean(lab[..., i], m) for i in range(3)], 1) / 255.0,
        torch.stack([_masked_std(lab[..., i], m) for i in range(3)], 1) / 255.0,
        torch.stack([_masked_mean((s < 30).float(), m),
                     _masked_mean((s > 100).float(), m),
                     _masked_mean(((v > 200) & (s < 30)).float(), m)], 1),
    ], dim=1)


def segmentation_features(crops: torch.Tensor, masks: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR crops and (N, h, w) masks -> (N, 4): the reference's
    team_segmentation.py:97-144 vector over the masked pixels,
    [white_ratio (LAB: L > 200, |a - 128| < 10, |b - 128| < 10),
     dominant_hue (argmax of the 18-bin hue histogram of the non-white
       pixels, x 10; 0 with 50 or fewer of them),
     saturation (mean S of the non-white pixels, else of all),
     brightness (mean V of the masked pixels)].
    A mask under 100 pixels gives the reference's defaults (0.5, 0, 0, 128)."""
    n_crops = crops.shape[0]
    hsv = bgr_to_hsv(crops).reshape(n_crops, -1, 3)
    lab = bgr_to_lab(crops).reshape(n_crops, -1, 3)
    m = masks.reshape(n_crops, -1).float()
    n = m.sum(dim=1)

    white = ((lab[..., 0] > 200) & (torch.abs(lab[..., 1] - 128) < 10)
             & (torch.abs(lab[..., 2] - 128) < 10)).float() * m
    white_ratio = white.sum(dim=1) / torch.clamp(n, min=1e-7)

    colored = m * (1.0 - white)
    hue_hist = _hist(hsv[..., 0], colored, 18, 180.0)
    dominant_hue = torch.argmax(hue_hist, dim=1).float() * 10.0
    enough_colored = colored.sum(dim=1) > 50
    dominant_hue = torch.where(enough_colored, dominant_hue, 0.0)
    saturation = torch.where(enough_colored, _masked_mean(hsv[..., 1], colored),
                             _masked_mean(hsv[..., 1], m))
    brightness = _masked_mean(hsv[..., 2], m)

    few = n < 100
    return torch.stack([torch.where(few, 0.5, white_ratio),
                        torch.where(few, 0.0, dominant_hue),
                        torch.where(few, 0.0, saturation),
                        torch.where(few, 128.0, brightness)], dim=1)


def simple_jersey_stats(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) -> (N, 3) [white_ratio, mean V, mean S] with the simple
    classifier's thresholds (reference team.py:113-118: white = V > 200
    and S < 30)."""
    hsv = bgr_to_hsv(crops).reshape(crops.shape[0], -1, 3)
    white = ((hsv[..., 2] > 200) & (hsv[..., 1] < 30)).float()
    return torch.stack([white.mean(dim=1), hsv[..., 2].mean(dim=1),
                        hsv[..., 1].mean(dim=1)], dim=1)


def _band(n: int, lo: float, hi: float, device) -> torch.Tensor:
    """(n,) bool: int(n * lo) <= i < int(n * hi)."""
    i = torch.arange(n, device=device)
    return (i >= int(n * lo)) & (i < int(n * hi))


def color_prior_masks(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR crops -> (N, h, w) f32 jersey masks: the JAX
    package's replacement for per-crop GrabCut (team_segmentation.py:30-95).

    1. the jersey window: rows 15-60 %, columns 25-75 %;
    2. the background: the mean LAB colour of the border band (rows under
       5 % or from 95 %, columns under 8 % or from 92 %), the ice;
    3. keep the window's pixels whose LAB distance from the background
       exceeds 30;
    4. where fewer than 500 pixels are kept, the reference's GrabCut
       fallback rectangle: rows 20-60 %, columns 30-70 %."""
    n_crops, h, w = crops.shape[:3]
    dev = crops.device
    lab = bgr_to_lab(crops)
    window = _band(h, 0.15, 0.60, dev)[:, None] & _band(w, 0.25, 0.75, dev)[None]
    inner = _band(h, 0.05, 0.95, dev)[:, None] & _band(w, 0.08, 0.92, dev)[None]
    border = (~inner).reshape(1, -1).float().expand(n_crops, -1)
    flat = lab.reshape(n_crops, -1, 3)
    bg = torch.stack([_masked_mean(flat[..., i], border) for i in range(3)], 1)
    dist = torch.sqrt(torch.sum((lab - bg[:, None, None]) ** 2, dim=-1))
    fg = window & (dist > 30.0)
    enough = fg.sum(dim=(1, 2)) >= 500
    fallback = _band(h, 0.2, 0.6, dev)[:, None] & _band(w, 0.3, 0.7, dev)[None]
    return torch.where(enough[:, None, None], fg, fallback).float()


def grabcut_mask_host(crop_bgr):
    """The reference's GrabCut jersey segmentation (team_segmentation.py:
    30-95) on the host, for method='grabcut': one uint8 (h, w, 3) crop ->
    (h, w) f32 mask. Needs OpenCV, imported here."""
    import cv2
    import numpy as np

    h, w = crop_bgr.shape[:2]
    mask = np.zeros((h, w), np.uint8)
    mx, my = int(w * 0.15), int(h * 0.1)
    rect = (mx, my, w - 2 * mx, h - 2 * my)
    bgd = np.zeros((1, 65), np.float64)
    fgd = np.zeros((1, 65), np.float64)
    try:
        cv2.grabCut(crop_bgr, mask, rect, bgd, fgd, 5, cv2.GC_INIT_WITH_RECT)
        m = np.where((mask == 2) | (mask == 0), 0, 1).astype(np.uint8)
        m[int(h * 0.6):, :] = 0
        m[: int(h * 0.15), :] = 0
        m[:, : int(w * 0.25)] = 0
        m[:, int(w * 0.75):] = 0
        kernel = cv2.getStructuringElement(cv2.MORPH_ELLIPSE, (5, 5))
        m = cv2.morphologyEx(m, cv2.MORPH_CLOSE, kernel)
        m = cv2.morphologyEx(m, cv2.MORPH_OPEN, kernel)
        n, labels, stats, _ = cv2.connectedComponentsWithStats(m, connectivity=8)
        if n > 1:
            largest = 1 + np.argmax(stats[1:, cv2.CC_STAT_AREA])
            m = (labels == largest).astype(np.uint8)
        return m.astype(np.float32)
    except Exception:
        fb = np.zeros((h, w), np.float32)
        fb[int(h * 0.2): int(h * 0.6), int(w * 0.3): int(w * 0.7)] = 1.0
        return fb
