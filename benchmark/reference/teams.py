"""The plain reference of the team branch and of the team fit: frozen
copies of the program's colour conversions, jersey masks and 4-dim
segmentation features, its per-box bilinear crop sampling, its k-means
and its majority vote, in plain PyTorch and NumPy on the CPU in float32
(float64 in k-means).

`team_features` works the fused step's team branch out again with no
interpolation matrices: the frames are downscaled by F.interpolate and
each box is sampled by gathering its four neighbours. `fit_centres` works
the one-time team fit out again from host crops of the reference's own
detections. Nothing here imports the program.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

# crops of every team classifier, the fused branch's downscale factor, and
# the fit's limits: at most FIT_CROPS crops, each with more than
# FIT_MASK_PX mask pixels
CROP_H, CROP_W = 128, 64
TEAM_DS = 4
FIT_CROPS, FIT_MASK_PX = 50, 500


def bgr_to_hsv(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR [0, 255] -> (..., 3) HSV with OpenCV 8-bit ranges."""
    x = bgr.float()
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    c = v - mn
    s = torch.where(v > 0, c / torch.clamp(v, min=1e-9) * 255.0, 0.0)
    # hue in degrees / 2 (OpenCV packs 0-360 into 0-180)
    safe_c = torch.clamp(c, min=1e-9)
    hr = (g - b) / safe_c
    hg = 2.0 + (b - r) / safe_c
    hb = 4.0 + (r - g) / safe_c
    hdeg = torch.where(v == r, hr, torch.where(v == g, hg, hb)) * 60.0
    hdeg = torch.where(hdeg < 0, hdeg + 360.0, hdeg)
    h = torch.round(torch.where(c > 0, hdeg / 2.0, 0.0))
    h = torch.where(h >= 180.0, h - 180.0, h)  # 180 wraps to 0, as in cv2
    return torch.stack([h, torch.round(s), v], dim=-1)


def _srgb_to_linear(u: torch.Tensor) -> torch.Tensor:
    return torch.where(u <= 0.04045, u / 12.92, ((u + 0.055) / 1.055) ** 2.4)


def _cbrt(t: torch.Tensor) -> torch.Tensor:
    """Cube root of t > 0 (torch has no cbrt; the callers select this
    branch only where t > 0.008856). It can differ from jnp.cbrt by an
    ULP, which can flip a value at a .5 rounding boundary by 1."""
    return torch.clamp(t, min=0.0) ** (1.0 / 3.0)


def bgr_to_lab(bgr: torch.Tensor) -> torch.Tensor:
    """(..., 3) BGR [0, 255] -> (..., 3) LAB with OpenCV 8-bit scaling."""
    x = bgr.float() / 255.0
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    rl, gl, bl = _srgb_to_linear(r), _srgb_to_linear(g), _srgb_to_linear(b)
    # sRGB D65 -> XYZ, normalised by the D65 white point
    xn = (0.412453 * rl + 0.357580 * gl + 0.180423 * bl) / 0.950456
    yn = 0.212671 * rl + 0.715160 * gl + 0.072169 * bl
    zn = (0.019334 * rl + 0.119193 * gl + 0.950227 * bl) / 1.088754

    def f(t):
        return torch.where(t > 0.008856, _cbrt(t), 7.787 * t + 16.0 / 116.0)

    fx, fy, fz = f(xn), f(yn), f(zn)
    lum = torch.where(yn > 0.008856, 116.0 * _cbrt(yn) - 16.0, 903.3 * yn)
    a = 500.0 * (fx - fy) + 128.0
    bb = 200.0 * (fy - fz) + 128.0
    return torch.round(torch.stack([lum * 255.0 / 100.0, a, bb], dim=-1))


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


def _sq_dist(x: np.ndarray, centers: np.ndarray) -> np.ndarray:
    """(n, k) squared Euclidean distances."""
    return ((x[:, None, :] - centers[None, :, :]) ** 2).sum(-1)


class KMeans:
    """fit / fit_predict / predict with `cluster_centers_`, `labels_` and
    `inertia_`, in float64; `cluster_centers_` may be replaced after the
    fit (the classifier reorders the clusters)."""

    def __init__(self, n_clusters: int = 2, random_state: int = 42,
                 n_init: int = 10, max_iter: int = 300, tol: float = 1e-4):
        self.n_clusters, self.random_state = n_clusters, random_state
        self.n_init, self.max_iter, self.tol = n_init, max_iter, tol
        self.cluster_centers_ = None
        self.labels_ = None
        self.inertia_ = None

    def _seed(self, x: np.ndarray, rng: np.random.Generator) -> np.ndarray:
        """Greedy k-means++: each new centre is the best of 2 + log(k)
        candidates drawn in proportion to the squared distance."""
        n, k = len(x), self.n_clusters
        trials = 2 + int(np.log(k))
        centers = [x[rng.integers(n)]]
        closest = _sq_dist(x, np.asarray(centers))[:, 0]
        for _ in range(1, k):
            total = closest.sum()
            if total <= 0:  # every point sits on a centre
                cand = rng.integers(n, size=trials)
            else:
                cand = np.searchsorted(np.cumsum(closest),
                                       rng.uniform(size=trials) * total)
                cand = np.minimum(cand, n - 1)
            pot = np.minimum(closest[None], _sq_dist(x, x[cand]).T)
            best = int(np.argmin(pot.sum(1)))
            centers.append(x[cand[best]])
            closest = pot[best]
        return np.asarray(centers)

    def _lloyd(self, x: np.ndarray, centers: np.ndarray, tol: float):
        for _ in range(self.max_iter):
            labels = np.argmin(_sq_dist(x, centers), axis=1)
            new = centers.copy()
            for c in range(self.n_clusters):
                if (labels == c).any():
                    new[c] = x[labels == c].mean(0)
            shift = ((new - centers) ** 2).sum()
            centers = new
            if shift <= tol:
                break
        d = _sq_dist(x, centers)
        labels = np.argmin(d, axis=1)
        return centers, labels, float(d[np.arange(len(x)), labels].sum())

    def fit(self, x) -> "KMeans":
        x = np.asarray(x, np.float64)
        if len(x) < self.n_clusters:
            raise ValueError(f"n_samples={len(x)} should be >= "
                             f"n_clusters={self.n_clusters}")
        tol = self.tol * float(np.mean(np.var(x, axis=0)))
        rng = np.random.default_rng(self.random_state)
        best = None
        for _ in range(self.n_init):
            run = self._lloyd(x, self._seed(x, rng), tol)
            if best is None or run[2] < best[2]:
                best = run
        self.cluster_centers_, self.labels_, self.inertia_ = best
        return self

    def fit_predict(self, x) -> np.ndarray:
        return self.fit(x).labels_

    def predict(self, x) -> np.ndarray:
        """Index of the nearest centre of each row of x."""
        x = np.asarray(x, np.float64).reshape(-1, self.cluster_centers_.shape[1])
        return np.argmin(_sq_dist(x, np.asarray(self.cluster_centers_)), axis=1)


def team_features(frames: torch.Tensor, boxes: torch.Tensor,
                  dtype=torch.float32) -> torch.Tensor:
    """frames (B, H, W, 3) uint8 and boxes (B, D, 4) in frame pixels ->
    (B, D, 4) f32: each box / TEAM_DS sampled to 128x64 from its frame
    downscaled by TEAM_DS (bilinear, half-pixel centres), masked by the
    colour prior and reduced to [white_ratio, dominant_hue, saturation,
    brightness]. A lower `dtype` rounds the downscaled frames and the
    crops to it (the control)."""
    b, h, w, _ = frames.shape
    small = F.interpolate(frames.permute(0, 3, 1, 2).float(),
                          size=(h // TEAM_DS, w // TEAM_DS), mode="bilinear",
                          align_corners=False).permute(0, 2, 3, 1)
    small = small.to(dtype).float()
    out = []
    for i in range(b):
        crops = crop_and_resize(small[i], boxes[i].float() / TEAM_DS,
                                (CROP_H, CROP_W)).to(dtype).float()
        out.append(segmentation_features(crops, color_prior_masks(crops)))
    return torch.stack(out)


def host_crops(frame: np.ndarray, boxes: np.ndarray) -> List[np.ndarray]:
    """The frame's views under xyxy boxes, corners cut to ints and clipped."""
    h, w = frame.shape[:2]
    return [frame[max(int(b[1]), 0):min(int(b[3]), h),
                  max(int(b[0]), 0):min(int(b[2]), w)]
            for b in np.asarray(boxes).reshape(-1, 4)]


def standardize_crops(crops: Sequence[np.ndarray]) -> np.ndarray:
    """Variable-size uint8 crops -> (N, 128, 64, 3) f32, bilinear with
    half-pixel centres and rounded back to integers, as cv2.resize."""
    out = np.zeros((len(crops), CROP_H, CROP_W, 3), np.float32)
    for i, c in enumerate(crops):
        if c.size == 0:
            continue
        x = torch.from_numpy(np.asarray(c, np.float32)).permute(2, 0, 1)[None]
        y = F.interpolate(x, size=(CROP_H, CROP_W), mode="bilinear",
                          align_corners=False)[0].permute(1, 2, 0).numpy()
        out[i] = np.clip(np.rint(y), 0, 255)
    return out


def fit_centres(crops: List[np.ndarray]) -> np.ndarray:
    """The segmentation classifier's fit: (2, 4) float64 k-means centres of
    the first FIT_CROPS crops' features (those with more than FIT_MASK_PX
    mask pixels), team 0 the cluster of the higher white ratio."""
    x = torch.from_numpy(standardize_crops(list(crops)[:FIT_CROPS]))
    masks = color_prior_masks(x)
    feats = segmentation_features(x, masks).numpy()
    feats = feats[masks.reshape(len(x), -1).sum(1).numpy() > FIT_MASK_PX]
    km = KMeans(n_clusters=2, random_state=42, n_init=10)
    labels = km.fit_predict(feats)
    white = [float(feats[labels == c, 0].mean()) if (labels == c).any()
             else 0.0 for c in (0, 1)]
    centres = km.cluster_centers_
    return centres[[1, 0]] if white[1] > white[0] else centres


class MajorityVote:
    """Per-track vote over the last `window` teams, once a track has
    `min_votes` of them."""

    def __init__(self, window: int = 10, min_votes: int = 3):
        self.window, self.min_votes = window, min_votes
        self.history: Dict[int, List[int]] = defaultdict(list)

    def update(self, tracker_ids: np.ndarray, teams: np.ndarray) -> np.ndarray:
        teams = np.asarray(teams).copy()
        for i, tid in enumerate(tracker_ids):
            h = self.history[int(tid)]
            h.append(int(teams[i]))
            del h[:max(len(h) - self.window, 0)]
            if len(h) >= self.min_votes:
                teams[i] = np.argmax(np.bincount(h))
        return teams
