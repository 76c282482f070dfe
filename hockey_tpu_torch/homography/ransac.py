"""RANSAC homography estimation on the host: the port's own copy of
hockey_tpu/homography/ransac.py (numpy only; `dlt_homography`, `project`,
`HomographyQuality`, the batched 4-point DLT, `ransac_homography`,
`fit_homography_tiered`, `homography_from_keypoints`).

The pipeline: keep the stable keypoint subset, map image keypoints to
rink feet through the keypoint table, fit 4-point DLTs to RANSAC samples
(one batched SVD over all samples, drawn from a seeded
`np.random.default_rng`), refit on the best inlier set, and validate by
inlier ratio and mean reprojection error. Being the same numpy code on
the same inputs, its results equal the JAX package's.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..rinkmap.dimensions import (
    STABLE_KEYPOINT_IDS,
    default_keypoint_positions,
)


def dlt_homography(src: np.ndarray, dst: np.ndarray) -> Optional[np.ndarray]:
    """Direct linear transform: >= 4 point pairs -> 3x3 H with src -> dst.
    Points are Hartley-normalized for conditioning."""
    n = len(src)
    if n < 4:
        return None

    def normalize(pts):
        c = pts.mean(axis=0)
        d = np.sqrt(((pts - c) ** 2).sum(axis=1)).mean()
        s = np.sqrt(2.0) / max(d, 1e-9)
        t = np.asarray([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]], np.float64)
        return (pts - c) * s, t

    sn, ts = normalize(np.asarray(src, np.float64))
    dn, td = normalize(np.asarray(dst, np.float64))

    a = np.zeros((2 * n, 9), np.float64)
    for i in range(n):
        x, y = sn[i]
        u, v = dn[i]
        a[2 * i] = [-x, -y, -1, 0, 0, 0, u * x, u * y, u]
        a[2 * i + 1] = [0, 0, 0, -x, -y, -1, v * x, v * y, v]
    try:
        _, _, vt = np.linalg.svd(a)
    except np.linalg.LinAlgError:
        return None
    h = vt[-1].reshape(3, 3)
    if abs(h[2, 2]) < 1e-12:
        return None
    h = np.linalg.inv(td) @ h @ ts
    return (h / h[2, 2]).astype(np.float64)


def project(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    """Apply homography to (N, 2) points."""
    pts = np.asarray(pts, np.float64)
    ones = np.ones((len(pts), 1))
    p = np.hstack([pts, ones]) @ h.T
    return (p[:, :2] / np.maximum(np.abs(p[:, 2:3]), 1e-12) * np.sign(p[:, 2:3]))


@dataclasses.dataclass
class HomographyQuality:
    inlier_ratio: float
    mean_reprojection_error: float
    n_points: int

    def is_valid(self, min_inlier_ratio: float = 0.5,
                 max_error: float = 3.0, min_points: int = 6) -> bool:
        return (self.n_points >= min_points
                and self.inlier_ratio >= min_inlier_ratio
                and self.mean_reprojection_error <= max_error)


def _batched_dlt4(src4: np.ndarray, dst4: np.ndarray) -> np.ndarray:
    """Vectorized exact 4-point DLT: (S, 4, 2) x (S, 4, 2) -> (S, 3, 3)
    homographies (NaN rows for degenerate samples). One batched SVD over
    all RANSAC samples instead of a Python loop."""
    s = src4.shape[0]
    a = np.zeros((s, 8, 9), np.float64)
    x, y = src4[..., 0], src4[..., 1]
    u, v = dst4[..., 0], dst4[..., 1]
    one = np.ones_like(x)
    a[:, 0::2, 0] = -x
    a[:, 0::2, 1] = -y
    a[:, 0::2, 2] = -one
    a[:, 0::2, 6] = u * x
    a[:, 0::2, 7] = u * y
    a[:, 0::2, 8] = u
    a[:, 1::2, 3] = -x
    a[:, 1::2, 4] = -y
    a[:, 1::2, 5] = -one
    a[:, 1::2, 6] = v * x
    a[:, 1::2, 7] = v * y
    a[:, 1::2, 8] = v
    try:
        _, _, vt = np.linalg.svd(a)
    except np.linalg.LinAlgError:
        return np.full((s, 3, 3), np.nan)
    h = vt[:, -1, :].reshape(s, 3, 3)
    scale = h[:, 2:3, 2:3]
    with np.errstate(divide="ignore", invalid="ignore"):
        h = np.where(np.abs(scale) > 1e-12, h / scale, np.nan)
    return h


def ransac_homography(
    src: np.ndarray,
    dst: np.ndarray,
    iterations: int = 200,
    threshold: float = 3.0,
    seed: int = 0,
) -> Tuple[Optional[np.ndarray], Optional[HomographyQuality]]:
    """RANSAC over 4-point DLT fits; refit on the final inlier set.
    `threshold` is the reprojection-error gate in dst units. All sample
    fits run as one batched SVD + one batched projection (this executes
    per frame in the 2D-map path, so the Python-loop version's ~80 ms was
    the hot spot of that stage)."""
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    if n < 4:
        return None, None

    rng = np.random.default_rng(seed)
    idx = np.stack([rng.choice(n, 4, replace=False) for _ in range(iterations)])
    hs = _batched_dlt4(src[idx], dst[idx])                       # (S, 3, 3)
    ok = np.isfinite(hs).all(axis=(1, 2))
    # batched projection of all points under all candidate homographies
    pts_h = np.concatenate([src, np.ones((n, 1))], axis=1)        # (N, 3)
    proj = np.einsum("sij,nj->sni", hs, pts_h)                    # (S, N, 3)
    with np.errstate(divide="ignore", invalid="ignore"):
        w = proj[..., 2:3]
        proj = proj[..., :2] / np.where(np.abs(w) > 1e-12, w, np.nan)
    err = np.linalg.norm(proj - dst[None], axis=2)                # (S, N)
    inl = (err < threshold) & ok[:, None] & np.isfinite(err)
    counts = inl.sum(axis=1)
    best = int(np.argmax(counts))
    best_count = int(counts[best])
    best_inliers = inl[best]
    if best_count < 4:
        return None, None

    h = dlt_homography(src[best_inliers], dst[best_inliers])
    if h is None:
        return None, None
    err = np.linalg.norm(project(h, src) - dst, axis=1)
    inliers = err < threshold
    quality = HomographyQuality(
        inlier_ratio=float(inliers.mean()),
        mean_reprojection_error=float(err[inliers].mean()) if inliers.any() else np.inf,
        n_points=n,
    )
    return h, quality


def fit_homography_tiered(
    src: np.ndarray,
    dst: np.ndarray,
    fine_threshold: float = 3.0,
    coarse_threshold: float = 12.0,
    seed: int = 0,
) -> Tuple[Optional[np.ndarray], Optional[HomographyQuality], Optional[str]]:
    """Two-tier RANSAC fit: try the strict gate first ('fine',
    reprojection <= `fine_threshold` ft), then fall back to a provisional
    'coarse' fit gated at `coarse_threshold` ft.

    Rationale (COMPAT #25): the documented pipeline
    (the reference README.md:74-81) validates homographies before use,
    but an all-or-nothing 3-ft gate turns the 2D map OFF entirely whenever
    keypoint quality is degraded (imperfect model, motion blur, partial
    views). A clearly-flagged coarse calibration keeps the capability
    alive at reduced accuracy; fine fits always take precedence
    (HomographyStabilizer tier rules). Pass coarse_threshold=0 to disable
    the fallback."""
    h, q = ransac_homography(src, dst, threshold=fine_threshold, seed=seed)
    if h is not None and q.is_valid(max_error=fine_threshold, min_points=4):
        return h, q, "fine"
    if coarse_threshold and coarse_threshold > fine_threshold:
        h, q = ransac_homography(src, dst, threshold=coarse_threshold,
                                 seed=seed)
        if h is not None and q.is_valid(max_error=coarse_threshold,
                                        min_points=4):
            return h, q, "coarse"
    return None, q, None


def homography_from_keypoints(
    keypoints: List,
    keypoint_table: Optional[np.ndarray] = None,
    min_confidence: float = 0.5,
    stable_only: bool = True,
    validate: bool = True,
) -> Optional[np.ndarray]:
    """Detected RinkKeypoints -> image->rink homography (or None).

    Replaces the reference's always-None stub with the documented pipeline
    (stable-subset filter, correspondence table, RANSAC, validation)."""
    table = keypoint_table if keypoint_table is not None else default_keypoint_positions()
    stable = set(STABLE_KEYPOINT_IDS)
    src, dst = [], []
    for kp in keypoints:
        if kp.confidence < min_confidence:
            continue
        if stable_only and kp.id not in stable:
            continue
        src.append(kp.position)
        dst.append(table[kp.id])
    if len(src) < 4:
        return None
    h, quality = ransac_homography(np.asarray(src), np.asarray(dst))
    if h is None:
        return None
    if validate and not quality.is_valid():
        return None
    return h
