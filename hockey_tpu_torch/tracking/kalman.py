"""Batched Kalman filter for the host tracker: the port's numpy copy of
hockey_tpu/tracking/kalman.py (`BatchKalmanXYAH`, `xyxy_to_xyah`,
`xyah_to_xyxy`).

`BatchKalmanXYAH` is the ByteTrack/SORT-lineage track filter: 8-state
(cx, cy, aspect, h, + velocities), constant velocity, height-relative
process/measurement noise, vectorized over all tracks at once: means
(N, 8), covariances (N, 8, 8), one einsum per predict/update. The device
tracker (tracking/device_tracker.py) has the same filter in torch.
"""

from __future__ import annotations

import numpy as np

# DeepSORT/ByteTrack canonical noise weights.
_STD_POS = 1.0 / 20.0
_STD_VEL = 1.0 / 160.0


class BatchKalmanXYAH:
    """Vectorized constant-velocity KF over N tracks in xyah space."""

    def __init__(self):
        self.F = np.eye(8, dtype=np.float32)
        self.F[:4, 4:] = np.eye(4, dtype=np.float32)  # dt = 1 frame
        self.H = np.eye(4, 8, dtype=np.float32)

    def initiate(self, xyah: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(M, 4) measurements -> (means (M, 8), covs (M, 8, 8))."""
        m = xyah.shape[0]
        mean = np.concatenate([xyah, np.zeros_like(xyah)], axis=1).astype(np.float32)
        h = xyah[:, 3:4]
        std = np.concatenate(
            [
                2 * _STD_POS * h, 2 * _STD_POS * h,
                np.full_like(h, 1e-2), 2 * _STD_POS * h,
                10 * _STD_VEL * h, 10 * _STD_VEL * h,
                np.full_like(h, 1e-5), 10 * _STD_VEL * h,
            ],
            axis=1,
        )
        cov = np.zeros((m, 8, 8), np.float32)
        idx = np.arange(8)
        cov[:, idx, idx] = std ** 2
        return mean, cov

    def _motion_cov(self, mean: np.ndarray) -> np.ndarray:
        h = mean[:, 3:4]
        std = np.concatenate(
            [
                _STD_POS * h, _STD_POS * h, np.full_like(h, 1e-2), _STD_POS * h,
                _STD_VEL * h, _STD_VEL * h, np.full_like(h, 1e-5), _STD_VEL * h,
            ],
            axis=1,
        )
        q = np.zeros((mean.shape[0], 8, 8), np.float32)
        idx = np.arange(8)
        q[:, idx, idx] = std ** 2
        return q

    def predict(self, mean: np.ndarray, cov: np.ndarray):
        """In-batch predict: x' = Fx, P' = FPF^T + Q."""
        if mean.shape[0] == 0:
            return mean, cov
        q = self._motion_cov(mean)
        mean = mean @ self.F.T
        cov = self.F @ cov @ self.F.T + q
        return mean.astype(np.float32), cov.astype(np.float32)

    def update(self, mean: np.ndarray, cov: np.ndarray, xyah: np.ndarray):
        """Batched measurement update with per-track gain."""
        if mean.shape[0] == 0:
            return mean, cov
        h = mean[:, 3:4]
        std = np.concatenate(
            [_STD_POS * h, _STD_POS * h, np.full_like(h, 1e-1), _STD_POS * h],
            axis=1,
        )
        r = np.zeros((mean.shape[0], 4, 4), np.float32)
        idx = np.arange(4)
        r[:, idx, idx] = std ** 2

        # S = HPH^T + R ; K = PH^T S^-1
        phT = cov[:, :, :4]                     # P H^T (H selects first 4)
        s = cov[:, :4, :4] + r
        k = np.linalg.solve(
            s.transpose(0, 2, 1), phT.transpose(0, 2, 1)
        ).transpose(0, 2, 1)                    # (N, 8, 4)
        innov = xyah - mean[:, :4]
        mean = mean + np.einsum("nij,nj->ni", k, innov)
        cov = cov - np.einsum("nij,njk->nik", k, cov[:, :4, :])  # P - K(HP)
        return mean.astype(np.float32), cov.astype(np.float32)


def xyxy_to_xyah(boxes: np.ndarray) -> np.ndarray:
    """(N, 4) xyxy -> (cx, cy, aspect=w/h, h)."""
    w = boxes[:, 2] - boxes[:, 0]
    h = np.maximum(boxes[:, 3] - boxes[:, 1], 1e-6)
    cx = boxes[:, 0] + w / 2
    cy = boxes[:, 1] + h / 2
    return np.stack([cx, cy, w / h, h], axis=1).astype(np.float32)


def xyah_to_xyxy(xyah: np.ndarray) -> np.ndarray:
    cx, cy, a, h = xyah[:, 0], xyah[:, 1], xyah[:, 2], xyah[:, 3]
    w = a * h
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1).astype(np.float32)
