"""Corruption-robustness suite: severity-parameterised image corruptions.
Port of hockey_tpu/train/corruptions.py.

Each corruption maps (img uint8 BGR, severity 1..5) -> uint8 BGR of the
same shape, by the JAX package's fixed severity tables, so curves compare
across runs and with the reference's (scripts/torch_robustness.py).
Labels are unchanged: every corruption preserves geometry. `contrast`,
`gamma` and `gaussian_noise` are numpy (the noise seeded from the image,
so it is reproducible bit for bit); `motion_blur`, `jpeg` and `pixelate`
import `cv2` inside.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np


def motion_blur(img: np.ndarray, severity: int) -> np.ndarray:
    import cv2

    k = [3, 5, 9, 13, 17][severity - 1]
    kern = np.zeros((k, k), np.float32)
    # fixed 20-degree streak: deterministic given (image, severity)
    ang = np.radians(20.0)
    cv2.line(kern, (0, int((k - 1) * (0.5 - 0.5 * np.sin(ang)))),
             (k - 1, int((k - 1) * (0.5 + 0.5 * np.sin(ang)))), 1.0, 1)
    return cv2.filter2D(img, -1, kern / max(kern.sum(), 1))


def jpeg(img: np.ndarray, severity: int) -> np.ndarray:
    import cv2

    q = [90, 70, 50, 40, 30][severity - 1]
    ok, enc = cv2.imencode(".jpg", img, [int(cv2.IMWRITE_JPEG_QUALITY), q])
    return cv2.imdecode(enc, cv2.IMREAD_COLOR) if ok else img


def contrast(img: np.ndarray, severity: int) -> np.ndarray:
    c = [0.8, 0.65, 0.5, 0.4, 0.3][severity - 1]
    mean = img.astype(np.float32).mean(axis=(0, 1), keepdims=True)
    return np.clip((img - mean) * c + mean, 0, 255).astype(np.uint8)


def gamma(img: np.ndarray, severity: int) -> np.ndarray:
    g = [1.25, 1.5, 1.8, 2.2, 2.6][severity - 1]
    x = img.astype(np.float32) / 255.0
    return np.clip((x ** g) * 255.0, 0, 255).astype(np.uint8)


def gaussian_noise(img: np.ndarray, severity: int) -> np.ndarray:
    sigma = [4, 8, 14, 22, 32][severity - 1]
    rng = np.random.default_rng(int(img[::97, ::97].sum()) + severity)
    out = img.astype(np.float32) + rng.normal(0, sigma, img.shape)
    return np.clip(out, 0, 255).astype(np.uint8)


def pixelate(img: np.ndarray, severity: int) -> np.ndarray:
    """Downscale-upscale resampling loss."""
    import cv2

    f = [0.75, 0.6, 0.5, 0.4, 0.3][severity - 1]
    h, w = img.shape[:2]
    small = cv2.resize(img, (max(int(w * f), 8), max(int(h * f), 8)),
                       interpolation=cv2.INTER_AREA)
    return cv2.resize(small, (w, h), interpolation=cv2.INTER_LINEAR)


CORRUPTIONS: Dict[str, Callable[[np.ndarray, int], np.ndarray]] = {
    "motion_blur": motion_blur,
    "jpeg": jpeg,
    "contrast": contrast,
    "gamma": gamma,
    "gaussian_noise": gaussian_noise,
    "pixelate": pixelate,
}

# the corruptions that need cv2: on a machine without it they are read
# from pools rendered elsewhere (scripts/render_val_set.py --corrupt)
CV2_CORRUPTIONS = ("motion_blur", "jpeg", "pixelate")


class CorruptedDataset:
    """Wrap a detection dataset, corrupting images on access; labels and
    interface pass through (works with evaluate_detector)."""

    def __init__(self, base, name: str, severity: int):
        if name not in CORRUPTIONS or not 1 <= severity <= 5:
            raise ValueError(f"unknown corruption {name!r} or severity {severity}")
        self.base = base
        self.fn = CORRUPTIONS[name]
        self.severity = severity

    def __len__(self) -> int:
        return len(self.base)

    def load(self, idx: int):
        item = dict(self.base.load(idx))
        img = (item["images"] * 255).astype(np.uint8)
        item["images"] = self.fn(img, self.severity).astype(np.float32) / 255.0
        return item
