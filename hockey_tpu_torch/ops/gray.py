"""OpenCV's uint8 BGR-to-gray and INTER_LINEAR resize in numpy, bit for
bit, for the machines without OpenCV. Two users: the jersey-number crops
(`ocr/digits.py:normalize_crop`, 48x48) and the calibrator's camera-motion
probe (`homography/calibrator.py`: 30x shrinks to 36x64).
Both are held to `cv2.cvtColor` and `cv2.resize` in the tests at those
sizes and random ones.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

# OpenCV's fixed-point BGR -> gray for uint8 (15-bit weights of B, G, R)
# and its 11-bit bilinear weights
_GRAY_BGR, _GRAY_SHIFT = (3735, 19235, 9798), 15
_COEF_SCALE = 2048


def bgr_to_gray(img: np.ndarray) -> np.ndarray:
    """(h, w, 3) uint8 BGR -> (h, w) uint8, as cv2.COLOR_BGR2GRAY rounds."""
    x = img.astype(np.int32)
    cb, cg, cr = _GRAY_BGR
    g = (x[..., 0] * cb + x[..., 1] * cg + x[..., 2] * cr
         + (1 << (_GRAY_SHIFT - 1))) >> _GRAY_SHIFT
    return g.astype(np.uint8)


def _taps(src: int, dst: int, clamp_weight: bool):
    """(first source index, second, weight of first, weight of second) of
    each of `dst` samples over `src` pixels: half-pixel centres, weights
    rounded to 1/2048. Where a sample falls past an edge, the columns
    (`clamp_weight`) move it onto the edge pixel; the rows keep its weight
    and read the edge row twice, as OpenCV does."""
    scale = np.float64(1.0) / (np.float64(dst) / np.float64(src))
    f = ((np.arange(dst) + 0.5) * scale - 0.5).astype(np.float32)
    i = np.floor(f).astype(np.int64)
    f = (f - i.astype(np.float32)).astype(np.float32)
    if clamp_weight:
        out = (i < 0) | (i >= src - 1)
        f[out] = 0.0
        i = np.clip(i, 0, src - 1)
    w1 = np.rint(f * np.float32(_COEF_SCALE)).astype(np.int64)
    w0 = np.rint((np.float32(1.0) - f) * np.float32(_COEF_SCALE)).astype(np.int64)
    return np.clip(i, 0, src - 1), np.clip(i + 1, 0, src - 1), w0, w1


def gray_resize(img: np.ndarray, out_hw: Tuple[int, int]) -> np.ndarray:
    """(h, w, 3) uint8 BGR -> (oh, ow) uint8, as cv2.resize(cv2.cvtColor(
    img, COLOR_BGR2GRAY), (ow, oh)) gives it with INTER_LINEAR: columns
    then rows in fixed point, the rows' products at 16-bit grade as
    OpenCV's vector path takes them (an exact 2x shrink, which OpenCV runs
    as INTER_AREA, comes out the same). Only the rows and columns that the
    resize reads are converted to gray: a 1080p frame's 36x64 probe needs
    72 rows and 128 columns of its 2M pixels."""
    oh, ow = out_hw
    c0, c1, a0, a1 = _taps(img.shape[1], ow, True)
    r0, r1, b0, b1 = _taps(img.shape[0], oh, False)
    rows, ri = np.unique(np.concatenate([r0, r1]), return_inverse=True)
    cols, ci = np.unique(np.concatenate([c0, c1]), return_inverse=True)
    x = bgr_to_gray(img[np.ix_(rows, cols)]).astype(np.int64)
    horiz = x[:, ci[:ow]] * a0 + x[:, ci[ow:]] * a1
    v = ((((horiz[ri[:oh]] >> 4) * b0[:, None]) >> 16)
         + (((horiz[ri[oh:]] >> 4) * b1[:, None]) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)
