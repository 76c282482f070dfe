"""Colour-space conversions with OpenCV's 8-bit conventions: port of
hockey_tpu/ops/color.py.

- HSV: H in [0, 180), S and V in [0, 255];
- LAB: L scaled to [0, 255], a and b offset by 128 (D65, the sRGB curve
  linearised as OpenCV's 8-bit BGR2Lab does).

Inputs are BGR in [0, 255], any float or integer dtype; outputs are f32.
Both functions are elementwise over any leading dims. H, S and LAB are
rounded half to even onto the uint8 grid, as in the JAX package; V is not
rounded there and is not here.
"""

from __future__ import annotations

import torch


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
