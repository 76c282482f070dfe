"""Generator B: an independent synthetic broadcast renderer for
out-of-distribution evaluation.

Port of hockey_tpu/train/scenes_b.py, all of it: the pinhole `_Camera`,
the background, the ellipse-and-capsule bodies, `render_scene_b`,
`render_scene_sequence_b`, `HardSyntheticHockeyDatasetB` and
`SyntheticRinkDatasetB`. It shares nothing with generator A
(train/scenes.py) but the label format and the rink's keypoint table
(rinkmap/dimensions.py):

- Camera: a 3D pinhole model (position, look-at, focal length; the
  plane-induced homography H = K [r1 r2 t]); a player's pixel height
  comes from projecting the 3D head point.
- Bodies: rotated ellipses and thick-line capsules, leg pads for
  goalies, another font set for numbers.
- Environment: markings drawn by projecting dense parametric curves;
  the crowd as blurred blobs behind a board polyline; text ads; skate
  scuffs and a radial ice shade.
- Degradation: vignette, colour cast, signal-dependent shot noise, row
  banding, defocus blur and a downscale-upscale resampling.

The val CLI's `--dataset hard-b`, `hard-puck-b` and `rink-b` score a
model on it: no pixel of it was in the detectors' training data. numpy
with `cv2` imported inside each function; a seed renders what the JAX
package renders, bit for bit (tests/test_torch_scenes_b.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

PLAYER_H_FT = 6.1  # skater incl. skates + helmet


# ---------------------------------------------------------------------------
# Pinhole camera
# ---------------------------------------------------------------------------

class _Camera:
    """World frame: rink plane z=0, x along length, y across width, z up.
    Camera sits behind the y<0 boards, elevated, looking at the rink."""

    def __init__(self, rng: np.random.Generator, s: int, rink,
                 zoom_range=(0.9, 2.8), dist_range=(40.0, 120.0),
                 height_range=(25.0, 90.0), fit_rink: bool = False):
        L, W = rink.length, rink.width
        self.s = s
        tx = rng.uniform(0.2 * L, 0.8 * L)
        ty = rng.uniform(0.25 * W, 0.75 * W)
        cx = tx + rng.uniform(-0.25, 0.25) * L
        cy = -rng.uniform(*dist_range)          # behind the near boards
        cz = rng.uniform(*height_range)         # elevation (ft)
        self.C = np.asarray([cx, cy, cz], np.float64)
        fwd = np.asarray([tx, ty, 0.0]) - self.C
        fwd /= np.linalg.norm(fwd)
        up = np.asarray([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)             # image +v axis
        self.R = np.stack([right, down, fwd])   # world -> camera rows
        if fit_rink:
            # anamorphic fit: fx/fy chosen independently so the whole
            # sheet fills the frame both ways (the pose training
            # distribution maps the rink corners to a frame-filling
            # trapezoid; an isotropic camera can't — 200 ft of length
            # caps the 85 ft width at ~40% of frame height)
            corners = np.asarray([[0, 0, 0], [L, 0, 0], [0, W, 0],
                                  [L, W, 0]], np.float64)
            pc = (corners - self.C) @ self.R.T
            norm = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-6)
            fx = 0.48 * s / max(float(np.abs(norm[:, 0]).max()), 1e-6) \
                * rng.uniform(0.9, 1.05)
            fy = 0.44 * s / max(float(np.abs(norm[:, 1]).max()), 1e-6) \
                * rng.uniform(0.8, 1.0)
        else:
            fx = fy = s * rng.uniform(*zoom_range)
        self.K = np.asarray([[fx, 0.0, s / 2.0],
                             [0.0, fy, s / 2.0],
                             [0.0, 0.0, 1.0]])
        # plane z=0 homography: [x, y, 1] -> image
        He = np.stack([self.R[:, 0], self.R[:, 1],
                       -self.R @ self.C], axis=1)
        self.H = self.K @ He
        self.Hinv = np.linalg.inv(self.H)

    def project_plane(self, pts: np.ndarray) -> np.ndarray:
        """(N, 2) rink-plane points -> (N, 2) pixels."""
        p = np.concatenate([pts, np.ones((len(pts), 1))], axis=1) @ self.H.T
        return p[:, :2] / np.maximum(p[:, 2:3], 1e-9)

    def project_3d(self, pts: np.ndarray) -> np.ndarray:
        """(N, 3) world points -> (N, 2) pixels."""
        pc = (pts - self.C) @ self.R.T
        uv = pc[:, :2] / np.maximum(pc[:, 2:3], 1e-9)
        return uv * np.asarray([self.K[0, 0], self.K[1, 1]]) + self.s / 2.0

    def unproject(self, uv: np.ndarray) -> np.ndarray:
        """(N, 2) pixels -> (N, 2) rink-plane points (z=0)."""
        p = np.concatenate([uv, np.ones((len(uv), 1))], axis=1) @ self.Hinv.T
        return p[:, :2] / np.maximum(np.abs(p[:, 2:3]), 1e-9) * np.sign(
            p[:, 2:3] + 1e-12)

    def standing_extent(self, x: float, y: float,
                        h_ft: float = PLAYER_H_FT
                        ) -> Tuple[np.ndarray, float, bool]:
        """Foot pixel, pixel height, and in-front-of-camera flag for an
        upright object at rink (x, y)."""
        both = np.asarray([[x, y, 0.0], [x, y, h_ft]])
        pc = (both - self.C) @ self.R.T
        if pc[0, 2] <= 1.0:  # behind or at the camera
            return np.zeros(2), 0.0, False
        px = self.project_3d(both)
        return px[0], float(np.linalg.norm(px[1] - px[0])), True


# ---------------------------------------------------------------------------
# Environment
# ---------------------------------------------------------------------------

def _curve(cam: _Camera, pts_xy: np.ndarray) -> np.ndarray:
    """Rink-plane polyline -> int32 pixel polyline (only points in front)."""
    p = cam.project_plane(np.asarray(pts_xy, np.float64))
    return p.astype(np.int32)


def _draw_markings(img, cam: _Camera, rink, rng) -> None:
    import cv2

    s = cam.s
    blue = (165, 95, 25)
    red = (55, 45, 185)
    th = max(1, int(s / 300))

    def pline(pts_xy, color, t):
        cv2.polylines(img, [_curve(cam, pts_xy)], False, color, t,
                      lineType=cv2.LINE_AA)

    L, W = rink.length, rink.width
    ys = np.linspace(0, W, 24)[:, None]
    for x, c, t in ((rink.goal_line_from_end, red, th),
                    (L - rink.goal_line_from_end, red, th),
                    (rink.blue_line_from_end, blue, 2 * th),
                    (L - rink.blue_line_from_end, blue, 2 * th),
                    (L / 2, red, 2 * th)):
        pline(np.concatenate([np.full_like(ys, x), ys], axis=1), c, t)
    ang = np.linspace(0, 2 * np.pi, 48)
    r = rink.faceoff_circle_radius
    centers = [(L / 2, W / 2)]
    for ex in (rink.goal_line_from_end + rink.endzone_spot_from_goal_line,
               L - rink.goal_line_from_end
               - rink.endzone_spot_from_goal_line):
        for ey in (W / 2 - rink.spot_offset_from_center_y,
                   W / 2 + rink.spot_offset_from_center_y):
            centers.append((ex, ey))
    for (ex, ey) in centers:
        circ = np.stack([ex + r * np.cos(ang), ey + r * np.sin(ang)], 1)
        pline(circ, red if (ex, ey) != centers[0] else blue, th)
        dot = _curve(cam, np.asarray([[ex, ey]]))[0]
        if 0 <= dot[0] < s and 0 <= dot[1] < s:
            cv2.circle(img, tuple(dot), max(th * 2, 2), red, -1,
                       lineType=cv2.LINE_AA)
    # creases: half-disc arcs at both goals
    for gx, sgn in ((rink.goal_line_from_end, 1.0),
                    (L - rink.goal_line_from_end, -1.0)):
        aa = np.linspace(-np.pi / 2, np.pi / 2, 24)
        arc = np.stack([gx + sgn * rink.crease_radius * np.cos(aa),
                        W / 2 + rink.crease_radius * np.sin(aa)], 1)
        pline(arc, red, th)


_AD_WORDS = ["KOHO", "NORTH", "ICEPRO", "BAUER+", "ZET", "ARENA",
             "TELCO", "GRIP", "HYDRA", "PUCKCO", "M-LINE", "FROST"]


def _background(rng: np.random.Generator, cam: _Camera, rink) -> np.ndarray:
    import cv2

    s = cam.s
    # --- ice: radial shade around a random lamp center + scuffs
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    lx, ly = rng.uniform(0.2, 0.8, 2) * s
    rad = np.hypot(xx - lx, yy - ly) / s
    base = rng.uniform(208, 238)
    ice = np.clip(base - rad * rng.uniform(8, 30), 0, 255)
    img = np.repeat(ice[..., None], 3, axis=2).astype(np.float32)
    img[..., 0] += rng.uniform(2, 14)       # cold cast (BGR: blue up)
    img[..., 2] -= rng.uniform(0, 8)
    img = np.clip(img, 0, 255).astype(np.uint8)
    for _ in range(int(rng.integers(4, 14))):  # skate scuff arcs
        c = (int(rng.uniform(0, s)), int(rng.uniform(0, s)))
        axes = (int(rng.uniform(0.05, 0.5) * s), int(rng.uniform(4, 40)))
        a0 = rng.uniform(0, 360)
        shade = int(rng.uniform(-14, -3))
        cv2.ellipse(img, c, axes, a0, 0, rng.uniform(30, 140),
                    (int(base) + shade,) * 3, 1, lineType=cv2.LINE_AA)

    # --- far boards polyline (y=W edge: the camera sits behind y<0, so
    # the FAR side of the sheet is y=W) with crowd above, ads on boards
    L, W = rink.length, rink.width
    xs_ft = np.linspace(-40, L + 40, 64)
    edge = cam.project_plane(np.stack([xs_ft, np.full_like(xs_ft, W)], 1))
    order = np.argsort(edge[:, 0])
    edge = edge[order]
    cols = np.arange(s, dtype=np.float32)
    edge_y = np.interp(cols, edge[:, 0], edge[:, 1],
                       left=edge[0, 1], right=edge[-1, 1])
    edge_y = np.clip(edge_y, 2, s - 2)
    board_h = float(np.clip(s * rng.uniform(0.035, 0.08), 4, s / 4))
    rows = np.arange(s, dtype=np.float32)[:, None]
    above = rows < (edge_y[None, :] - board_h)
    on_board = (~above) & (rows < edge_y[None, :])
    # crowd: blurred colored blobs
    blob = rng.integers(10, 150, (s // 16, s // 16, 3)).astype(np.uint8)
    crowd = cv2.resize(blob, (s, s), interpolation=cv2.INTER_LINEAR)
    crowd = cv2.GaussianBlur(crowd, (0, 0), rng.uniform(1.0, 3.0))
    # sparse bright "faces/shirts" speckle
    spk = rng.uniform(0, 1, (s, s)) < 0.01
    crowd[spk] = rng.integers(120, 255, (int(spk.sum()), 3))
    img[above] = crowd[above]
    # boards: pale base + ad text strip
    board_img = np.full((s, s, 3),
                        np.asarray(rng.uniform(200, 235, 3), np.uint8),
                        np.uint8)
    x = 0
    while x < s:
        wseg = int(rng.uniform(0.1, 0.3) * s)
        col = tuple(int(v) for v in rng.uniform(20, 230, 3))
        if rng.uniform() < 0.6:
            cv2.rectangle(board_img, (x, 0), (x + wseg, s), col, -1)
            word = _AD_WORDS[int(rng.integers(0, len(_AD_WORDS)))]
            fg = (245, 245, 245) if sum(col) < 360 else (15, 15, 15)
            cv2.putText(board_img, word, (x + 4, int(s * 0.55)),
                        cv2.FONT_HERSHEY_PLAIN,
                        rng.uniform(0.8, 1.6), fg, 2, cv2.LINE_AA)
        x += wseg
    img[on_board] = board_img[on_board]
    # kickplate: yellow-ish line along the edge polyline
    pts = np.stack([cols, edge_y], 1).astype(np.int32)
    cv2.polylines(img, [pts], False,
                  (int(rng.uniform(20, 60)), int(rng.uniform(150, 210)),
                   int(rng.uniform(170, 230))), max(1, s // 320),
                  lineType=cv2.LINE_AA)
    # near boards (y=0): the wall below the near ice edge, when visible
    near = cam.project_plane(np.stack([xs_ft, np.zeros_like(xs_ft)], 1))
    near = near[np.argsort(near[:, 0])]
    near_y = np.clip(np.interp(cols, near[:, 0], near[:, 1],
                               left=near[0, 1], right=near[-1, 1]),
                     0, s)
    below = rows >= near_y[None, :]
    if below.any():
        img[below] = np.asarray(rng.uniform(195, 230, 3), np.uint8)
        npts = np.stack([cols, near_y], 1).astype(np.int32)
        cv2.polylines(img, [npts], False,
                      (int(rng.uniform(20, 60)), int(rng.uniform(150, 210)),
                       int(rng.uniform(170, 230))), max(1, s // 280),
                      lineType=cv2.LINE_AA)
    # glass glints above the boards
    for _ in range(int(rng.integers(0, 6))):
        gx = int(rng.uniform(0, s))
        ey = int(np.interp(gx, cols, edge_y))
        cv2.line(img, (gx, max(ey - int(board_h) - int(s * 0.06), 0)),
                 (gx + int(rng.uniform(-6, 6)), max(ey - int(board_h), 0)),
                 (235, 235, 235), 1, lineType=cv2.LINE_AA)

    _draw_markings(img, cam, rink, rng)
    return img


# ---------------------------------------------------------------------------
# Bodies: ellipse/capsule model
# ---------------------------------------------------------------------------

def _capsule(img, p0, p1, w, color):
    import cv2

    cv2.line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
             color, max(int(w), 1), lineType=cv2.LINE_AA)


def _draw_person_b(img, foot: np.ndarray, hpx: float, jersey, pants,
                   rng: np.random.Generator, number: Optional[int] = None,
                   is_goalie: bool = False,
                   striped: bool = False) -> List[float]:
    """Ellipse/capsule person at `foot` (bottom-center), `hpx` px tall.
    Returns the body extent [x1, y1, x2, y2]."""
    import cv2

    fx, fy = float(foot[0]), float(foot[1])
    lean_deg = rng.uniform(-14, 14)
    lean = np.tan(np.radians(lean_deg))
    bw = hpx * (0.30 if not is_goalie else 0.44) * rng.uniform(0.85, 1.15)
    top_y = fy - hpx
    ext: List[List[float]] = []

    def at(frac_up: float, dx: float = 0.0) -> Tuple[float, float]:
        """Point at body fraction (1=head top), lean applied linearly."""
        y = fy - frac_up * hpx
        return fx + lean * frac_up * hpx + dx, y

    dark = (22, 22, 26)
    skin = (int(rng.uniform(130, 205)),) * 3

    # stick first (behind). NOT part of the extent box: the shared label
    # contract (generator A's, and standard sports-person labeling) is
    # body extent without the stick — including it here shifted B's gt
    # boxes ~0.5*hpx sideways and made every detection score as a miss
    # (the round-3 "OOD gap" was half this labeling bug)
    if not is_goalie and rng.uniform() < 0.85:
        hx, hy = at(0.38, rng.choice([-1, 1]) * bw * 0.7)
        tip = (hx + rng.choice([-1, 1]) * rng.uniform(0.4, 1.0) * hpx,
               fy + rng.uniform(-0.05, 0.03) * hpx)
        _capsule(img, (hx, hy), tip, hpx * 0.028, (60, 70, 80))
    # legs: two capsules hip->skate
    hipL = at(0.48, -bw * 0.22)
    hipR = at(0.48, bw * 0.22)
    stance = rng.uniform(0.15, 0.5) * bw
    for hip, sx in ((hipL, fx - stance), (hipR, fx + stance)):
        knee = ((hip[0] + sx) / 2 + rng.uniform(-2, 2),
                fy - 0.24 * hpx)
        _capsule(img, hip, knee, bw * 0.30,
                 pants if is_goalie else (35, 35, 40))
        _capsule(img, knee, (sx, fy - 0.03 * hpx), bw * 0.26,
                 pants if is_goalie else (35, 35, 40))
        # skate blade + boot
        cv2.ellipse(img, (int(sx), int(fy - 0.03 * hpx)),
                    (max(int(bw * 0.22), 1), max(int(hpx * 0.035), 1)),
                    0, 0, 360, dark, -1, lineType=cv2.LINE_AA)
        ext.append([sx - bw * 0.3, fy - 0.1 * hpx, sx + bw * 0.3, fy])
    if is_goalie:  # leg pads: pale wide capsules over the legs
        pad = (int(rng.uniform(190, 245)),) * 3
        for sx in (fx - stance, fx + stance):
            _capsule(img, (sx, fy - 0.45 * hpx), (sx, fy - 0.04 * hpx),
                     bw * 0.42, pad)
    # hips
    hc = at(0.52)
    cv2.ellipse(img, (int(hc[0]), int(hc[1])),
                (max(int(bw * 0.62), 1), max(int(hpx * 0.10), 1)),
                lean_deg * 0.5, 0, 360, pants, -1, lineType=cv2.LINE_AA)
    ext.append([hc[0] - bw * 0.62, hc[1] - 0.1 * hpx,
                hc[0] + bw * 0.62, hc[1] + 0.1 * hpx])
    # torso: rotated ellipse
    tc = at(0.70)
    ta, tb = max(int(bw * 0.72), 1), max(int(hpx * 0.20), 2)
    cv2.ellipse(img, (int(tc[0]), int(tc[1])), (ta, tb),
                90 + lean_deg, 0, 360, jersey, -1, lineType=cv2.LINE_AA)
    ext.append([tc[0] - tb, tc[1] - tb, tc[0] + tb, tc[1] + tb])
    if striped:  # referee: vertical dark stripes across the torso
        for k in range(-2, 3):
            x0 = tc[0] + k * max(ta // 3, 2) * 0.45
            cv2.line(img, (int(x0), int(tc[1] - tb * 0.9)),
                     (int(x0), int(tc[1] + tb * 0.9)), (15, 15, 15), 2)
    # arms: capsules from shoulders
    sh = at(0.82)
    for side in (-1, 1):
        elbow = (sh[0] + side * bw * rng.uniform(0.6, 1.0),
                 sh[1] + rng.uniform(0.05, 0.22) * hpx)
        _capsule(img, (sh[0] + side * bw * 0.3, sh[1]), elbow,
                 bw * 0.26, jersey)
        glove = (elbow[0] + side * bw * rng.uniform(0.0, 0.4),
                 elbow[1] + rng.uniform(0.0, 0.12) * hpx)
        _capsule(img, elbow, glove, bw * 0.24, dark)
        ext.append([min(sh[0], glove[0]) - bw * 0.2, sh[1] - bw * 0.2,
                    max(sh[0], glove[0]) + bw * 0.2, glove[1] + bw * 0.2])
    # head + helmet
    hd = at(0.93)
    hr = max(hpx * 0.075, 1.5)
    cv2.circle(img, (int(hd[0]), int(hd[1])), int(hr), skin, -1,
               lineType=cv2.LINE_AA)
    helm = dark if rng.uniform() < 0.75 else \
        tuple(int(v) for v in rng.uniform(20, 200, 3))
    cv2.ellipse(img, (int(hd[0]), int(hd[1] - hr * 0.3)),
                (int(hr * 1.05), int(hr * 0.85)), 0, 180, 360, helm, -1,
                lineType=cv2.LINE_AA)
    ext.append([hd[0] - hr * 1.1, top_y, hd[0] + hr * 1.1, hd[1] + hr])
    # number: PLAIN/COMPLEX fonts (A uses SIMPLEX/DUPLEX/TRIPLEX)
    if number is not None and hpx > 30:
        font = [cv2.FONT_HERSHEY_PLAIN, cv2.FONT_HERSHEY_COMPLEX_SMALL][
            int(rng.integers(0, 2))]
        sc = hpx / (55.0 if font == cv2.FONT_HERSHEY_PLAIN else 95.0)
        fg = (250, 250, 250) if sum(jersey) < 380 else (18, 18, 18)
        cv2.putText(img, str(number),
                    (int(tc[0] - bw * 0.4), int(tc[1] + tb * 0.35)),
                    font, sc, fg, max(1, int(sc * 1.6)), cv2.LINE_AA)

    e = np.asarray(ext, np.float32)
    return [float(e[:, 0].min()), float(min(e[:, 1].min(), top_y)),
            float(e[:, 2].max()), float(e[:, 3].max())]


def _kits(rng: np.random.Generator):
    """Two team kits with guaranteed separation + pants colors."""
    def one():
        if rng.uniform() < 0.2:
            v = int(rng.uniform(205, 255))
            return (v, v, v)
        hsv = np.uint8([[[int(rng.uniform(0, 180)),
                          int(rng.uniform(120, 255)),
                          int(rng.uniform(110, 255))]]])
        import cv2

        return tuple(int(v) for v in cv2.cvtColor(
            hsv, cv2.COLOR_HSV2BGR)[0, 0])

    a = one()
    for _ in range(50):
        b = one()
        if np.abs(np.asarray(a, float) - b).sum() > 170:
            break
    pa = tuple(int(v) for v in rng.uniform(8, 80, 3))
    pb = tuple(int(v) for v in rng.uniform(8, 80, 3))
    return a, b, pa, pb


# ---------------------------------------------------------------------------
# Degradation (B's own pipeline; JPEG/motion-blur are in eval/corruptions)
# ---------------------------------------------------------------------------

def _degrade(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    import cv2

    s = img.shape[0]
    out = img.astype(np.float32)
    # vignette
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    r2 = ((xx / s - 0.5) ** 2 + (yy / s - 0.5) ** 2) * 4.0
    out *= (1.0 - rng.uniform(0.05, 0.25) * r2)[..., None]
    # color temperature cast
    warm = rng.uniform(-0.08, 0.08)
    out[..., 2] *= 1.0 + warm
    out[..., 0] *= 1.0 - warm
    # row banding
    if rng.uniform() < 0.5:
        band = np.sin(np.arange(s) * rng.uniform(0.05, 0.6)
                      + rng.uniform(0, 7)) * rng.uniform(0.5, 3.0)
        out += band[:, None, None]
    # signal-dependent shot noise
    sigma = rng.uniform(0.5, 2.5)
    out += rng.normal(0, 1, img.shape) * sigma * np.sqrt(
        np.maximum(out, 1.0) / 64.0)
    # defocus
    if rng.uniform() < 0.3:
        out = cv2.GaussianBlur(out, (0, 0), rng.uniform(0.5, 1.4))
    # broadcast resampling: down + up
    if rng.uniform() < 0.5:
        k = rng.uniform(0.55, 0.9)
        small = cv2.resize(out, (int(s * k), int(s * k)),
                           interpolation=cv2.INTER_AREA)
        out = cv2.resize(small, (s, s), interpolation=cv2.INTER_LINEAR)
    return np.clip(out, 0, 255).astype(np.uint8)


# ---------------------------------------------------------------------------
# Scene
# ---------------------------------------------------------------------------

def render_scene_b(rng: np.random.Generator, s: int = 640,
                   pucks: bool = False) -> Tuple[np.ndarray, np.ndarray,
                                                 np.ndarray]:
    """One generator-B scene. Same label contract as scenes.render_scene:
    (image uint8 BGR (s, s, 3), boxes xyxy, classes); classes {0: player,
    1: goalie} (or {0: puck} with unlabeled player distractors)."""
    import cv2

    from ..rinkmap.dimensions import NHL

    rink = NHL
    cam = _Camera(rng, s, rink,
                  zoom_range=(2.6, 6.0) if pucks else (0.9, 2.8))
    img = _background(rng, cam, rink)
    team_a, team_b, pants_a, pants_b = _kits(rng)
    L, W = rink.length, rink.width

    # actor positions: unproject random image points onto the rink so
    # tight zooms still show players (a different placement scheme from A)
    n = int(rng.integers(4, 15))
    uv = rng.uniform(0.05, 0.95, (n, 2)) * s
    pos = cam.unproject(uv)
    pos[:, 0] = np.clip(pos[:, 0] + rng.uniform(-6, 6, n), 2, L - 2)
    pos[:, 1] = np.clip(pos[:, 1] + rng.uniform(-4, 4, n), 2, W - 2)
    actors = []
    for j in range(n):
        actors.append((pos[j, 0], pos[j, 1], "player",
                       int(rng.uniform() < 0.5)))
        if rng.uniform() < 0.35:  # scrum partner
            actors.append((float(np.clip(pos[j, 0] + rng.uniform(-3, 3),
                                         2, L - 2)),
                           float(np.clip(pos[j, 1] + rng.uniform(-2.5, 2.5),
                                         2, W - 2)),
                           "player", int(rng.uniform() < 0.6)))
    for gx in (rink.goal_line_from_end, L - rink.goal_line_from_end):
        if rng.uniform() < 0.55:
            actors.append((gx + rng.uniform(-2, 2),
                           W / 2 + rng.uniform(-4, 4), "goalie", 2))
    if rng.uniform() < 0.4:
        actors.append((rng.uniform(15, L - 15), rng.uniform(5, W - 5),
                       "ref", 3))

    hscale = rng.uniform(0.88, 1.15)
    drawn = []
    for (ax, ay, kind, team) in actors:
        foot, hpx, ok = cam.standing_extent(ax, ay)
        if not ok:
            continue
        hpx *= hscale * rng.uniform(0.93, 1.07)
        if hpx < 7 or hpx > 0.95 * s:
            continue
        if not (-0.3 * s < foot[0] < 1.3 * s and 0 < foot[1] < 1.25 * s):
            continue
        drawn.append((foot[1], foot, hpx, kind, team))
    drawn.sort(key=lambda d: d[0])  # far (small v) first

    boxes, classes = [], []
    for _, foot, hpx, kind, team in drawn:
        if kind == "goalie":
            jersey = team_a if rng.uniform() < 0.5 else (30, 150, 170)
            box = _draw_person_b(img, foot, hpx * 1.04, jersey,
                                 (28, 28, 28), rng, is_goalie=True)
            cls = 1
        elif kind == "ref":
            box = _draw_person_b(img, foot, hpx, (238, 238, 238),
                                 (18, 18, 18), rng, striped=True)
            cls = 0
        else:
            jersey = team_a if team == 0 else team_b
            pants = pants_a if team == 0 else pants_b
            box = _draw_person_b(img, foot, hpx, jersey, pants, rng,
                                 number=int(rng.integers(1, 99)))
            cls = 0
        cb = [max(box[0], 0), max(box[1], 0), min(box[2], s),
              min(box[3], s)]
        area = max(cb[2] - cb[0], 0) * max(cb[3] - cb[1], 0)
        full = (box[2] - box[0]) * (box[3] - box[1])
        if full <= 0 or area / full < 0.3 or area < 16:
            continue
        if not pucks:
            boxes.append(cb)
            classes.append(cls)

    # puck(s)
    if pucks or rng.uniform() < 0.5:
        for _ in range(int(rng.integers(1, 3)) if pucks else 1):
            uvp = rng.uniform(0.1, 0.9, (1, 2)) * s
            pp = cam.unproject(uvp)[0]
            px = float(np.clip(pp[0], 5, L - 5))
            py = float(np.clip(pp[1], 2, W - 2))
            c, hpx, ok = cam.standing_extent(px, py, h_ft=PLAYER_H_FT)
            if not ok:
                continue
            pr = max(hpx * 0.055, 1.8)
            if not (0 < c[0] < s and 0 < c[1] < s):
                continue
            cv2.ellipse(img, (int(c[0]), int(c[1])),
                        (int(max(pr * 1.5, 2)), int(max(pr * 0.8, 1))),
                        0, 0, 360, (28, 24, 22), -1, lineType=cv2.LINE_AA)
            cv2.ellipse(img, (int(c[0]), int(c[1] - pr * 0.35)),
                        (int(max(pr * 1.3, 1)), int(max(pr * 0.45, 1))),
                        0, 0, 360, (55, 50, 48), -1, lineType=cv2.LINE_AA)
            if pucks:
                boxes.append([c[0] - 1.8 * pr, c[1] - 1.3 * pr,
                              c[0] + 1.8 * pr, c[1] + 1.3 * pr])
                classes.append(0)

    img = _degrade(img, rng)
    return (img, np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32))


# ---------------------------------------------------------------------------
# Coherent sequences (e2e OOD: tracking / teams on a never-trained renderer)
# ---------------------------------------------------------------------------

def _sample_degrade_b(rng: np.random.Generator) -> dict:
    """Per-CLIP degradation parameters (a coherent clip must not flicker
    its vignette/color cast/banding frame to frame). Kept separate from
    `_degrade` so render_scene_b's per-image rng sequence — and therefore
    every logged generator-B val number — is untouched."""
    return {
        "vig": rng.uniform(0.05, 0.25),
        "warm": rng.uniform(-0.08, 0.08),
        "band": ((rng.uniform(0.05, 0.6), rng.uniform(0, 7),
                  rng.uniform(0.5, 3.0)) if rng.uniform() < 0.5 else None),
        "sigma": rng.uniform(0.5, 2.5),
        "blur": (rng.uniform(0.5, 1.4) if rng.uniform() < 0.3 else None),
        "resample": (rng.uniform(0.6, 0.9) if rng.uniform() < 0.5
                     else None),
    }


def _apply_degrade_b(img: np.ndarray, rng: np.random.Generator,
                     p: dict) -> np.ndarray:
    """Apply clip-constant degradation `p`; only the shot noise draws
    from `rng` (noise SHOULD vary per frame, optics should not)."""
    import cv2

    s = img.shape[0]
    out = img.astype(np.float32)
    yy, xx = np.mgrid[0:s, 0:s].astype(np.float32)
    r2 = ((xx / s - 0.5) ** 2 + (yy / s - 0.5) ** 2) * 4.0
    out *= (1.0 - p["vig"] * r2)[..., None]
    out[..., 2] *= 1.0 + p["warm"]
    out[..., 0] *= 1.0 - p["warm"]
    if p["band"] is not None:
        freq, phase, amp = p["band"]
        out += (np.sin(np.arange(s) * freq + phase) * amp)[:, None, None]
    out += rng.normal(0, 1, img.shape) * p["sigma"] * np.sqrt(
        np.maximum(out, 1.0) / 64.0)
    if p["blur"] is not None:
        out = cv2.GaussianBlur(out, (0, 0), p["blur"])
    if p["resample"] is not None:
        k = p["resample"]
        small = cv2.resize(out, (int(s * k), int(s * k)),
                           interpolation=cv2.INTER_AREA)
        out = cv2.resize(small, (s, s), interpolation=cv2.INTER_LINEAR)
    return np.clip(out, 0, 255).astype(np.uint8)


def _step_puck_b(puck: dict, rng: np.random.Generator, fps: float,
                 lo: float, hi: float, W: float) -> None:
    """B's puck physics flavor (independent of A's pass/dwell targeting):
    free glide with friction; when it slows under a threshold it is
    'shot' in a fresh random direction; board bounces lose energy."""
    puck["px"] += puck["vx"] / fps
    puck["py"] += puck["vy"] / fps
    puck["vx"] *= 0.99
    puck["vy"] *= 0.99
    if float(np.hypot(puck["vx"], puck["vy"])) < 8.0:
        ang = rng.uniform(0, 2 * np.pi)
        speed = rng.uniform(25.0, 70.0)
        puck["vx"] = float(np.cos(ang) * speed)
        puck["vy"] = float(np.sin(ang) * speed)
    if not (lo < puck["px"] < hi):
        puck["vx"] *= -0.85
        puck["px"] = float(np.clip(puck["px"], lo, hi))
    if not (2 < puck["py"] < W - 2):
        puck["vy"] *= -0.85
        puck["py"] = float(np.clip(puck["py"], 2, W - 2))


def _draw_puck_b(img, cam: _Camera, puck: dict, c: np.ndarray):
    """Draw B's shaded-disk puck at pixel `c`; returns the post-draw
    region (y0, y1, x0, x1, patch) for later overdraw detection."""
    import cv2

    s = img.shape[0]
    _, hpx, ok = cam.standing_extent(puck["px"], puck["py"])
    if not ok:
        return None
    pr = max(hpx * 0.055, 1.8)
    cv2.ellipse(img, (int(c[0]), int(c[1])),
                (int(max(pr * 1.5, 2)), int(max(pr * 0.8, 1))),
                0, 0, 360, (28, 24, 22), -1, lineType=cv2.LINE_AA)
    cv2.ellipse(img, (int(c[0]), int(c[1] - pr * 0.35)),
                (int(max(pr * 1.3, 1)), int(max(pr * 0.45, 1))),
                0, 0, 360, (55, 50, 48), -1, lineType=cv2.LINE_AA)
    rx, ry = int(max(pr * 1.5, 2)) + 1, int(max(pr * 1.0, 1)) + 1
    y0, y1 = max(int(c[1]) - ry, 0), min(int(c[1]) + ry + 1, s)
    x0, x1 = max(int(c[0]) - rx, 0), min(int(c[0]) + rx + 1, s)
    return y0, y1, x0, x1, img[y0:y1, x0:x1].copy()


def render_scene_sequence_b(rng: np.random.Generator, s: int = 640,
                            n_frames: int = 96, fps: float = 30.0,
                            zoom_range=(1.0, 2.0),
                            include_puck: bool = False):
    """Temporally-coherent generator-B clip: fixed pinhole camera and
    kits, actors skating smoothly. Same LABEL CONTRACT as generator A's
    scenes.render_scene_sequence (boxes/classes/track_ids/team_ids/
    numbers/rink_xy/camera_h), sharing none of A's rendering machinery —
    the OOD counterpart for END-TO-END evaluation (tracking, teams)
    rather than single-image mAP (scripts/e2e_quality.py --generator b).
    """
    import cv2

    from ..rinkmap.dimensions import NHL

    rink = NHL
    L, W = rink.length, rink.width
    cam = _Camera(rng, s, rink, zoom_range=zoom_range)
    background = _background(rng, cam, rink)
    team_a, team_b, pants_a, pants_b = _kits(rng)
    goalie_jersey = team_a if rng.uniform() < 0.5 else (30, 150, 170)
    degrade = _sample_degrade_b(rng)

    # visible rink window: unproject frame corners onto the plane
    corners = cam.unproject(np.asarray(
        [[0, 0], [s, 0], [0, s], [s, s]], np.float64) * 1.0)
    finite = np.isfinite(corners).all(axis=1)
    if finite.any():
        lo = float(np.clip(corners[finite, 0].min() - 5, 2, L - 10))
        hi = float(np.clip(corners[finite, 0].max() + 5, lo + 5, L - 2))
    else:  # degenerate horizon: whole rink
        lo, hi = 2.0, L - 2.0

    actors = []
    n = int(rng.integers(6, 12))
    uv = rng.uniform(0.1, 0.9, (n, 2)) * s
    pos = cam.unproject(uv)
    for j in range(n):
        actors.append({
            "px": float(np.clip(pos[j, 0], lo, hi)),
            "py": float(np.clip(pos[j, 1], 3, W - 3)),
            "vx": rng.uniform(-6, 6), "vy": rng.uniform(-4, 4),
            "kind": "player", "team": int(rng.uniform() < 0.5),
            "number": int(rng.integers(1, 99)),
            "hjit": rng.uniform(0.94, 1.06),
        })
    for gx in (rink.goal_line_from_end, L - rink.goal_line_from_end):
        if lo - 6 < gx < hi + 6:
            actors.append({
                "px": gx + rng.uniform(-1, 1),
                "py": W / 2 + rng.uniform(-3, 3),
                "vx": rng.uniform(-0.5, 0.5), "vy": rng.uniform(-1, 1),
                "kind": "goalie", "team": 2, "number": None,
                "hjit": rng.uniform(0.96, 1.04),
            })
    hscale = rng.uniform(0.88, 1.12)

    puck = None
    if include_puck:
        puck = {"px": rng.uniform(lo + 3, hi - 3),
                "py": rng.uniform(8, W - 8),
                "vx": rng.uniform(-40, 40), "vy": rng.uniform(-25, 25)}

    frames, labels = [], []
    for _t in range(n_frames):
        img = background.copy()
        order = []
        for a in actors:
            foot, hpx, ok = cam.standing_extent(a["px"], a["py"])
            if not ok:
                continue
            order.append((float(foot[1]), a, foot, hpx))
        order.sort(key=lambda d: d[0])  # far (small v) first

        puck_xy = None
        puck_patch = None
        drew_puck = True
        if puck is not None:
            pc = cam.project_plane(np.asarray([[puck["px"], puck["py"]]]))[0]
            if 1 < pc[0] < s - 2 and 1 < pc[1] < s - 2:
                puck_xy = pc
                drew_puck = False

        boxes, classes, tids, teams, rink_xy, numbers = ([], [], [], [],
                                                         [], [])
        for _v, a, foot, hpx in order:
            # puck inserted at its depth: nearer actors overdraw it
            if not drew_puck and _v > puck_xy[1]:
                puck_patch = _draw_puck_b(img, cam, puck, puck_xy)
                drew_puck = True
            hpx = hpx * hscale * a["hjit"]
            if hpx < 7 or hpx > 0.95 * s:
                continue
            if not (-0.3 * s < foot[0] < 1.3 * s and 0 < foot[1] < 1.25 * s):
                continue
            if a["kind"] == "goalie":
                box = _draw_person_b(img, foot, hpx * 1.04, goalie_jersey,
                                     (28, 28, 28), rng, is_goalie=True)
                cls = 1
            else:
                jersey = team_a if a["team"] == 0 else team_b
                pants = pants_a if a["team"] == 0 else pants_b
                box = _draw_person_b(img, foot, hpx, jersey, pants, rng,
                                     number=a["number"])
                cls = 0
            cb = [max(box[0], 0), max(box[1], 0),
                  min(box[2], s), min(box[3], s)]
            area = max(cb[2] - cb[0], 0) * max(cb[3] - cb[1], 0)
            full = (box[2] - box[0]) * (box[3] - box[1])
            if full <= 0 or area / full < 0.3 or area < 16:
                continue
            boxes.append(cb)
            classes.append(cls)
            tids.append(actors.index(a))
            teams.append(a["team"])
            rink_xy.append((a["px"], a["py"]))
            numbers.append(-1 if a["number"] is None else a["number"])

        if not drew_puck:  # puck nearest of all
            puck_patch = _draw_puck_b(img, cam, puck, puck_xy)
        puck_visible = False
        if puck_patch is not None:
            y0, y1, x0, x1, ref = puck_patch
            same = (img[y0:y1, x0:x1] == ref).all(axis=2).mean()
            puck_visible = bool(same >= 0.5)

        frames.append(_apply_degrade_b(img, rng, degrade))
        lab = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "track_ids": np.asarray(tids, np.int32),
            "team_ids": np.asarray(teams, np.int32),
            "rink_xy": np.asarray(rink_xy, np.float32).reshape(-1, 2),
            "numbers": np.asarray(numbers, np.int32),
            "camera_h": cam.H.copy(),
        }
        if puck is not None:
            lab["puck_xy"] = (None if puck_xy is None
                              else np.asarray(puck_xy, np.float32))
            lab["puck_rink"] = np.asarray([puck["px"], puck["py"]],
                                          np.float32)
            lab["puck_visible"] = puck_visible
        labels.append(lab)

        for a in actors:  # smooth skating, gentle drift, window bounce
            a["px"] += a["vx"] / fps
            a["py"] += a["vy"] / fps
            a["vx"] += rng.normal(0, 0.25)
            a["vy"] += rng.normal(0, 0.25)
            sp = float(np.hypot(a["vx"], a["vy"]))
            cap = 1.5 if a["kind"] == "goalie" else 8.0
            if sp > cap:
                a["vx"] *= cap / sp
                a["vy"] *= cap / sp
            if not (lo < a["px"] < hi):
                a["vx"] *= -1
                a["px"] = float(np.clip(a["px"], lo, hi))
            if not (2 < a["py"] < W - 2):
                a["vy"] *= -1
                a["py"] = float(np.clip(a["py"], 2, W - 2))
        if puck is not None:
            _step_puck_b(puck, rng, fps, lo, hi, W)
    return frames, labels


# ---------------------------------------------------------------------------
# Datasets (val.py --dataset hard-b / hard-puck-b / rink-b)
# ---------------------------------------------------------------------------

class HardSyntheticHockeyDatasetB:
    """Generator-B pool with the same access interface as
    scenes.HardSyntheticHockeyDataset (load -> images/boxes/classes/mask)."""

    augmentable = False

    def __init__(self, imgsz: int = 640, seed: int = 0,
                 pool_size: int = 200, pucks: bool = False,
                 max_gt: int = 64):
        self.imgsz = imgsz
        self.seed = seed
        self.pool_size = pool_size
        self.pucks = pucks
        self.max_gt = max_gt
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.pool_size

    def _scene(self, idx: int):
        item = self._cache.get(idx)
        if item is None:
            rng = np.random.default_rng(
                (self.seed + 11) * 2_000_033 + idx * 6991 + self.pucks)
            item = render_scene_b(rng, self.imgsz, pucks=self.pucks)
            self._cache[idx] = item
        return item

    def pregenerate(self, workers: int = 8) -> None:
        import concurrent.futures as cf

        missing = [i for i in range(self.pool_size) if i not in self._cache]
        if not missing:
            return
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            for idx, item in zip(missing, ex.map(
                    _render_b_for,
                    [(self.seed, i, self.imgsz, self.pucks)
                     for i in missing])):
                self._cache[idx] = item

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        from .data import pad_targets

        img, boxes, classes = self._scene(idx % self.pool_size)
        b, c, m = pad_targets(boxes, classes, self.max_gt)
        return {"images": img.astype(np.float32) / 255.0,
                "boxes": b, "classes": c, "mask": m}


class SyntheticRinkDatasetB:
    """Generator-B rink views with 56-keypoint labels for pose eval:
    B's pinhole camera + B's background; labels from the shared
    ground-truth keypoint table (the contract, not renderer code)."""

    def __init__(self, imgsz: int = 512, seed: int = 0, max_gt: int = 4):
        from ..rinkmap.dimensions import NHL, default_keypoint_positions

        self.imgsz = imgsz
        self.seed = seed
        self.max_gt = max_gt
        self.table = default_keypoint_positions()
        self.rink = NHL

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 77003 + idx * 13 + 5)
        s = self.imgsz
        # high, far, wide cameras so most of the sheet (and its
        # keypoints) is visible, as in the pose training distribution
        cam = _Camera(rng, s, self.rink, fit_rink=True,
                      dist_range=(40.0, 120.0), height_range=(120.0, 300.0))
        img = _background(rng, cam, self.rink)
        img = _degrade(img, rng)
        pts = cam.project_plane(self.table.astype(np.float64))
        vis = ((pts[:, 0] >= 0) & (pts[:, 0] < s)
               & (pts[:, 1] >= 0) & (pts[:, 1] < s))
        kpts = np.zeros((self.max_gt, 56, 3), np.float32)
        kpts[0, :, :2] = pts
        kpts[0, :, 2] = vis
        vp = pts[vis]
        if len(vp):
            box = [max(vp[:, 0].min(), 0), max(vp[:, 1].min(), 0),
                   min(vp[:, 0].max(), s - 1), min(vp[:, 1].max(), s - 1)]
        else:
            box = [0, 0, s - 1, s - 1]
        boxes = np.zeros((self.max_gt, 4), np.float32)
        classes = np.zeros((self.max_gt,), np.int32)
        mask = np.zeros((self.max_gt,), bool)
        boxes[0] = box
        mask[0] = True
        return {"images": img.astype(np.float32) / 255.0, "boxes": boxes,
                "classes": classes, "mask": mask, "keypoints": kpts}


def _render_b_for(args):
    seed, idx, imgsz, pucks = args
    rng = np.random.default_rng(
        (seed + 11) * 2_000_033 + idx * 6991 + pucks)
    return render_scene_b(rng, imgsz, pucks=pucks)
