"""Generator A: hard synthetic hockey scenes for detector training.

Port of hockey_tpu/train/scenes.py, all of it: the style sampler, the
player sprites (`_draw_player`, `_draw_player_capsule`), the rink
background, `render_scene`, `render_scene_sequence` with its puck, and
`HardSyntheticHockeyDataset` with its pool cache (`save_cache` writes the
format `train/data.py PoolDataset` reads).

Scene model:
- a random camera homography maps a window of the NHL rink plane
  (rinkmap/dimensions.py) to the image; markings, boards and crowd are
  drawn through it;
- players stand on the plane: the foot position is projected, the pixel
  height comes from the local homography scale (far players are small);
- players are articulated sprites (helmet, torso, pants, legs, skates,
  stick, jersey number) in two team colours per scene plus goalie gear,
  drawn back to front so that overlaps occlude;
- labels are full-extent body boxes (clipped), kept when >= 30% is
  visible; referees are labelled as players.

It is numpy with `cv2` imported inside each function that draws
(anti-aliased lines and ellipses, Hershey text, blurs, `warpAffine`, a
JPEG round trip), so it runs where OpenCV is installed and not on a GPU
machine without it. Every call on `rng` comes in the JAX package's
order, so a seed renders the same image, boxes and classes bit for bit
(tests/test_torch_scenes.py).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

PLAYER_H_FT = 6.0  # skater height incl. skates/helmet

# Bump whenever render output changes for the same rng seed (new hard
# negatives, style keys, geometry). Keyed into the on-disk scene-pool
# cache name (train/loop.py) so a stale cached pool rendered by an older
# renderer can never silently train a model without the new content.
RENDERER_VERSION = 5  # round-4: capsule/ellipse body-shape family +
# puck SIZE family 8-60px under domain_rand (v4 was the dark-limb/
# mitt-merge family + stick shafts); no cache was built at an earlier v5


def _homography(rng: np.random.Generator, s: int, rink,
                span_range=(0.3, 0.95), width: Optional[int] = None
                ) -> np.ndarray:
    """Random broadcast camera: a window of the rink -> image trapezoid.
    `width` enables rectangular frames (default square; the rng draw
    sequence is identical when width == s, so square outputs are
    bit-stable across this change)."""
    from ..homography.ransac import dlt_homography

    w = s if width is None else width
    L, W = rink.length, rink.width
    # visible window along the length; zoom varies (full-ice .. tight)
    span = rng.uniform(*span_range) * L
    cx = rng.uniform(span / 2, L - span / 2)
    x0, x1 = cx - span / 2, cx + span / 2
    # far side appears higher and narrower (camera above one side)
    top_y = rng.uniform(0.02, 0.22) * s
    bot_y = rng.uniform(0.85, 1.25) * s
    top_inset = rng.uniform(0.04, 0.22) * w
    bot_outset = rng.uniform(0.0, 0.25) * w
    src = np.asarray([[x0, 0], [x1, 0], [x0, W], [x1, W]], np.float64)
    dst = np.asarray([
        [top_inset, top_y], [w - top_inset, top_y],
        [-bot_outset, bot_y], [w + bot_outset, bot_y],
    ], np.float64)
    return dlt_homography(src, dst), (x0, x1)


def _project(h: np.ndarray, pts: np.ndarray) -> np.ndarray:
    from ..homography.ransac import project

    return project(h, np.asarray(pts, np.float64))


def _local_height(h: np.ndarray, x: float, y: float,
                  feet: float = PLAYER_H_FT) -> float:
    """Pixel height of a `feet`-tall upright object at rink point (x, y):
    approximated by the projected length of an in-plane segment toward
    the far boards (the camera elevation makes these comparable)."""
    p = _project(h, np.asarray([[x, y], [x, max(y - feet, 0.01)]]))
    return float(np.linalg.norm(p[0] - p[1]))


def sample_style(rng: np.random.Generator) -> Dict:
    """Domain-randomization style knobs, sampled once per scene.

    The shipped round-2 detector overfit generator A's specific sprite
    silhouette + crowd texture (generator-B mAP50 0.11 vs 0.92 held-out,
    logs/robustness.json) — classic sim2real style overfit. These knobs
    widen A's rendering family (body silhouettes, crowd textures, board
    ads, photometric pipelines) so a trained model must rely on the
    task-relevant structure (person-shaped things on ice) rather than
    renderer idiosyncrasies. Generator B (scenes_b.py) remains unseen
    eval-only code."""
    return {
        "round": rng.uniform() < 0.5,        # rounded body silhouettes
        "wmul": rng.uniform(0.72, 1.3),      # body slimness family
        "goalie_pads": rng.uniform() < 0.5,  # pale leg pads
        "crowd": ["coarse", "blur", "banner"][int(rng.integers(0, 3))],
        "ads_text": rng.uniform() < 0.5,     # lettered board ads
        "vignette": (rng.uniform(0.05, 0.3)
                     if rng.uniform() < 0.5 else 0.0),
        "cast": rng.uniform(-0.08, 0.08),    # color-temperature shift
        "banding": rng.uniform() < 0.3,      # row brightness banding
        "aa": rng.uniform() < 0.5,           # antialiased markings/limbs
        # round-4 limb-context family: generator-B-style limbs are THICK
        # DARK AA capsules terminating in dark capsule mitts — one
        # continuous elongated dark shape. The round-3 glove negatives
        # (small blob at the end of a thin jersey-colored arm) did not
        # cover that context, and B's mitts kept drawing ~5.7 confident
        # puck false fires per image (logs/diag_puck_b). Randomizing the
        # whole limb's color/thickness/termination makes "dark elongated
        # blob attached to a body" a negative in every presentation.
        "dark_limbs": rng.uniform() < 0.5,   # arm capsules in glove color
        "limb_w": rng.uniform(1.0, 3.2),     # arm thickness family
        "mitt_merge": rng.uniform() < 0.6,   # mitt continuous with arm
        # round-4 body-shape family: generator B composes people from
        # rotated ellipses and round-capped capsules (articulated legs
        # with knees, elliptical torso), while every A silhouette is a
        # stacked trapezoid. The mismatch is the common root of the two
        # open OOD gaps measured this round: the puck detector fires on
        # B's capsule mitts because no *training* body ever presented a
        # free-standing capsule limb (dark-limb fine-tune on trapezoid
        # bodies: B mAP50 0.100, logs/val_puck_dl_b.json), and the
        # player head regresses noisy extents on unfamiliar rounded
        # silhouettes (box jitter -> id switches, logs/e2e_quality_b).
        # ~half of styled scenes now draw fully articulated
        # ellipse/capsule bodies (independent parameterization,
        # _draw_player_capsule) so "person" spans both silhouette
        # families. Generator B stays unseen eval-only code.
        "body_capsule": rng.uniform() < 0.45,
    }


def _draw_player(img, foot: Tuple[float, float], hpx: float, jersey, pants,
                 rng: np.random.Generator, number: Optional[int] = None,
                 is_goalie: bool = False, ghost: bool = False,
                 style: Optional[Dict] = None) -> List[float]:
    """Articulated sprite at `foot` (bottom-center), `hpx` tall. Returns
    the body extent box [x1, y1, x2, y2]. `style` (sample_style) widens
    the silhouette family; None keeps the legacy silhouette GEOMETRY, but
    note the round-3 contextual hard negatives (stick-blade / skate-blade
    / glove blobs below) draw in every style and consume rng draws, so
    renders are NOT bit-identical to the round-2 renderer — round-2
    checkpoints were re-scored on the current renderer before comparison."""
    import cv2

    if style is not None and style.get("body_capsule"):
        # round-4 body-shape family (see sample_style): delegate before
        # any rng draw so non-capsule styles keep their exact sequences
        return _draw_player_capsule(img, foot, hpx, jersey, pants, rng,
                                    number=number, is_goalie=is_goalie,
                                    ghost=ghost, style=style)

    fx, fy = foot
    lean = rng.uniform(-0.12, 0.12)  # skating lean, shifts the top
    w = hpx * (0.52 if is_goalie else 0.38) * rng.uniform(0.9, 1.15)
    if style is not None:
        w *= style["wmul"]
    top = fy - hpx
    cxt = fx + lean * hpx  # top center after lean

    skin = (int(rng.uniform(120, 200)),) * 3
    dark = (25, 25, 25)

    def seg(y0f, y1f, widthf, color):
        """Trapezoid segment between body fractions (0=top of body)."""
        ya, yb = top + y0f * hpx, top + y1f * hpx
        ca = cxt + (fx - cxt) * y0f
        cb = cxt + (fx - cxt) * y1f
        ww = widthf * w
        pts = np.asarray([[ca - ww / 2, ya], [ca + ww / 2, ya],
                          [cb + ww / 2, yb], [cb - ww / 2, yb]], np.int32)
        cv2.fillPoly(img, [pts], color)
        return [min(ca, cb) - ww / 2, ya, max(ca, cb) + ww / 2, yb]

    alpha_img = img.copy() if ghost else None

    # stick (behind the body)
    if not is_goalie and rng.uniform() < 0.9:
        sx = fx + rng.choice([-1, 1]) * rng.uniform(0.3, 0.9) * hpx
        sy = fy - rng.uniform(-0.02, 0.08) * hpx
        # stick shaft color family (B draws grey-blue shafts, not black)
        stick = dark
        if style is not None and rng.uniform() < 0.5:
            sg = int(rng.uniform(30, 90))
            stick = (sg, int(sg * rng.uniform(1.0, 1.3)),
                     int(sg * rng.uniform(1.0, 1.4)))
        cv2.line(img, (int(fx), int(fy - 0.45 * hpx)),
                 (int(sx), int(sy)), stick, max(1, int(hpx * 0.03)))
        # stick BLADE: a puck-sized dark blob at the stick's far end.
        # Deliberate hard negative — the puck detector must learn that a
        # compact dark blob attached to a stick/foot is not a puck
        # (generator-B skate blades and stick blades drew confident
        # false fires, logs/diag_puck_b)
        if rng.uniform() < 0.8:
            cv2.ellipse(img, (int(sx), int(sy)),
                        (max(int(hpx * 0.045), 1), max(int(hpx * 0.02), 1)),
                        0, 0, 360, dark, -1, lineType=cv2.LINE_AA)
    ext = []
    # legs / skates
    for side in (-1, 1):
        lx = fx + side * w * 0.18
        ext.append(seg(0.62, 0.97, 0.18,
                       pants if is_goalie else (40, 40, 40)))
        cv2.rectangle(img, (int(lx - w * 0.14), int(fy - hpx * 0.06)),
                      (int(lx + w * 0.14), int(fy)), dark, -1)
        # skate BLADE sliver below the boot (same hard-negative family)
        cv2.ellipse(img, (int(lx), int(fy)),
                    (max(int(w * 0.17), 1), max(int(hpx * 0.012), 1)),
                    0, 0, 360, (15, 14, 14), -1, lineType=cv2.LINE_AA)
    ext.append(seg(0.42, 0.66, 0.5, pants))       # pants
    ext.append(seg(0.14, 0.46, 1.0, jersey))      # torso
    if style is not None and style["round"]:
        # rounded silhouette family: AA ellipse overlays soften the
        # trapezoid edges (domain randomization, see sample_style)
        tcx = cxt + (fx - cxt) * 0.30
        cv2.ellipse(img, (int(tcx), int(top + 0.30 * hpx)),
                    (max(int(w * 0.55), 1), max(int(hpx * 0.17), 1)),
                    0, 0, 360, jersey, -1, lineType=cv2.LINE_AA)
        hcx = cxt + (fx - cxt) * 0.54
        cv2.ellipse(img, (int(hcx), int(top + 0.54 * hpx)),
                    (max(int(w * 0.33), 1), max(int(hpx * 0.12), 1)),
                    0, 0, 360, pants, -1, lineType=cv2.LINE_AA)
    if is_goalie and style is not None and style["goalie_pads"]:
        pad = (int(rng.uniform(185, 245)),) * 3
        for side in (-1, 1):
            lx = fx + side * w * 0.18
            cv2.line(img, (int(lx), int(fy - 0.42 * hpx)),
                     (int(lx), int(fy - 0.04 * hpx)), pad,
                     max(1, int(w * 0.3)), lineType=cv2.LINE_AA)
    # arms
    dark_limbs = style is not None and style["dark_limbs"]
    for side in (-1, 1):
        ax = cxt + side * w * rng.uniform(0.55, 0.8)
        pts = np.asarray([
            [cxt + side * w * 0.4, top + 0.18 * hpx],
            [ax, top + rng.uniform(0.3, 0.5) * hpx],
        ], np.float32)
        if dark_limbs:
            # generator-B-style limb context: thick dark AA capsule arm
            # (see sample_style "dark_limbs" note)
            lg = int(rng.uniform(12, 45))
            arm_color = (lg, lg, int(lg * rng.uniform(0.9, 1.3)))
            arm_th = max(1, int(hpx * 0.07 * style["limb_w"]))
            cv2.line(img, tuple(pts[0].astype(int)),
                     tuple(pts[1].astype(int)), arm_color, arm_th,
                     lineType=cv2.LINE_AA)
        else:
            arm_color = None
            cv2.line(img, tuple(pts[0].astype(int)),
                     tuple(pts[1].astype(int)), jersey,
                     max(1, int(hpx * 0.07)))
        # GLOVE: dark hand blob at the arm end — the densest puck false-
        # fire source on generator B (every actor carries two of them at
        # 0.85-0.93 confidence, logs/diag_puck_b); same contextual
        # hard-negative family as the stick/skate blades. Shape-randomized
        # (circle / capsule / rotated ellipse): a circle-only negative did
        # not transfer to B's elongated capsule mitts, which look exactly
        # like an elongated-ellipse puck (hn retrain: B mAP 0.11 -> 0.10)
        if rng.uniform() < 0.85:
            gl = int(rng.uniform(14, 40))
            gc = (gl, gl, gl) if arm_color is None else arm_color
            gx, gy = int(pts[1, 0]), int(pts[1, 1])
            r = max(int(hpx * rng.uniform(0.03, 0.08)), 1)
            if dark_limbs and style["mitt_merge"]:
                # mitt continuous with the dark arm (B's exact geometry:
                # a wider round-capped capsule extending the forearm)
                d = pts[1] - pts[0]
                nrm = float(np.linalg.norm(d)) + 1e-6
                tip = pts[1] + d / nrm * r * rng.uniform(1.0, 2.2)
                cv2.line(img, (gx, gy), (int(tip[0]), int(tip[1])), gc,
                         max(int(r * rng.uniform(1.6, 2.6)), 2),
                         lineType=cv2.LINE_AA)
                ext.append([min(pts[0, 0], pts[1, 0]), pts[0, 1],
                            max(pts[0, 0], pts[1, 0]), pts[1, 1]])
                continue
            shape = rng.uniform()
            if shape < 0.35:
                cv2.circle(img, (gx, gy), r, gc, -1, lineType=cv2.LINE_AA)
            elif shape < 0.75:  # capsule mitt (thick round-capped line)
                ang = rng.uniform(0, np.pi)
                dx = np.cos(ang) * r * rng.uniform(0.8, 1.8)
                dy = np.sin(ang) * r * rng.uniform(0.4, 1.0)
                cv2.line(img, (int(gx - dx), int(gy - dy)),
                         (int(gx + dx), int(gy + dy)), gc,
                         max(2 * r, 1), lineType=cv2.LINE_AA)
            else:  # rotated ellipse blob (the puck's own silhouette)
                cv2.ellipse(img, (gx, gy),
                            (max(int(r * rng.uniform(1.2, 1.8)), 1),
                             max(int(r * rng.uniform(0.5, 0.9)), 1)),
                            rng.uniform(0, 180), 0, 360, gc, -1,
                            lineType=cv2.LINE_AA)
        ext.append([min(pts[0, 0], pts[1, 0]), pts[0, 1],
                    max(pts[0, 0], pts[1, 0]), pts[1, 1]])
    # head + helmet
    hr = hpx * 0.085
    hy = top + 0.08 * hpx
    cv2.circle(img, (int(cxt), int(hy)), int(max(hr, 1)), skin, -1)
    cv2.ellipse(img, (int(cxt), int(hy - hr * 0.25)),
                (int(max(hr, 1)), int(max(hr * 0.8, 1))), 0, 180, 360,
                dark if rng.uniform() < 0.8 else (180, 30, 30), -1)
    ext.append([cxt - hr, top, cxt + hr, hy + hr])
    # jersey number
    if number is not None and hpx > 26:
        scale = hpx / 110.0
        cv2.putText(img, str(number),
                    (int(cxt - w * 0.28), int(top + 0.36 * hpx)),
                    cv2.FONT_HERSHEY_SIMPLEX, scale,
                    (255, 255, 255) if sum(jersey) < 380 else (20, 20, 20),
                    max(1, int(2 * scale)))
    if ghost:  # motion-blur ghosting: blend a trailing copy
        cv2.addWeighted(alpha_img, 0.45, img, 0.55, 0, dst=img)

    e = np.asarray(ext, np.float32)
    return [float(e[:, 0].min()), float(e[:, 1].min()),
            float(e[:, 2].max()), float(e[:, 3].max())]


def _draw_player_capsule(img, foot: Tuple[float, float], hpx: float,
                         jersey, pants, rng: np.random.Generator,
                         number: Optional[int] = None,
                         is_goalie: bool = False, ghost: bool = False,
                         style: Optional[Dict] = None) -> List[float]:
    """Articulated ellipse/capsule figure (round-4 body-shape family).

    Same contract as _draw_player: draws at `foot` (bottom-center),
    `hpx` tall, returns the body extent [x1, y1, x2, y2] (stick
    excluded). Proportions and articulation are an independent
    parameterization — generator B (scenes_b.py) remains unseen
    eval-only code. The contextual puck hard negatives (stick blade,
    skate blades, shape-randomized mitts) carry over so the capsule
    family trains the same "dark blob attached to a body is not a
    puck" prior the trapezoid family does."""
    import cv2

    fx, fy = foot
    slope = rng.uniform(-0.16, 0.16)        # skating lean (top shift/h)
    bw = hpx * (0.56 if is_goalie else 0.40) * rng.uniform(0.88, 1.18)
    if style is not None:
        bw *= style["wmul"]
    top = fy - hpx
    skin = (int(rng.uniform(120, 200)),) * 3
    dark = (24, 24, 28)
    leg = pants if is_goalie else (38, 38, 42)

    def at(up: float, dx: float = 0.0) -> Tuple[float, float]:
        """Point `up` body-fractions above the feet, lean applied."""
        return fx + slope * up * hpx + dx, fy - up * hpx

    def cap(p0, p1, w, color):
        """Round-capped thick segment (capsule)."""
        cv2.line(img, (int(p0[0]), int(p0[1])), (int(p1[0]), int(p1[1])),
                 color, max(int(w), 1), lineType=cv2.LINE_AA)

    alpha_img = img.copy() if ghost else None
    ext: List[List[float]] = []

    # stick (behind the body; excluded from the extent box)
    if not is_goalie and rng.uniform() < 0.9:
        hold = at(0.40, rng.choice([-1, 1]) * bw * 0.6)
        sx = fx + rng.choice([-1, 1]) * rng.uniform(0.3, 0.9) * hpx
        sy = fy - rng.uniform(-0.02, 0.08) * hpx
        stick = dark
        if rng.uniform() < 0.5:
            sg = int(rng.uniform(30, 90))
            stick = (sg, int(sg * rng.uniform(1.0, 1.3)),
                     int(sg * rng.uniform(1.0, 1.4)))
        cap(hold, (sx, sy), hpx * 0.03, stick)
        if rng.uniform() < 0.8:  # stick-blade hard negative
            cv2.ellipse(img, (int(sx), int(sy)),
                        (max(int(hpx * 0.045), 1), max(int(hpx * 0.02), 1)),
                        0, 0, 360, dark, -1, lineType=cv2.LINE_AA)

    # legs: thigh + shin capsules with a knee bend, per side
    hip_y = 0.53
    stance = rng.uniform(0.18, 0.55) * bw
    for side, sxo in ((-1, fx - stance), (1, fx + stance)):
        hip = at(hip_y, side * bw * 0.20)
        knee = ((hip[0] + sxo) / 2 + rng.uniform(-0.06, 0.06) * bw,
                fy - rng.uniform(0.22, 0.30) * hpx)
        boot = (sxo, fy - 0.04 * hpx)
        cap(hip, knee, bw * 0.32, leg)
        cap(knee, boot, bw * 0.27, leg)
        cv2.ellipse(img, (int(sxo), int(fy - 0.035 * hpx)),
                    (max(int(bw * 0.24), 1), max(int(hpx * 0.04), 1)),
                    0, 0, 360, dark, -1, lineType=cv2.LINE_AA)
        # skate-blade sliver (hard-negative family)
        cv2.ellipse(img, (int(sxo), int(fy)),
                    (max(int(bw * 0.2), 1), max(int(hpx * 0.012), 1)),
                    0, 0, 360, (15, 14, 14), -1, lineType=cv2.LINE_AA)
        ext.append([sxo - bw * 0.32, fy - 0.32 * hpx, sxo + bw * 0.32, fy])
    if is_goalie and (style is None or style["goalie_pads"]
                      or rng.uniform() < 0.5):
        pad = (int(rng.uniform(185, 245)),) * 3
        for sxo in (fx - stance, fx + stance):
            cap((sxo, fy - 0.46 * hpx), (sxo, fy - 0.05 * hpx),
                bw * 0.40, pad)

    # hips ellipse, then torso as a lean-rotated ellipse
    hc = at(0.50)
    cv2.ellipse(img, (int(hc[0]), int(hc[1])),
                (max(int(bw * 0.58), 1), max(int(hpx * 0.11), 1)),
                np.degrees(np.arctan(slope)) * 0.5, 0, 360, pants, -1,
                lineType=cv2.LINE_AA)
    ext.append([hc[0] - bw * 0.58, hc[1] - 0.11 * hpx,
                hc[0] + bw * 0.58, hc[1] + 0.11 * hpx])
    tc = at(0.66)
    ta = max(int(bw * 0.68), 1)
    tb = max(int(hpx * rng.uniform(0.19, 0.24)), 2)
    cv2.ellipse(img, (int(tc[0]), int(tc[1])), (ta, tb),
                90 + np.degrees(np.arctan(slope)), 0, 360, jersey, -1,
                lineType=cv2.LINE_AA)
    ext.append([tc[0] - tb, tc[1] - tb, tc[0] + tb, tc[1] + tb])

    # arms: shoulder->elbow capsule (jersey), elbow->mitt (dark-limb
    # family), mitt blob from the shared shape-randomized negatives
    dark_limbs = style is not None and style["dark_limbs"]
    limb_w = 1.0 if style is None else style["limb_w"]
    sh = at(0.80)
    for side in (-1, 1):
        elbow = (sh[0] + side * bw * rng.uniform(0.55, 1.0),
                 sh[1] + rng.uniform(0.04, 0.22) * hpx)
        mitt = (elbow[0] + side * bw * rng.uniform(0.0, 0.45),
                elbow[1] + rng.uniform(0.0, 0.14) * hpx)
        if dark_limbs:
            lg = int(rng.uniform(12, 45))
            arm_color = (lg, lg, int(lg * rng.uniform(0.9, 1.3)))
            th = bw * 0.28 * min(limb_w, 2.0)
            cap((sh[0] + side * bw * 0.28, sh[1]), elbow, th, arm_color)
            cap(elbow, mitt, th, arm_color)
            gc = arm_color
        else:
            cap((sh[0] + side * bw * 0.28, sh[1]), elbow, bw * 0.28, jersey)
            gl = int(rng.uniform(14, 40))
            gc = (gl, gl, gl)
            cap(elbow, mitt, bw * 0.24, gc)
        if rng.uniform() < 0.85:  # mitt blob (hard-negative family)
            gx, gy = int(mitt[0]), int(mitt[1])
            r = max(int(hpx * rng.uniform(0.03, 0.08)), 1)
            shape = rng.uniform()
            if dark_limbs and style["mitt_merge"]:
                d = np.asarray(mitt) - np.asarray(elbow)
                nrm = float(np.linalg.norm(d)) + 1e-6
                tip = np.asarray(mitt) + d / nrm * r * rng.uniform(1.0, 2.2)
                cv2.line(img, (gx, gy), (int(tip[0]), int(tip[1])), gc,
                         max(int(r * rng.uniform(1.6, 2.6)), 2),
                         lineType=cv2.LINE_AA)
            elif shape < 0.35:
                cv2.circle(img, (gx, gy), r, gc, -1, lineType=cv2.LINE_AA)
            elif shape < 0.75:
                ang = rng.uniform(0, np.pi)
                dx = np.cos(ang) * r * rng.uniform(0.8, 1.8)
                dy = np.sin(ang) * r * rng.uniform(0.4, 1.0)
                cv2.line(img, (int(gx - dx), int(gy - dy)),
                         (int(gx + dx), int(gy + dy)), gc,
                         max(2 * r, 1), lineType=cv2.LINE_AA)
            else:
                cv2.ellipse(img, (gx, gy),
                            (max(int(r * rng.uniform(1.2, 1.8)), 1),
                             max(int(r * rng.uniform(0.5, 0.9)), 1)),
                            rng.uniform(0, 180), 0, 360, gc, -1,
                            lineType=cv2.LINE_AA)
        ext.append([min(sh[0], mitt[0]) - bw * 0.2, sh[1] - bw * 0.2,
                    max(sh[0], mitt[0]) + bw * 0.2, mitt[1] + bw * 0.2])

    # head + helmet
    hd = at(0.915)
    hr = max(hpx * 0.08, 1.5)
    cv2.circle(img, (int(hd[0]), int(hd[1])), int(hr), skin, -1,
               lineType=cv2.LINE_AA)
    cv2.ellipse(img, (int(hd[0]), int(hd[1] - hr * 0.25)),
                (int(max(hr * 1.05, 1)), int(max(hr * 0.85, 1))), 0, 180,
                360, dark if rng.uniform() < 0.8 else (180, 30, 30), -1,
                lineType=cv2.LINE_AA)
    ext.append([hd[0] - hr * 1.1, top, hd[0] + hr * 1.1, hd[1] + hr])

    if number is not None and hpx > 26:
        scale = hpx / 110.0
        cv2.putText(img, str(number),
                    (int(tc[0] - bw * 0.30), int(tc[1] + tb * 0.30)),
                    cv2.FONT_HERSHEY_SIMPLEX, scale,
                    (255, 255, 255) if sum(jersey) < 380 else (20, 20, 20),
                    max(1, int(2 * scale)))
    if ghost:
        cv2.addWeighted(alpha_img, 0.45, img, 0.55, 0, dst=img)

    e = np.asarray(ext, np.float32)
    return [float(e[:, 0].min()), float(min(e[:, 1].min(), top)),
            float(e[:, 2].max()), float(e[:, 3].max())]


def _team_colors(rng: np.random.Generator):
    """Two distinct team colors (BGR) + pants; occasionally near-white."""
    def col():
        if rng.uniform() < 0.25:
            v = int(rng.uniform(200, 255))
            return (v, v, v)
        c = rng.uniform(0, 255, 3)
        c[int(rng.integers(0, 3))] = rng.uniform(150, 255)  # saturated-ish
        return tuple(int(x) for x in c)

    a = col()
    while True:
        b = col()
        if np.abs(np.asarray(a, float) - b).sum() > 180:
            break
    return a, b



def _scene_background(rng: np.random.Generator, s: int, rink,
                      h: np.ndarray, pts: np.ndarray,
                      width: Optional[int] = None,
                      style: Optional[Dict] = None) -> np.ndarray:
    """Ice + crowd + boards + rink markings (everything that is static
    over a short clip). Shared by render_scene (per-scene) and
    render_scene_sequence (drawn once per clip). `width` enables
    rectangular frames (identical rng sequence when width == s)."""
    import cv2

    w = s if width is None else width
    # --- ice: slightly blue-white gradient + noise (the (1, w, 1)
    # broadcast reproduces the original square layout bit-for-bit)
    base = rng.uniform(215, 242)
    grad = np.linspace(rng.uniform(-12, 0), rng.uniform(0, 10), w)[None, :,
                                                                   None]
    img = np.clip(base + grad + rng.normal(0, 3, (s, w, 1)), 0,
                  255).astype(np.uint8)
    img = np.repeat(img, 3, axis=2)
    img[..., 0] = np.clip(img[..., 0].astype(int) + int(rng.uniform(0, 10)),
                          0, 255).astype(np.uint8)  # cool tint

    # --- crowd above the far boards: coarse colored noise
    far_edge = _project(h, np.asarray(
        [[x, 0.0] for x in np.linspace(0, rink.length, 16)]))
    board_y = int(np.clip(np.median(far_edge[:, 1]), 4, s - 4))
    board_h = max(int(s * rng.uniform(0.04, 0.09)), 4)
    crowd_top = max(board_y - board_h, 0)
    crowd_style = "coarse" if style is None else style["crowd"]
    if crowd_top > 2:
        if crowd_style == "blur":  # soft colored blobs (bokeh crowd)
            blob = rng.integers(10, 150,
                                (max(crowd_top // 14, 1), w // 14, 3),
                                dtype=np.uint8)
            cr = cv2.resize(blob, (w, crowd_top),
                            interpolation=cv2.INTER_LINEAR)
            img[:crowd_top] = cv2.GaussianBlur(cr, (0, 0),
                                               rng.uniform(1.0, 3.0))
        elif crowd_style == "banner":  # horizontal seating tiers
            y = 0
            while y < crowd_top:
                hseg = max(int(rng.uniform(0.02, 0.06) * s), 2)
                img[y:min(y + hseg, crowd_top)] = tuple(
                    int(v) for v in rng.uniform(15, 140, 3))
                y += hseg
        else:
            coarse = rng.integers(15, 130,
                                  (max(crowd_top // 6, 1), w // 6, 3),
                                  dtype=np.uint8)
            img[:crowd_top] = cv2.resize(coarse, (w, crowd_top),
                                         interpolation=cv2.INTER_NEAREST)
    # boards band: pale with colored ad rectangles
    img[crowd_top:board_y] = (230, 228, 224)
    x = 0
    while x < w:
        wseg = int(rng.uniform(0.08, 0.25) * w)
        if rng.uniform() < 0.55:
            col = tuple(int(v) for v in rng.uniform(30, 220, 3))
            cv2.rectangle(img, (x, crowd_top), (x + wseg, board_y), col, -1)
            if style is not None and style["ads_text"] and board_h > 7:
                word = "".join(chr(int(c)) for c in
                               rng.integers(65, 91, int(rng.integers(3, 7))))
                fg = ((245, 245, 245) if sum(col) < 360 else (15, 15, 15))
                cv2.putText(img, word, (x + 3, board_y - max(board_h // 3, 2)),
                            cv2.FONT_HERSHEY_PLAIN,
                            board_h / 22.0, fg, 1, cv2.LINE_AA)
        x += wseg
    cv2.line(img, (0, board_y), (w, board_y), (180, 60, 40), 2)  # kickplate

    # --- rink markings through known keypoint ids (dimensions.py layout)
    blue, red = (170, 90, 30), (60, 50, 190)
    thick = max(1, int(s / 320))
    lt = (cv2.LINE_AA if style is not None and style["aa"]
          else cv2.LINE_8)

    def line(a, b, color, t):
        cv2.line(img, (int(pts[a][0]), int(pts[a][1])),
                 (int(pts[b][0]), int(pts[b][1])), color, t, lineType=lt)

    line(20, 21, blue, 2 * thick)
    line(23, 24, blue, 2 * thick)
    line(26, 27, red, 2 * thick)
    line(0, 1, red, thick)
    line(36, 37, red, thick)
    for c_id, r_id in ((28, 29), (5, 7), (6, 11), (41, 43), (42, 47)):
        c = pts[c_id]
        r = int(np.linalg.norm(pts[r_id] - c))
        if 2 < r < s:
            cv2.circle(img, (int(c[0]), int(c[1])), r, red, thick)
    return img


def render_scene(rng: np.random.Generator, s: int = 640,
                 pucks: bool = False, domain_rand: bool = False
                 ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """One scene. Returns (image uint8 BGR (s, s, 3), boxes xyxy, classes).

    pucks=False: classes are {0: player, 1: goalie} (detector training).
    pucks=True: classes are {0: puck}; players are unlabeled distractors
    (the puck model is single-class, MODEL_ZOO['hockey-puck-detection']).

    domain_rand=True widens the rendering family per sample_style()
    (round-3 sim2real fix); False keeps the legacy style family, though
    not bit-identical to round 2 (the round-3 contextual hard negatives
    draw unconditionally — see _draw_player)."""
    import cv2

    from ..rinkmap.dimensions import NHL, default_keypoint_positions

    rink = NHL
    style = sample_style(rng) if domain_rand else None
    # puck scenes mimic SAHI tiles: tighter zoom so the puck spans several
    # strides (sub-stride objects never bootstrap TAL's iou^6 alignment)
    h, (wx0, wx1) = _homography(
        rng, s, rink, span_range=(0.10, 0.50) if pucks else (0.3, 0.95))
    table = default_keypoint_positions()
    pts = _project(h, table)

    img = _scene_background(rng, s, rink, h, pts, style=style)

    # --- players on the plane, back-to-front
    team_a, team_b = _team_colors(rng)
    pants_a = tuple(int(v) for v in rng.uniform(10, 90, 3))
    pants_b = tuple(int(v) for v in rng.uniform(10, 90, 3))
    hscale = rng.uniform(0.85, 1.2)  # scale jitter on top of perspective

    n = int(rng.integers(4, 15))
    actors = []  # (py, px, kind, team)
    L, W = rink.length, rink.width
    # sample mostly inside the visible window (tight zooms would otherwise
    # render near-empty frames)
    lo, hi = max(wx0 - 8, 2), min(wx1 + 8, L - 2)
    for j in range(n):
        px = rng.uniform(lo, hi) if rng.uniform() < 0.8 \
            else rng.uniform(5, L - 5)
        py = rng.uniform(2, W - 2)
        actors.append((py, px, "player", int(rng.uniform() < 0.5)))
        # occlusion battles: a second player right next to this one
        if rng.uniform() < 0.35:
            actors.append((py + rng.uniform(-2.5, 2.5),
                           px + rng.uniform(-3, 3), "player",
                           int(rng.uniform() < 0.6)))
    for gx in (11.0, L - 11.0):  # goalies at the creases
        if rng.uniform() < 0.6:
            actors.append((W / 2 + rng.uniform(-4, 4),
                           gx + rng.uniform(-2, 2), "goalie", 2))
    if rng.uniform() < 0.4:  # referee (striped, labeled player)
        actors.append((rng.uniform(5, W - 5), rng.uniform(20, L - 20),
                       "ref", 3))

    actors.sort(key=lambda a: _project(h, [[a[1], a[0]]])[0][1])  # far first
    boxes, classes = [], []
    for py, px, kind, team in actors:
        foot = _project(h, [[px, py]])[0]
        hpx = _local_height(h, px, py) * hscale * rng.uniform(0.92, 1.08)
        if hpx < 7 or hpx > 0.95 * s:
            continue
        if not (-0.3 * s < foot[0] < 1.3 * s and 0 < foot[1] < 1.25 * s):
            continue
        if kind == "goalie":
            jersey = team_a if rng.uniform() < 0.5 else (40, 160, 160)
            box = _draw_player(img, tuple(foot), hpx * 1.05, jersey,
                               (30, 30, 30), rng, is_goalie=True,
                               style=style)
            cls = 1
        elif kind == "ref":
            box = _draw_player(img, tuple(foot), hpx, (235, 235, 235),
                               (20, 20, 20), rng,
                               number=None, style=style)
            # stripes
            x1, y1, x2, y2 = (int(v) for v in box)
            for sx in range(x1, x2, max(2, (x2 - x1) // 6)):
                cv2.line(img, (sx, y1 + (y2 - y1) // 5),
                         (sx, y1 + (y2 - y1) // 2), (20, 20, 20), 1)
            cls = 0
        else:
            jersey = team_a if team == 0 else team_b
            pants = pants_a if team == 0 else pants_b
            box = _draw_player(img, tuple(foot), hpx, jersey, pants, rng,
                               number=int(rng.integers(1, 99)),
                               ghost=rng.uniform() < 0.15, style=style)
            cls = 0
        # visibility gate: >= 30% of the body box inside the frame
        cb = [max(box[0], 0), max(box[1], 0), min(box[2], s), min(box[3], s)]
        area = max(cb[2] - cb[0], 0) * max(cb[3] - cb[1], 0)
        full = (box[2] - box[0]) * (box[3] - box[1])
        if full <= 0 or area / full < 0.3 or area < 16:
            continue
        if not pucks:
            boxes.append(cb)
            classes.append(cls)

    # --- puck (and its label, in puck mode)
    if pucks or rng.uniform() < 0.5:
        for _ in range(1 if not pucks else int(rng.integers(1, 3))):
            px = rng.uniform(max(wx0, 8), min(wx1, L - 8))
            py = rng.uniform(2, W - 2)
            c = _project(h, [[px, py]])[0]
            hpx = _local_height(h, px, py)
            pr = max(hpx * 0.06, 2.0)
            if style is not None:
                # puck SIZE family (round 4, measured root cause): the
                # legacy geometry only ever draws 8-16 px pucks (p10-max
                # over 60 scenes), while generator-B val pucks are ~34 px
                # and B broadcast-sequence pucks ~50 px — the shipped
                # detector was SILENT on them (0 candidates above 0.03
                # anywhere in the frame). Cover ~8-60 px so close-up
                # pucks are in-distribution.
                pr *= rng.uniform(0.8, 4.0)
            if not (0 < c[0] < s and 0 < c[1] < s):
                continue
            cv2.ellipse(img, (int(c[0]), int(c[1])),
                        (int(max(pr * 1.6, 2)), int(max(pr, 1))), 0, 0, 360,
                        (20, 18, 18), -1)
            if style is not None:
                # puck appearance family: aspect/darkness variation and
                # an edge-lit top face (broadcast pucks read two-tone)
                if rng.uniform() < 0.5:
                    lit = int(rng.uniform(40, 75))
                    cv2.ellipse(img, (int(c[0]),
                                      int(c[1] - max(pr, 1) * 0.35)),
                                (int(max(pr * 1.3, 1)),
                                 int(max(pr * 0.45, 1))), 0, 0, 360,
                                (lit, lit, lit), -1,
                                lineType=cv2.LINE_AA)
            if pucks:
                boxes.append([c[0] - 2 * pr, c[1] - 1.5 * pr,
                              c[0] + 2 * pr, c[1] + 1.5 * pr])
                classes.append(0)

    # --- glare patches
    for _ in range(int(rng.integers(0, 3))):
        overlay = img.copy()
        cv2.ellipse(overlay,
                    (int(rng.uniform(0, s)), int(rng.uniform(0, s))),
                    (int(rng.uniform(0.1, 0.4) * s),
                     int(rng.uniform(0.05, 0.2) * s)),
                    int(rng.uniform(0, 180)), 0, 360, (255, 255, 255), -1)
        cv2.addWeighted(overlay, rng.uniform(0.08, 0.3), img,
                        1 - rng.uniform(0.08, 0.3), 0, dst=img)

    # --- global motion blur / lighting / sensor noise / JPEG artifacts
    if rng.uniform() < 0.35:
        k = int(rng.integers(3, 8))
        kern = np.zeros((k, k), np.float32)
        ang = rng.uniform(0, np.pi)
        cv2.line(kern, (0, int((k - 1) * (0.5 - 0.5 * np.sin(ang)))),
                 (k - 1, int((k - 1) * (0.5 + 0.5 * np.sin(ang)))), 1.0, 1)
        img = cv2.filter2D(img, -1, kern / max(kern.sum(), 1))
    gain = rng.uniform(0.75, 1.15)
    bias = rng.uniform(-18, 12)
    img = np.clip(img.astype(np.float32) * gain + bias, 0, 255)
    if style is not None:  # domain-randomized photometric family
        if style["vignette"]:
            yy, xx = np.mgrid[0:img.shape[0], 0:img.shape[1]]
            r2 = (((xx / img.shape[1]) - 0.5) ** 2
                  + ((yy / img.shape[0]) - 0.5) ** 2) * 4.0
            img = img * (1.0 - style["vignette"] * r2)[..., None]
        img[..., 2] = img[..., 2] * (1.0 + style["cast"])
        img[..., 0] = img[..., 0] * (1.0 - style["cast"])
        if style["banding"]:
            band = np.sin(np.arange(img.shape[0]) * rng.uniform(0.05, 0.6)
                          + rng.uniform(0, 7)) * rng.uniform(0.5, 3.0)
            img = img + band[:, None, None]
        img = np.clip(img, 0, 255)
    img = np.clip(img + rng.normal(0, rng.uniform(1, 6), img.shape),
                  0, 255).astype(np.uint8)
    if rng.uniform() < 0.6:
        q = int(rng.integers(35, 92))
        ok, enc = cv2.imencode(".jpg", img,
                               [int(cv2.IMWRITE_JPEG_QUALITY), q])
        if ok:
            img = cv2.imdecode(enc, cv2.IMREAD_COLOR)

    return (img, np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32))


def render_scene_sequence(rng: np.random.Generator, s: int = 640,
                          n_frames: int = 96, fps: float = 30.0,
                          span_range=(0.45, 0.8),
                          include_puck: bool = False,
                          width: Optional[int] = None):
    """Temporally-coherent broadcast-like clip for END-TO-END quality
    measurement (tracking stability, team accuracy) — the per-frame
    render_scene distribution, but with a fixed camera/teams and players
    skating smoothly between frames.

    Returns (frames, labels): frames = list of (s, s, 3) uint8 BGR;
    labels[t] = dict(boxes (N,4) xyxy, classes (N,), track_ids (N,),
    team_ids (N,), rink_xy (N,2) gt rink positions (ft), camera_h (3,3)
    the true rink->image homography) with stable per-actor track_ids.
    team_ids: 0/1 = the two teams, 2 = goalie.

    include_puck=True adds a puck skating between players (fast pass
    segments, board bounces), drawn at its depth position so nearer
    players naturally occlude it; labels gain puck_xy (2,) image px,
    puck_rink (2,) ft, and puck_visible (whether the drawn puck
    survived later overdraw — measured by pixel comparison, not
    geometry).

    width=1920 with s=1080 renders true-1080p rectangular frames (the
    bench clip); None keeps the square default with an identical rng
    sequence."""
    import cv2

    from ..rinkmap.dimensions import NHL, default_keypoint_positions

    rink = NHL
    fw = s if width is None else width  # frame width in px
    h, (wx0, wx1) = _homography(rng, s, rink, span_range=span_range,
                                width=width)
    pts = _project(h, default_keypoint_positions())
    background = _scene_background(rng, s, rink, h, pts, width=width)

    team_a, team_b = _team_colors(rng)
    pants_a = tuple(int(v) for v in rng.uniform(10, 90, 3))
    pants_b = tuple(int(v) for v in rng.uniform(10, 90, 3))
    hscale = rng.uniform(0.9, 1.1)
    L, W = rink.length, rink.width
    lo, hi = max(wx0 - 5, 2), min(wx1 + 5, L - 2)

    actors = []
    n = int(rng.integers(6, 12))
    for j in range(n):
        actors.append({
            "px": rng.uniform(lo, hi), "py": rng.uniform(3, W - 3),
            "vx": rng.uniform(-6, 6), "vy": rng.uniform(-4, 4),
            "kind": "player", "team": int(rng.uniform() < 0.5),
            "number": int(rng.integers(1, 99)),
            "hjit": rng.uniform(0.94, 1.06),
        })
    for gx in (11.0, L - 11.0):
        if lo - 6 < gx < hi + 6:
            actors.append({
                "px": gx + rng.uniform(-1, 1),
                "py": W / 2 + rng.uniform(-3, 3),
                "vx": rng.uniform(-0.5, 0.5), "vy": rng.uniform(-1, 1),
                "kind": "goalie", "team": 2, "number": None,
                "hjit": rng.uniform(0.96, 1.04),
            })
    gain = rng.uniform(0.85, 1.1)
    bias = rng.uniform(-10, 8)

    puck = None
    if include_puck:
        puck = {
            "px": rng.uniform(lo + 5, hi - 5),
            "py": rng.uniform(10, W - 10),
            "vx": rng.uniform(-30, 30), "vy": rng.uniform(-20, 20),
            "target": None, "dwell": 0,
        }

    frames, labels = [], []
    for t in range(n_frames):
        img = background.copy()
        order = sorted(actors, key=lambda a: _project(
            h, [[a["px"], a["py"]]])[0][1])  # far first
        # puck inserted at its depth position: nearer players occlude it
        puck_xy = None
        puck_patch = None
        if puck is not None:
            pc = _project(h, [[puck["px"], puck["py"]]])[0]
            if 1 < pc[0] < fw - 2 and 1 < pc[1] < s - 2:
                puck_xy = pc
        drew_puck = False
        boxes, classes, tids, teams = [], [], [], []
        rink_xy, numbers = [], []
        for a in order:
            if (puck_xy is not None and not drew_puck
                    and _project(h, [[a["px"], a["py"]]])[0][1]
                    > puck_xy[1]):
                puck_patch = _draw_puck(img, h, puck, puck_xy, s, fw)
                drew_puck = True
            foot = _project(h, [[a["px"], a["py"]]])[0]
            hpx = _local_height(h, a["px"], a["py"]) * hscale * a["hjit"]
            if hpx < 7 or hpx > 0.95 * s:
                continue
            if not (-0.3 * fw < foot[0] < 1.3 * fw
                    and 0 < foot[1] < 1.25 * s):
                continue
            if a["kind"] == "goalie":
                box = _draw_player(img, tuple(foot), hpx * 1.05, team_a,
                                   (30, 30, 30), rng, is_goalie=True)
                cls = 1
            else:
                jersey = team_a if a["team"] == 0 else team_b
                pants = pants_a if a["team"] == 0 else pants_b
                box = _draw_player(img, tuple(foot), hpx, jersey, pants,
                                   rng, number=a["number"])
                cls = 0
            cb = [max(box[0], 0), max(box[1], 0),
                  min(box[2], fw), min(box[3], s)]
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
        if puck_xy is not None and not drew_puck:  # puck nearest of all
            puck_patch = _draw_puck(img, h, puck, puck_xy, s, fw)
        puck_visible = False
        if puck_patch is not None:
            y0, y1, x0, x1, ref = puck_patch
            same = (img[y0:y1, x0:x1] == ref).all(axis=2).mean()
            puck_visible = bool(same >= 0.5)

        img = np.clip(img.astype(np.float32) * gain + bias
                      + rng.normal(0, 2.0, img.shape), 0, 255).astype(np.uint8)
        frames.append(img)
        lab = {
            "boxes": np.asarray(boxes, np.float32).reshape(-1, 4),
            "classes": np.asarray(classes, np.int32),
            "track_ids": np.asarray(tids, np.int32),
            "team_ids": np.asarray(teams, np.int32),
            "rink_xy": np.asarray(rink_xy, np.float32).reshape(-1, 2),
            "numbers": np.asarray(numbers, np.int32),
            "camera_h": h.copy(),
        }
        if puck is not None:
            lab["puck_xy"] = (None if puck_xy is None
                              else np.asarray(puck_xy, np.float32))
            lab["puck_rink"] = np.asarray([puck["px"], puck["py"]],
                                          np.float32)
            lab["puck_visible"] = puck_visible
        labels.append(lab)

        for a in actors:  # smooth skating with gentle direction drift
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
            _step_puck(puck, actors, rng, fps, lo, hi, W)
    return frames, labels


def _draw_puck(img, h, puck, pc, s, fw=None):
    """Draw the puck at image point `pc`; returns (y0, y1, x0, x1, patch)
    — a copy of the region right after the draw, so later overdraw
    (nearer players) can be detected by pixel comparison."""
    import cv2

    hpx = _local_height(h, puck["px"], puck["py"])
    pr = max(hpx * 0.06, 2.0)
    cv2.ellipse(img, (int(pc[0]), int(pc[1])),
                (int(max(pr * 1.6, 2)), int(max(pr, 1))), 0, 0, 360,
                (20, 18, 18), -1)
    rx, ry = int(max(pr * 1.6, 2)) + 1, int(max(pr, 1)) + 1
    fw = s if fw is None else fw
    y0, y1 = max(int(pc[1]) - ry, 0), min(int(pc[1]) + ry + 1, s)
    x0, x1 = max(int(pc[0]) - rx, 0), min(int(pc[0]) + rx + 1, fw)
    return y0, y1, x0, x1, img[y0:y1, x0:x1].copy()


def _step_puck(puck, actors, rng, fps, lo, hi, W):
    """Puck physics: fast pass segments toward players, short dwells at
    the receiver, board bounces, mild friction."""
    if puck["target"] is None and puck["dwell"] <= 0:
        recv = actors[int(rng.integers(0, len(actors)))]
        puck["target"] = recv
        d = np.asarray([recv["px"] - puck["px"], recv["py"] - puck["py"]])
        dist = float(np.linalg.norm(d)) + 1e-6
        speed = rng.uniform(35.0, 75.0)  # pass speed, ft/s
        puck["vx"], puck["vy"] = (d / dist * speed).tolist()
    puck["px"] += puck["vx"] / fps
    puck["py"] += puck["vy"] / fps
    puck["vx"] *= 0.995
    puck["vy"] *= 0.995
    if puck["target"] is not None:
        tgt = puck["target"]
        if np.hypot(tgt["px"] - puck["px"],
                    tgt["py"] - puck["py"]) < 2.5:
            puck["target"] = None
            puck["dwell"] = int(rng.integers(3, 14))
            # carried: follow the receiver loosely
            puck["vx"], puck["vy"] = tgt["vx"], tgt["vy"]
    elif puck["dwell"] > 0:
        puck["dwell"] -= 1
    if not (lo < puck["px"] < hi):
        puck["vx"] *= -0.9
        puck["px"] = float(np.clip(puck["px"], lo, hi))
    if not (1.5 < puck["py"] < W - 1.5):
        puck["vy"] *= -0.9
        puck["py"] = float(np.clip(puck["py"], 1.5, W - 1.5))


class HardSyntheticHockeyDataset:
    """Pool of pre-rendered hard scenes sampled with photometric/flip
    augmentation per access. train/val splits use disjoint seed ranges."""

    augmentable = True  # load() accepts hsv_jitter/flip

    def __init__(self, imgsz: int = 640, seed: int = 0,
                 pool_size: int = 2000, pucks: bool = False,
                 max_gt: int = 64, domain_rand: bool = False):
        self.imgsz = imgsz
        self.seed = seed
        self.pool_size = pool_size
        self.pucks = pucks
        self.max_gt = max_gt
        self.domain_rand = domain_rand
        self._cache: Dict[int, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}

    def __len__(self) -> int:
        return self.pool_size

    def _scene(self, idx: int):
        item = self._cache.get(idx)
        if item is None:
            rng = np.random.default_rng(
                (self.seed + 1) * 1_000_003 + idx * 7919 + self.pucks)
            item = render_scene(rng, self.imgsz, pucks=self.pucks,
                                domain_rand=self.domain_rand)
            self._cache[idx] = item
        return item

    def pregenerate(self, workers: int = 8) -> None:
        """Fill the pool up front with a thread pool: cv2 and numpy release
        the GIL for the heavy ops, and a scene depends only on (seed,
        index), never on the thread that rendered it."""
        import concurrent.futures as cf

        missing = [i for i in range(self.pool_size) if i not in self._cache]
        if not missing:
            return
        with cf.ThreadPoolExecutor(max_workers=workers) as ex:
            for idx, item in zip(missing, ex.map(
                    _render_for,
                    [(self.seed, i, self.imgsz, self.pucks,
                      self.domain_rand) for i in missing])):
                self._cache[idx] = item

    def save_cache(self, path: str) -> None:
        """Persist the rendered pool (uint8 images + labels) so training
        restarts skip the ~10-minute re-render."""
        import io

        n = self.pool_size
        imgs = np.stack([self._scene(i)[0] for i in range(n)])
        nb = [self._scene(i)[1] for i in range(n)]
        nc = [self._scene(i)[2] for i in range(n)]
        counts = np.asarray([len(b) for b in nb], np.int32)
        m = int(counts.max()) if n else 0
        boxes = np.zeros((n, m, 4), np.float32)
        classes = np.zeros((n, m), np.int32)
        for i, (b, c) in enumerate(zip(nb, nc)):
            boxes[i, : len(b)] = b
            classes[i, : len(c)] = c
        buf = io.BytesIO()
        np.savez(buf, images=imgs, boxes=boxes, classes=classes,
                 counts=counts)
        with open(path, "wb") as f:
            f.write(buf.getvalue())

    def load_cache(self, path: str) -> bool:
        import os

        if not os.path.exists(path):
            return False
        with np.load(path, allow_pickle=False) as z:
            counts = z["counts"]
            if len(counts) != self.pool_size:
                return False
            # materialize each array ONCE: every z[key] access decompresses
            # the full array again, and slice views pin each fresh copy
            images, boxes, classes = z["images"], z["boxes"], z["classes"]
        for i in range(self.pool_size):
            k = int(counts[i])
            self._cache[i] = (images[i], boxes[i][:k], classes[i][:k])
        return True

    def load(self, idx: int, hsv_jitter: Optional[np.random.Generator] = None,
             flip: bool = False) -> Dict[str, np.ndarray]:
        from .data import hsv_augment, pad_targets

        img, boxes, classes = self._scene(idx % self.pool_size)
        boxes = boxes.copy()
        if flip:
            img = img[:, ::-1].copy()
            if len(boxes):
                x1 = self.imgsz - boxes[:, 2].copy()
                boxes[:, 2] = self.imgsz - boxes[:, 0]
                boxes[:, 0] = x1
        if hsv_jitter is not None:
            img = hsv_augment(img, hsv_jitter)
        b, c, m = pad_targets(boxes, classes, self.max_gt)
        return {"images": img.astype(np.float32) / 255.0,
                "boxes": b, "classes": c, "mask": m}


def _render_for(args):
    seed, idx, imgsz, pucks, domain_rand = args
    rng = np.random.default_rng((seed + 1) * 1_000_003 + idx * 7919 + pucks)
    return render_scene(rng, imgsz, pucks=pucks, domain_rand=domain_rand)
