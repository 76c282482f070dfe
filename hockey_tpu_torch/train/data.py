"""Training and validation data: YOLO-format directories, pre-rendered
pools and the host augmentations.

Port of hockey_tpu/train/data.py (`MAX_GT`, `load_yolo_labels`,
`pad_targets`, `YoloDataset` with its HSV jitter and flip, `mosaic4`,
`mixup`, `hsv_augment`, `batch_iterator`), plus `PoolDataset`, the reader
of the pools the JAX package's scene generators write
(`HardSyntheticHockeyDataset.save_cache`, hockey_tpu/train/scenes.py:
1062-1082; scripts/render_val_set.py writes the validation sets in that
format), which augments as `HardSyntheticHockeyDataset.load` does, and
the synthetic datasets: `SyntheticHockeyDataset` (drawn in numpy, no
cv2) and `SyntheticRinkDataset` (cv2; its rich scenes through generator
A, train/scenes.py). The numpy random calls come in
the JAX package's order, so a seed gives the same batches.

`hsv_augment` converts BGR to OpenCV's 8-bit HSV (H in [0, 180)) and back
in numpy (`bgr_to_hsv`, `hsv_to_bgr`: OpenCV's fixed-point and f32
formulas), so it needs no cv2; both equal cv2.cvtColor on every uint8
input (tests/test_torch_train_data.py).

Items are dicts of numpy arrays: 'images' (S, S, 3) f32 in [0, 1] and the
ground truth padded to `max_gt` rows, 'boxes' (M, 4) xyxy px, 'classes'
(M,) int32 and 'mask' (M,) bool; a rink pool's items also hold
'keypoints' (1, 56, 3). `cv2` is imported inside the functions that read
image files.
"""

from __future__ import annotations

import os
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAX_GT = 64


def load_yolo_labels(label_path: str, img_w: int, img_h: int) -> Tuple[np.ndarray, np.ndarray]:
    """One YOLO label file -> (boxes xyxy px, classes)."""
    boxes, classes = [], []
    if os.path.exists(label_path):
        with open(label_path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 5:
                    continue
                c, cx, cy, w, h = int(parts[0]), *map(float, parts[1:5])
                boxes.append([
                    (cx - w / 2) * img_w, (cy - h / 2) * img_h,
                    (cx + w / 2) * img_w, (cy + h / 2) * img_h,
                ])
                classes.append(c)
    return (np.asarray(boxes, np.float32).reshape(-1, 4),
            np.asarray(classes, np.int32))


def pad_targets(boxes: np.ndarray, classes: np.ndarray,
                max_gt: int = MAX_GT) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    n = min(len(boxes), max_gt)
    b = np.zeros((max_gt, 4), np.float32)
    c = np.zeros((max_gt,), np.int32)
    m = np.zeros((max_gt,), bool)
    b[:n] = boxes[:n]
    c[:n] = classes[:n]
    m[:n] = True
    return b, c, m


class YoloDataset:
    """YOLO-format directory dataset (images/ + labels/ siblings), each
    image letterboxed on the host to the `imgsz` square."""

    augmentable = True  # load() accepts hsv_jitter/flip

    def __init__(self, images_dir: str, labels_dir: Optional[str] = None,
                 imgsz: int = 640, max_gt: int = MAX_GT):
        self.images_dir = images_dir
        self.labels_dir = labels_dir or os.path.join(
            os.path.dirname(images_dir.rstrip("/")), "labels")
        self.imgsz = imgsz
        self.max_gt = max_gt
        exts = (".jpg", ".jpeg", ".png", ".bmp")
        self.files: List[str] = sorted(
            f for f in os.listdir(images_dir) if f.lower().endswith(exts))
        if not self.files:
            raise FileNotFoundError(f"no images in {images_dir}")

    def __len__(self) -> int:
        return len(self.files)

    def load(self, idx: int, hsv_jitter: Optional[np.random.Generator] = None,
             flip: bool = False) -> Dict[str, np.ndarray]:
        import cv2

        from ..ops.letterbox import letterbox_params

        name = self.files[idx]
        img = cv2.imread(os.path.join(self.images_dir, name))
        h, w = img.shape[:2]
        boxes, classes = load_yolo_labels(
            os.path.join(self.labels_dir, os.path.splitext(name)[0] + ".txt"), w, h)

        r, nh, nw, pt, pl = letterbox_params(h, w, self.imgsz)
        img = cv2.resize(img, (nw, nh))
        canvas = np.full((self.imgsz, self.imgsz, 3), 114, np.uint8)
        canvas[pt: pt + nh, pl: pl + nw] = img
        if len(boxes):
            boxes = boxes * r + np.asarray([pl, pt, pl, pt], np.float32)
        if flip:
            canvas = canvas[:, ::-1]
            if len(boxes):
                x1 = self.imgsz - boxes[:, 2]
                x2 = self.imgsz - boxes[:, 0]
                boxes[:, 0], boxes[:, 2] = x1, x2
        if hsv_jitter is not None:
            canvas = hsv_augment(canvas, hsv_jitter)
        b, c, m = pad_targets(boxes, classes, self.max_gt)
        return {"images": canvas.astype(np.float32) / 255.0,
                "boxes": b, "classes": c, "mask": m}


class PoolDataset:
    """A pre-rendered pool: an .npz with 'images' (N, S, S, 3) uint8,
    'boxes' (N, M, 4) f32, 'classes' (N, M) int32 and 'counts' (N,) int32,
    the arrays `HardSyntheticHockeyDataset.save_cache` writes, and for a
    rink pool 'keypoints' (N, 56, 3) f32. Optional scalar entries ('name',
    'seed', 'generator') describe how it was rendered. `load(i)` gives the
    item the JAX dataset's `load(i)` gives after `load_cache`; a rink
    pool's item also holds the image's keypoints as (1, 56, 3).

    A detection pool is augmentable: `load(i, hsv_jitter, flip)` flips,
    then jitters, as `HardSyntheticHockeyDataset.load` does (scenes.py:
    1101-1117). A rink pool is not (a flip would need a left-right
    landmark table), as the JAX rink dataset is not."""

    def __init__(self, path: str, max_gt: int = MAX_GT):
        self.path, self.max_gt = path, max_gt
        with np.load(path, allow_pickle=False) as z:
            # each z[key] access decompresses the whole array: read once
            self.images = z["images"]
            self.boxes, self.classes = z["boxes"], z["classes"]
            self.counts = z["counts"]
            self.keypoints = z["keypoints"] if "keypoints" in z.files else None
            self.meta = {k: z[k].item() for k in ("name", "seed", "generator")
                         if k in z.files}
        self.imgsz = int(self.images.shape[1])

    def __len__(self) -> int:
        return len(self.counts)

    @property
    def augmentable(self) -> bool:
        return self.keypoints is None

    def load(self, idx: int, hsv_jitter: Optional[np.random.Generator] = None,
             flip: bool = False) -> Dict[str, np.ndarray]:
        k = int(self.counts[idx])
        img, boxes = self.images[idx], self.boxes[idx][:k].copy()
        if (flip or hsv_jitter is not None) and not self.augmentable:
            raise ValueError(f"{self.path} holds keypoints: it is not augmentable")
        if flip:
            img = img[:, ::-1].copy()
            if len(boxes):
                x1 = self.imgsz - boxes[:, 2].copy()
                boxes[:, 2] = self.imgsz - boxes[:, 0]
                boxes[:, 0] = x1
        if hsv_jitter is not None:
            img = hsv_augment(img, hsv_jitter)
        b, c, m = pad_targets(boxes, self.classes[idx][:k], self.max_gt)
        item = {"images": img.astype(np.float32) / 255.0,
                "boxes": b, "classes": c, "mask": m}
        if self.keypoints is not None:
            item["keypoints"] = self.keypoints[idx][None]
        return item


# ---------------------------------------------------------------------------
# OpenCV's 8-bit BGR <-> HSV (H in [0, 180)) in numpy

_HSV_SHIFT = 12
_I = np.arange(256, dtype=np.float64)
# OpenCV's tables: saturate_cast<int> of (255 << 12) / i and
# (180 << 12) / (6 i), 0 at i = 0 (cvRound: half to even; no entry ties)
_SDIV = np.where(_I > 0, np.rint((255 << _HSV_SHIFT) / np.maximum(_I, 1)),
                 0).astype(np.int64)
_HDIV180 = np.where(_I > 0, np.rint((180 << _HSV_SHIFT) / (6.0 * np.maximum(_I, 1))),
                    0).astype(np.int64)
# (b, g, r) index into (v, v(1-s), v(1-s f), v(1-s(1-f))) per hue sector
_SECTOR = np.asarray([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3],
                      [2, 1, 0]])


def bgr_to_hsv(img: np.ndarray) -> np.ndarray:
    """uint8 BGR (..., 3) -> uint8 HSV as cv2.cvtColor(img,
    cv2.COLOR_BGR2HSV) gives it: OpenCV's fixed-point formula with 12
    fractional bits (RGB2HSV_b)."""
    x = img.astype(np.int64)
    b, g, r = x[..., 0], x[..., 1], x[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    diff = v - np.minimum(np.minimum(b, g), r)
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b, np.where(v == g, b - r + 2 * diff,
                                         r - g + 4 * diff))
    h = (h * _HDIV180[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv_to_bgr(hsv: np.ndarray) -> np.ndarray:
    """uint8 HSV (H in [0, 180)) -> uint8 BGR as cv2.cvtColor(hsv,
    cv2.COLOR_HSV2BGR) gives it on an x86 build: OpenCV's vectorised
    HSV2RGB_b, in f32 with `1 - s * f` fused into one rounding (an FMA,
    done here in f64, where the f32 product is exact) and each channel
    truncated. Equal to cv2 on every uint8 triple with H < 180."""
    f32 = np.float32
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    whole = np.trunc(h)
    h = h - whole
    sector = (whole - np.trunc(whole * f32(1.0 / 6.0)) * f32(6.0)).astype(np.int64)
    one, s64 = f32(1.0), s.astype(np.float64)
    tab = np.stack([v, v * (one - s),
                    v * (1.0 - s64 * h).astype(f32),
                    v * (1.0 - s64 * (one - h)).astype(f32)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTOR[sector], axis=-1) * f32(255.0)
    return np.clip(np.trunc(bgr), 0, 255).astype(np.uint8)


def hsv_augment(img: np.ndarray, rng: np.random.Generator,
                h_gain: float = 0.015, s_gain: float = 0.7,
                v_gain: float = 0.4) -> np.ndarray:
    """ultralytics-style random HSV gains on a uint8 BGR image (notebook
    cell 15: hsv_h/s/v; hockey_tpu data.py:162-173)."""
    gains = rng.uniform(-1, 1, 3) * [h_gain, s_gain, v_gain] + 1
    hsv = bgr_to_hsv(img).astype(np.float32)
    hsv[..., 0] = (hsv[..., 0] * gains[0]) % 180
    hsv[..., 1] = np.clip(hsv[..., 1] * gains[1], 0, 255)
    hsv[..., 2] = np.clip(hsv[..., 2] * gains[2], 0, 255)
    return hsv_to_bgr(hsv.astype(np.uint8))


def mosaic4(items, rng: np.random.Generator, max_gt: int = MAX_GT):
    """4-image mosaic (ultralytics mosaic=1.0, notebook cell 15): paste
    four letterboxed items into the quadrants of a same-size canvas around
    a jittered center, merging their (already-padded) targets."""
    s = items[0]["images"].shape[0]
    canvas = np.full((s, s, 3), 114 / 255.0, np.float32)
    cx = int(rng.uniform(0.35, 0.65) * s)
    cy = int(rng.uniform(0.35, 0.65) * s)
    quads = [(0, 0, cx, cy), (cx, 0, s, cy), (0, cy, cx, s), (cx, cy, s, s)]
    boxes, classes = [], []
    for item, (x1, y1, x2, y2) in zip(items, quads):
        qw, qh = x2 - x1, y2 - y1
        if qw <= 1 or qh <= 1:
            continue
        # random window of the source image the size of the quadrant
        sx = int(rng.integers(0, s - qw + 1))
        sy = int(rng.integers(0, s - qh + 1))
        canvas[y1:y2, x1:x2] = item["images"][sy: sy + qh, sx: sx + qw]
        m = item["mask"]
        b = item["boxes"][m].copy()
        if not len(b):
            continue
        b[:, [0, 2]] = np.clip(b[:, [0, 2]] - sx, 0, qw) + x1
        b[:, [1, 3]] = np.clip(b[:, [1, 3]] - sy, 0, qh) + y1
        keep = ((b[:, 2] - b[:, 0]) > 2) & ((b[:, 3] - b[:, 1]) > 2)
        boxes.append(b[keep])
        classes.append(item["classes"][m][keep])
    if boxes:
        boxes = np.concatenate(boxes)
        classes = np.concatenate(classes)
    else:
        boxes = np.zeros((0, 4), np.float32)
        classes = np.zeros((0,), np.int32)
    b, c, mm = pad_targets(boxes, classes, max_gt)
    return {"images": canvas, "boxes": b, "classes": c, "mask": mm}


def mixup(a, b, rng: np.random.Generator, max_gt: int = MAX_GT):
    """Image mixup (ultralytics mixup=0.15): beta-blend two items and
    union their targets."""
    lam = float(rng.beta(32.0, 32.0))
    img = lam * a["images"] + (1 - lam) * b["images"]
    boxes = np.concatenate([a["boxes"][a["mask"]], b["boxes"][b["mask"]]])
    classes = np.concatenate([a["classes"][a["mask"]], b["classes"][b["mask"]]])
    bb, cc, mm = pad_targets(boxes, classes, max_gt)
    return {"images": img.astype(np.float32), "boxes": bb, "classes": cc,
            "mask": mm}


def batch_iterator(dataset, batch_size: int, steps: int, seed: int = 0,
                   augment: bool = True, mosaic_prob: float = 0.0,
                   mixup_prob: float = 0.0) -> Iterator[Dict[str, np.ndarray]]:
    """Shuffled fixed-shape batches on the host. `mosaic_prob`/`mixup_prob`
    enable the ultralytics-recipe augmentations (notebook cell 15:
    mosaic=1.0, mixup=0.15) per batch item; an augmentable dataset also
    gets a flip (p 0.5) and the HSV jitter on every item."""
    rng = np.random.default_rng(seed)
    n = len(dataset)

    def load_one(i):
        if getattr(dataset, "augmentable", False) and augment:
            return dataset.load(int(i), hsv_jitter=rng,
                                flip=bool(rng.uniform() < 0.5))
        return dataset.load(int(i))

    for _ in range(steps):
        items = []
        for _ in range(batch_size):
            if augment and rng.uniform() < mosaic_prob:
                item = mosaic4([load_one(j) for j in rng.integers(0, n, 4)], rng)
            else:
                item = load_one(int(rng.integers(0, n)))
            if augment and rng.uniform() < mixup_prob:
                item = mixup(item, load_one(int(rng.integers(0, n))), rng)
            items.append(item)
        yield {k: np.stack([it[k] for it in items]) for k in items[0]}


# ---------------------------------------------------------------------------
# The synthetic datasets (hockey_tpu/train/data.py:176-525)

def fill_rectangle(img: np.ndarray, p1, p2, color) -> None:
    """cv2.rectangle(img, p1, p2, color, -1) in numpy: the corners'
    rows and columns inclusive, clipped to the image."""
    h, w = img.shape[:2]
    x1, x2 = sorted((int(p1[0]), int(p2[0])))
    y1, y2 = sorted((int(p1[1]), int(p2[1])))
    if x2 >= 0 and y2 >= 0:  # (a negative slice stop counts from the end)
        img[max(y1, 0): min(y2, h - 1) + 1, max(x1, 0): min(x2, w - 1) + 1] = color


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """cv2.circle(img, center, radius, color, -1) in numpy: OpenCV's
    8-connected midpoint circle (drawing.cpp `Circle` with fill), whose
    rows cy -+ dy span cx -+ dx and rows cy -+ dx span cx -+ dy, clipped
    to the image."""
    h, w = img.shape[:2]
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        for row, half in ((cy - dy, dx), (cy + dy, dx), (cy - dx, dy),
                          (cy + dx, dy)):
            if 0 <= row < h and cx + half >= 0:
                img[row, max(cx - half, 0): min(cx + half, w - 1) + 1] = color
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1  # 0 while inside, -1 once the error passes
        err -= minus & mask
        dx += mask
        minus -= mask & 2


class SyntheticHockeyDataset:
    """Procedural rink frames with player (0) and goalie (1) rectangles:
    the JAX train CLI's default data and the val CLI's `--dataset
    synthetic`. It draws without cv2 (a filled rectangle and a filled
    circle, `fill_rectangle` and `fill_circle`, equal to OpenCV's), so it
    runs on a machine without OpenCV; the draws equal the JAX package's
    for a seed (tests/test_torch_synthetic_data.py)."""

    def __init__(self, imgsz: int = 640, max_gt: int = MAX_GT, seed: int = 0):
        self.imgsz = imgsz
        self.max_gt = max_gt
        self.seed = seed

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(self.seed * 100003 + idx)
        s = self.imgsz
        img = np.full((s, s, 3), 230, np.uint8)
        img += rng.integers(-10, 10, img.shape, dtype=np.int16).astype(np.int8).view(np.uint8) // 8
        n = int(rng.integers(3, 12))
        boxes, classes = [], []
        for j in range(n):
            # player-plausible scales (objects spanning several strides;
            # sub-stride objects make TAL's iou^6 alignment underflow)
            w = int(rng.integers(s // 10, s // 4))
            h = int(w * rng.uniform(1.8, 2.6))
            x = int(rng.integers(0, s - w))
            y = int(rng.integers(0, s - h))
            is_goalie = rng.uniform() < 0.12
            if is_goalie:
                color = (20, 180, 180)
            else:
                color = ((30, 30, 200) if rng.uniform() < 0.5 else (250, 250, 250))
            fill_rectangle(img, (x, y), (x + w, y + h), color)
            fill_circle(img, (x + w // 2, y + h // 6), w // 4, (40, 30, 30))
            boxes.append([x, y, x + w, y + h])
            classes.append(1 if is_goalie else 0)
        b, c, m = pad_targets(np.asarray(boxes, np.float32),
                              np.asarray(classes, np.int32), self.max_gt)
        return {"images": img.astype(np.float32) / 255.0,
                "boxes": b, "classes": c, "mask": m}

    def __len__(self) -> int:
        return 1 << 30


class SyntheticRinkDataset:
    """Procedural rink views for pose-model smoke training: a random
    plausible camera homography projects the 56-keypoint rink table
    (rinkmap/dimensions.py) into the frame; rink lines are drawn through
    the projected landmarks so the network has visual structure to regress.
    Items carry 'keypoints' (1, 56, 3) for the pose loss."""

    def __init__(self, imgsz: int = 128, seed: int = 0, max_gt: int = 4,
                 rich: bool = False):
        from ..rinkmap.dimensions import NHL, default_keypoint_positions

        self.imgsz = imgsz
        self.seed = seed
        self.max_gt = max_gt
        self.table = default_keypoint_positions()
        self.rink = NHL
        # rich=True renders full broadcast context (crowd/boards/ads via
        # scenes._scene_background, player sprites occluding markings,
        # glare + photometric degradation). The round-2 pose model was
        # trained on the sterile default and collapsed out of
        # distribution (generator-B PCK 0.056 vs 1.0 in-distribution);
        # deployed frames always carry this clutter.
        # rich ALSO mixes the camera family 50/50 trapezoid/pinhole
        # (round 4): the legacy trapezoid maps the rink window's
        # top/bottom edges to horizontal image lines — pure vertical
        # perspective — while real broadcast (and generator-B) cameras
        # are oblique. Measured on the shipped model
        # (scripts/diag_rink_b.py, logs/diag_rink_b.json): sterile
        # renders score PCK 0.40 on the trapezoid family vs 0.039 on
        # pinhole homographies; the style cross adds nothing (0.039) —
        # the homography FAMILY is the OOD gap. rich=False keeps the
        # legacy trapezoid-only sampling so existing val pools stay
        # comparable across rounds.
        self.rich = rich

    def __len__(self) -> int:
        return 1 << 30

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        import cv2

        from ..homography.ransac import dlt_homography, project

        rng = np.random.default_rng(self.seed * 99991 + idx)
        s = self.imgsz
        front = None
        cam_draw = rng.uniform() if self.rich else 1.0
        if cam_draw < 0.35:
            h, front = self._broadcast_camera(rng, s)
        elif cam_draw < 0.70:
            h, front = self._pinhole_camera(rng, s)
        else:
            # random camera: a WINDOW of the rink -> jittered trapezoid.
            # Broadcast cameras rarely frame the whole rink; a model trained
            # only on full-rink views regresses keypoints toward the memorized
            # full-rink layout on windowed frames (measured: 88 px mean
            # keypoint error / 16 ft homography error on span-0.82..0.95
            # clips while full-rink PCK was 1.0 — scripts/diag_homography.py)
            d = self.rink
            # 0.42 lower bound covers the e2e harness's windowed-camera family
            # (--span 0.45,0.7, scripts/e2e_homography.py); the round-3 value
            # (0.55) left 0.45-0.55 windows out of distribution
            f = rng.uniform(0.42, 1.0)          # visible fraction of length
            x0 = rng.uniform(0.0, d.length * (1.0 - f))
            x1 = x0 + f * d.length
            rink_corners = np.asarray(
                [[x0, 0], [x1, 0], [x0, d.width], [x1, d.width]], np.float64)
            top_y = rng.uniform(0.03, 0.25) * s
            bot_y = rng.uniform(0.75, 1.25) * s  # near boards may fall below
            top_inset = rng.uniform(0.04, 0.22) * s
            bot_outset = rng.uniform(-0.02, 0.25) * s  # ... and outside
            img_corners = np.asarray([
                [top_inset, top_y], [s - top_inset, top_y],
                [-bot_outset, bot_y], [s + bot_outset, bot_y],
            ], np.float64)
            h = dlt_homography(rink_corners, img_corners)  # rink -> image
        pts = project(h, self.table.astype(np.float64))  # (56, 2)

        if self.rich:
            img = self._rich_scene(rng, s, h, pts)
        else:
            img = np.full((s, s, 3), 225, np.uint8)
            img[...] += rng.integers(0, 8, (s, s, 3), dtype=np.uint8)

            def line(a, b, color, w=1):
                cv2.line(img, (int(pts[a][0]), int(pts[a][1])),
                         (int(pts[b][0]), int(pts[b][1])), color, w)

            # draw structure through known keypoint ids (dimensions.py)
            blue = (160, 90, 30)
            red = (50, 50, 190)
            line(20, 21, blue, 2)   # left blue line
            line(23, 24, blue, 2)   # right blue line
            line(26, 27, red, 2)    # center line
            line(0, 1, red, 1)      # left goal line
            line(36, 37, red, 1)    # right goal line
            for c_id, r_id in ((28, 29), (5, 7), (6, 11), (41, 43),
                               (42, 47)):
                c = pts[c_id]
                r = max(int(np.linalg.norm(pts[r_id] - c)), 2)
                cv2.circle(img, (int(c[0]), int(c[1])), r, red, 1)

        vis = ((pts[:, 0] >= 0) & (pts[:, 0] < s)
               & (pts[:, 1] >= 0) & (pts[:, 1] < s))
        if front is not None:
            # pinhole cameras have a real horizon: plane points behind
            # the camera project mirrored back into the frame — without
            # the cheirality mask they would become poisoned labels
            vis &= front
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
                "classes": classes, "mask": mask,
                "keypoints": kpts}

    def _pinhole_camera(self, rng: np.random.Generator, s: int
                        ) -> Tuple[np.ndarray, np.ndarray]:
        """Oblique 3D pinhole rink camera (round 4). Parameterized by
        explicit elevation/azimuth/roll angles — deliberately a different
        parameterization from generator B's position/look-at camera
        (scenes_b._Camera has no roll and sits strictly behind the y<0
        boards), so generator B remains a valid OOD probe while training
        covers the oblique-homography family the legacy trapezoid misses
        (the trapezoid maps the rink window's top/bottom edges to
        horizontal image lines; measured collapse: PCK 0.40 trapezoid vs
        0.039 pinhole on identical sterile styles, logs/diag_rink_b.json).
        Returns (rink->image homography (3,3), front-of-camera mask (56,))."""
        d = self.rink
        L, W = d.length, d.width
        tx = rng.uniform(0.10 * L, 0.90 * L)    # window center on the ice
        ty = rng.uniform(0.20 * W, 0.80 * W)
        # visible fraction down to 0.18: game cameras zoom into ~40-80 ft
        # action windows. Round 5 measured the 0.42-floor family's PCK on
        # rich renders collapsing 0.37 -> 0.012 the moment f drops below
        # the floor (f 0.25-0.42 probe) — and the generator-B e2e camera
        # (isotropic zoom 0.9-1.3 at 40-120 ft) sits at f ~0.18-0.68, so
        # half its views were out of support (e2e-B family PCK 0.17,
        # scripts/diag_rink_e2eb.py)
        f = rng.uniform(0.18, 1.30)             # visible fraction of length
        # elevation to 80 deg and slant to 320 ft: broadcast catwalk
        # cameras sit high and steep. Round 5 measured the shipped 7-45
        # deg family collapsing on steep whole-sheet views (generator B's
        # camera: height 120-300 ft at 40-120 ft board distance, i.e.
        # ~32-79 deg look-down — PCK 0.159 on B-geometry sterile renders
        # vs 0.68 on training geometry, logs/diag_rink_b.json)
        elev = np.deg2rad(rng.uniform(7.0, 80.0))
        # +-50 deg: a board-side camera aimed 0.25L off-center at 40 ft
        # stands ~51 deg off-perpendicular (generator B's look-at family)
        azim = np.deg2rad(rng.uniform(-50.0, 50.0))
        roll = np.deg2rad(rng.uniform(-7.0, 7.0))
        r = rng.uniform(45.0, 320.0)            # slant distance (ft)
        cam = np.asarray([tx + r * np.cos(elev) * np.sin(azim),
                          ty - r * np.cos(elev) * np.cos(azim),
                          r * np.sin(elev)], np.float64)
        fwd = np.asarray([tx, ty, 0.0]) - cam
        fwd /= np.linalg.norm(fwd)
        up = np.asarray([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        cr, sr = np.cos(roll), np.sin(roll)
        right, down = cr * right + sr * down, -sr * right + cr * down
        rot = np.stack([right, down, fwd])      # world -> camera rows
        # focal: fit the f*L-long window to roughly the frame width
        half = 0.5 * f * L
        ends = np.asarray([[tx - half, ty, 0.0], [tx + half, ty, 0.0]])
        pc = (ends - cam) @ rot.T
        span = max(float(np.abs(pc[:, 0] / np.maximum(pc[:, 2], 1e-6)).max()),
                   1e-6)
        fx = 0.5 * s / span * rng.uniform(0.85, 1.15)
        # anamorphic aspect jitter: broadcast wide shots (and generator
        # B's fit_rink intrinsics, scenes_b.py:73-86) fit length and
        # width to the frame independently, VERTICALLY STRETCHING the
        # foreshortened sheet so it fills the frame (measured fy/fx on
        # the rink-b camera family: 0.91-3.90, median 1.83); an
        # fx==fy-only model treats that stretch as out-of-family.
        # log-uniform so the isotropic neighborhood keeps density
        fy = fx * np.exp(rng.uniform(np.log(0.8), np.log(4.0)))
        k = np.asarray([[fx, 0.0, s / 2.0], [0.0, fy, s / 2.0],
                        [0.0, 0.0, 1.0]])
        h = k @ np.stack([rot[:, 0], rot[:, 1], -rot @ cam], axis=1)
        table3 = np.concatenate(
            [self.table.astype(np.float64),
             np.zeros((len(self.table), 1))], axis=1)
        front = ((table3 - cam) @ rot.T)[:, 2] > 1e-6
        return h, front

    def _broadcast_camera(self, rng: np.random.Generator, s: int
                          ) -> Tuple[np.ndarray, np.ndarray]:
        """Rink-side broadcast look-at camera (round 5). Position/look-at
        parameterized: the camera sits behind one long board (practical
        NHL camera wells/catwalks: 30-130 ft back, 18-100 ft up), aims at
        a point on the ice, with an ISOTROPIC focal (fx == fy) — plain
        broadcast glass has square pixels; zoom is independent of the
        framed window.

        Why this family exists alongside _pinhole_camera: round 5
        measured the extended pinhole family's span-fit focal
        (fx ~ 0.5*s/span) plus log-uniform anamorphic stretch spreading
        density so thin the s-scale model under-fits its OWN family
        (PCK 0.295 on held-out rich pinhole draws) while the deployment
        probes are narrower: the e2e sequence harnesses run isotropic
        position/look-at cameras (train/scenes_b.py:51-96) that the
        hull-shaped pinhole family covers only sparsely. This family
        concentrates density on the deployment geometry; COMPAT #32."""
        d = self.rink
        L, W = d.length, d.width
        tx = rng.uniform(0.12 * L, 0.88 * L)    # aim point on the ice
        ty = rng.uniform(0.20 * W, 0.80 * W)
        cx = tx + rng.uniform(-0.30, 0.30) * L
        cy = -rng.uniform(30.0, 130.0)          # behind the near boards
        cz = rng.uniform(18.0, 100.0)           # camera well .. catwalk
        cam = np.asarray([cx, cy, cz], np.float64)
        fwd = np.asarray([tx, ty, 0.0]) - cam
        fwd /= np.linalg.norm(fwd)
        up = np.asarray([0.0, 0.0, 1.0])
        right = np.cross(fwd, up)
        right /= np.linalg.norm(right)
        down = np.cross(fwd, right)
        roll = np.deg2rad(rng.uniform(-4.0, 4.0))
        cr, sr = np.cos(roll), np.sin(roll)
        right, down = cr * right + sr * down, -sr * right + cr * down
        rot = np.stack([right, down, fwd])      # world -> camera rows
        f = s * rng.uniform(0.85, 3.0)          # isotropic zoom
        k = np.asarray([[f, 0.0, s / 2.0], [0.0, f, s / 2.0],
                        [0.0, 0.0, 1.0]])
        h = k @ np.stack([rot[:, 0], rot[:, 1], -rot @ cam], axis=1)
        table3 = np.concatenate(
            [self.table.astype(np.float64),
             np.zeros((len(self.table), 1))], axis=1)
        front = ((table3 - cam) @ rot.T)[:, 2] > 1e-6
        return h, front

    def _rich_scene(self, rng: np.random.Generator, s: int, h, pts
                    ) -> np.ndarray:
        """Full broadcast context for pose training: scene background
        (ice shade, crowd, boards/ads, markings through the SAME
        keypoint table), player sprites occluding the markings, glare,
        and photometric degradation — generator-A machinery, reused so
        the pose model sees deployment-like clutter."""
        import cv2

        from .scenes import (
            _draw_player,
            _local_height,
            _scene_background,
            _team_colors,
            sample_style,
        )
        from ..homography.ransac import project

        style = sample_style(rng)
        img = _scene_background(rng, s, self.rink, h, pts, style=style)
        team_a, team_b = _team_colors(rng)
        pants = tuple(int(v) for v in rng.uniform(10, 90, 3))
        L, W = self.rink.length, self.rink.width
        actors = [(rng.uniform(2, W - 2), rng.uniform(5, L - 5))
                  for _ in range(int(rng.integers(3, 14)))]
        order = sorted(actors, key=lambda a: project(
            h, np.asarray([[a[1], a[0]]], np.float64))[0][1])
        for py, px in order:
            foot = project(h, np.asarray([[px, py]], np.float64))[0]
            hpx = _local_height(h, px, py) * rng.uniform(0.9, 1.1)
            if hpx < 6 or hpx > 0.6 * s:
                continue
            if not (0 < foot[0] < s and 0 < foot[1] < 1.1 * s):
                continue
            _draw_player(img, tuple(foot), hpx,
                         team_a if rng.uniform() < 0.5 else team_b,
                         pants, rng, style=style)
        for _ in range(int(rng.integers(0, 3))):  # glare
            overlay = img.copy()
            cv2.ellipse(overlay,
                        (int(rng.uniform(0, s)), int(rng.uniform(0, s))),
                        (int(rng.uniform(0.1, 0.4) * s),
                         int(rng.uniform(0.05, 0.2) * s)),
                        int(rng.uniform(0, 180)), 0, 360,
                        (255, 255, 255), -1)
            a = rng.uniform(0.08, 0.3)
            cv2.addWeighted(overlay, a, img, 1 - a, 0, dst=img)
        gain = rng.uniform(0.75, 1.15)
        out = np.clip(img.astype(np.float32) * gain
                      + rng.uniform(-18, 12), 0, 255)
        out = np.clip(out + rng.normal(0, rng.uniform(1, 5), out.shape),
                      0, 255).astype(np.uint8)
        if rng.uniform() < 0.5:
            ok, enc = cv2.imencode(
                ".jpg", out, [int(cv2.IMWRITE_JPEG_QUALITY),
                              int(rng.integers(40, 92))])
            if ok:
                out = cv2.imdecode(enc, cv2.IMREAD_COLOR)
        return out
