"""Training and validation data: YOLO-format directories, pre-rendered
pools and the host augmentations.

Port of hockey_tpu/train/data.py (`MAX_GT`, `load_yolo_labels`,
`pad_targets`, `YoloDataset` with its HSV jitter and flip, `mosaic4`,
`mixup`, `hsv_augment`, `batch_iterator`), plus `PoolDataset`, the reader
of the pools the JAX package's scene generators write
(`HardSyntheticHockeyDataset.save_cache`, hockey_tpu/train/scenes.py:
1062-1082; scripts/render_val_set.py writes the validation sets in that
format), which augments as `HardSyntheticHockeyDataset.load` does. The
scene renderers (`SyntheticHockeyDataset`, `SyntheticRinkDataset`,
scenes.py, scenes_b.py) are not ported. The numpy random calls come in
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
