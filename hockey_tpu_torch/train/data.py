"""Validation data: YOLO-format directories and pre-rendered pools.

Port of the inference half of hockey_tpu/train/data.py (`MAX_GT`,
`load_yolo_labels`, `pad_targets`, `YoloDataset` without its HSV
jitter and flip), plus `PoolDataset`, the reader of the pools the JAX package's
scene generators write (`HardSyntheticHockeyDataset.save_cache`,
hockey_tpu/train/scenes.py:1062-1082; scripts/render_val_set.py writes
the validation sets in that format). The scene renderers and the training
augmentations (`mosaic4`, `mixup`, `hsv_augment`, `batch_iterator`) are
not ported: they belong to training.

Items are dicts of numpy arrays: 'images' (S, S, 3) f32 in [0, 1] and the
ground truth padded to `max_gt` rows, 'boxes' (M, 4) xyxy px, 'classes'
(M,) int32 and 'mask' (M,) bool; a rink pool's items also hold
'keypoints' (1, 56, 3). `cv2` is imported inside the functions that read
image files.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

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

    def load(self, idx: int) -> Dict[str, np.ndarray]:
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
    pool's item also holds the image's keypoints as (1, 56, 3)."""

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

    def load(self, idx: int) -> Dict[str, np.ndarray]:
        k = int(self.counts[idx])
        b, c, m = pad_targets(self.boxes[idx][:k], self.classes[idx][:k],
                              self.max_gt)
        item = {"images": self.images[idx].astype(np.float32) / 255.0,
                "boxes": b, "classes": c, "mask": m}
        if self.keypoints is not None:
            item["keypoints"] = self.keypoints[idx][None]
        return item
