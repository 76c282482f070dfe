"""Jersey-number OCR, persisted per tracker id: port of
hockey_tpu/ocr/jersey.py (`JerseyNumberReader`).

Backends, in the JAX package's order: easyocr where it is installed
(imported here, at construction), else the digit net of `ocr/digits.py`
with the shipped checkpoint on the reader's device, else none (labels
keep plain tracker ids). A track's number is the argmax of its
confidence-weighted votes over its lifetime.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np

from ..core.device import resolve_device
from . import digits


class JerseyNumberReader:
    def __init__(self, min_confidence: float = 0.5, read_every_n: int = 10,
                 min_crop_height: int = 60, digit_params=None,
                 device="cuda"):
        """`digit_params`: the digit net's parameter tree, None for the
        shipped checkpoint, or False for no digit backend."""
        self.min_confidence = min_confidence
        self.read_every_n = read_every_n
        self.min_crop_height = min_crop_height
        self.numbers: Dict[int, str] = {}
        self.confidences: Dict[int, float] = defaultdict(float)
        self.votes: Dict[int, Dict[str, float]] = defaultdict(
            lambda: defaultdict(float))
        self._since_read: Dict[int, int] = defaultdict(lambda: 10 ** 9)
        self._reader = None
        self.net: Optional[digits.DigitNet] = None
        self.backend = None
        try:
            import easyocr  # optional dependency
        except ImportError:
            easyocr = None
        if easyocr is not None:
            self._reader = easyocr.Reader(["en"], gpu=False, verbose=False)
            self.backend = "easyocr"
        else:
            if digit_params is None:
                digit_params = digits.load_default_params()
            if digit_params not in (None, False):
                self.net = digits.DigitNet.from_params(digit_params).to(
                    resolve_device(device))
                self.backend = "digits"
                # the digit net's gates (hockey_tpu jersey.py:53-67): a
                # vote threshold of 0.45, 48x48 crops from torsos 26 px
                # tall, a read every 5 frames
                self.min_confidence = min(self.min_confidence, 0.45)
                self.min_crop_height = min(self.min_crop_height, 26)
                self.read_every_n = min(self.read_every_n, 5)
        self.available = self.backend is not None

    def observe(self, frame: np.ndarray, boxes: np.ndarray,
                tracker_ids: np.ndarray) -> None:
        """Read the torso crops of the tracks that are due (every
        `read_every_n` frames, torso at least `min_crop_height` px) and
        vote; the digit net reads all of a frame's due crops in one
        forward."""
        if not self.available:
            return
        h, w = frame.shape[:2]
        due_crops, due_tids = [], []
        for b, tid in zip(boxes, tracker_ids):
            tid = int(tid)
            self._since_read[tid] += 1
            if self._since_read[tid] < self.read_every_n:
                continue
            y1, y2 = max(int(b[1]), 0), min(int(b[3]), h)
            x1, x2 = max(int(b[0]), 0), min(int(b[2]), w)
            if y2 - y1 < self.min_crop_height:
                continue
            # the torso, where numbers are
            ty1 = y1 + int((y2 - y1) * 0.2)
            ty2 = y1 + int((y2 - y1) * 0.6)
            crop = frame[ty1:ty2, x1:x2]
            if crop.size == 0:
                continue
            self._since_read[tid] = 0
            if self.backend == "digits":
                due_crops.append(digits.normalize_crop(crop))
                due_tids.append(tid)
                continue
            for _, text, conf in self._reader.readtext(crop,
                                                       allowlist="0123456789"):
                text = text.strip()
                if (text.isdigit() and 1 <= len(text) <= 2
                        and conf >= self.min_confidence):
                    self._vote(tid, text, float(conf))
        if due_crops:
            texts, confs = digits.predict(self.net, np.stack(due_crops))
            for tid, text, conf in zip(due_tids, texts, confs):
                if conf >= self.min_confidence:
                    self._vote(tid, text, float(conf))

    def _vote(self, tid: int, text: str, conf: float) -> None:
        tally = self.votes[tid]
        tally[text] += conf
        self.numbers[tid] = max(tally, key=tally.get)
        self.confidences[tid] = max(self.confidences[tid], conf)

    def get_number(self, tracker_id: int) -> Optional[str]:
        return self.numbers.get(int(tracker_id))

    def drop(self, tracker_id: int) -> None:
        self.numbers.pop(int(tracker_id), None)
        self.confidences.pop(int(tracker_id), None)
        self.votes.pop(int(tracker_id), None)
