"""Host-side frame annotation (boxes + labels): port of
hockey_tpu/annotate/draw.py for the box style. OpenCV is imported inside
the drawing calls only."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..core.config import Config, hex_to_bgr


class Palette:
    """Color palette with per-detection lookup (sv.ColorPalette.from_hex)."""

    def __init__(self, hex_colors: Sequence[str]):
        self.colors: List[Tuple[int, int, int]] = [hex_to_bgr(h) for h in hex_colors]

    def by_idx(self, idx: int) -> Tuple[int, int, int]:
        return self.colors[int(idx) % len(self.colors)]


class BoxAnnotator:
    """Rectangle annotator (reference: sv.BoxAnnotator, thickness 2)."""

    def __init__(self, palette: Palette, thickness: int = 2):
        self.palette = palette
        self.thickness = thickness

    def annotate(self, scene: np.ndarray, boxes: np.ndarray,
                 color_lookup: Optional[np.ndarray] = None) -> np.ndarray:
        import cv2

        for i, b in enumerate(np.asarray(boxes).astype(np.int32)):
            color = self.palette.by_idx(color_lookup[i] if color_lookup is not None else 0)
            cv2.rectangle(scene, (b[0], b[1]), (b[2], b[3]), color, self.thickness)
        return scene


class LabelAnnotator:
    """Filled label boxes above detections (reference: sv.LabelAnnotator
    with white text, padding 5, scale 0.6, thickness 2)."""

    def __init__(self, palette: Palette,
                 text_color: Tuple[int, int, int] = (255, 255, 255),
                 text_padding: int = 5, text_scale: float = 0.6,
                 text_thickness: int = 2):
        self.palette = palette
        self.text_color = text_color
        self.padding = text_padding
        self.scale = text_scale
        self.thickness = text_thickness

    def annotate(self, scene: np.ndarray, boxes: np.ndarray,
                 labels: Sequence[str],
                 color_lookup: Optional[np.ndarray] = None) -> np.ndarray:
        import cv2

        for i, (b, text) in enumerate(zip(np.asarray(boxes).astype(np.int32), labels)):
            color = self.palette.by_idx(color_lookup[i] if color_lookup is not None else 0)
            (tw, th), _ = cv2.getTextSize(
                text, cv2.FONT_HERSHEY_SIMPLEX, self.scale, self.thickness)
            x1, y1 = int(b[0]), int(b[1])
            ty1 = y1 - th - 2 * self.padding
            cv2.rectangle(scene, (x1, max(ty1, 0)),
                          (x1 + tw + 2 * self.padding, y1), color, -1)
            cv2.putText(scene, text, (x1 + self.padding, y1 - self.padding),
                        cv2.FONT_HERSHEY_SIMPLEX, self.scale, self.text_color,
                        self.thickness, cv2.LINE_AA)
        return scene


def make_annotators(config: Config) -> Tuple[BoxAnnotator, LabelAnnotator]:
    """Box + label annotators for `config` (the 'box' style)."""
    if config.annotator_style != "box":
        raise NotImplementedError(
            f"annotator_style {config.annotator_style!r}: the port draws the "
            "'box' style only so far (see ROADMAP.md)")
    palette = Palette(config.team_colors)
    return (
        BoxAnnotator(palette, config.annotation_thickness),
        LabelAnnotator(palette, text_scale=config.label_text_scale,
                       text_thickness=config.label_text_thickness),
    )
