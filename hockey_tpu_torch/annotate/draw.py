"""Host-side frame annotation (boxes or ground ellipses, plain or styled
labels): port of hockey_tpu/annotate/draw.py. OpenCV is imported inside
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


class EllipseAnnotator:
    """Ground-ellipse annotator under each player (sv.EllipseAnnotator,
    interchangeable with BoxAnnotator): the broadcast-style partial
    ellipse at the box's bottom edge."""

    def __init__(self, palette: Palette, thickness: int = 2):
        self.palette = palette
        self.thickness = thickness

    def annotate(self, scene: np.ndarray, boxes: np.ndarray,
                 color_lookup: Optional[np.ndarray] = None) -> np.ndarray:
        import cv2

        for i, b in enumerate(np.asarray(boxes).astype(np.int32)):
            color = self.palette.by_idx(
                color_lookup[i] if color_lookup is not None else 0)
            cx = (b[0] + b[2]) // 2
            w = max(b[2] - b[0], 2)
            cv2.ellipse(scene, (int(cx), int(b[3])),
                        (int(w * 0.6), int(w * 0.22)), 0.0, -45.0, 235.0,
                        color, self.thickness, cv2.LINE_AA)
        return scene


class StyledLabelAnnotator(LabelAnnotator):
    """Rounded, alpha-blended label chips with an accent bar; same call
    signature as LabelAnnotator."""

    def __init__(self, *args, alpha: float = 0.75, corner_radius: int = 6,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.alpha = alpha
        self.radius = corner_radius

    def annotate(self, scene, boxes, labels, color_lookup=None):
        import cv2

        overlay = scene.copy()
        geom = []
        for i, (b, text) in enumerate(zip(np.asarray(boxes).astype(np.int32),
                                          labels)):
            color = self.palette.by_idx(
                color_lookup[i] if color_lookup is not None else 0)
            (tw, th), _ = cv2.getTextSize(
                text, cv2.FONT_HERSHEY_SIMPLEX, self.scale, self.thickness)
            x1, y1 = int(b[0]), int(b[1])
            x2 = x1 + tw + 2 * self.padding
            ty1 = max(y1 - th - 2 * self.padding, 0)
            r = min(self.radius, (y1 - ty1) // 2, (x2 - x1) // 2)
            cv2.rectangle(overlay, (x1 + r, ty1), (x2 - r, y1), color, -1)
            cv2.rectangle(overlay, (x1, ty1 + r), (x2, y1 - r), color, -1)
            for cx, cy in ((x1 + r, ty1 + r), (x2 - r, ty1 + r),
                           (x1 + r, y1 - r), (x2 - r, y1 - r)):
                cv2.circle(overlay, (cx, cy), r, color, -1)
            cv2.rectangle(overlay, (x1, ty1), (x1 + 3, y1), (255, 255, 255), -1)
            geom.append((x1, y1, text))
        scene = cv2.addWeighted(overlay, self.alpha, scene, 1 - self.alpha, 0)
        for x1, y1, text in geom:
            cv2.putText(scene, text, (x1 + self.padding + 3, y1 - self.padding),
                        cv2.FONT_HERSHEY_SIMPLEX, self.scale, self.text_color,
                        self.thickness, cv2.LINE_AA)
        return scene


def make_annotators(config: Config):
    """Box (or ellipse) + label (or styled label) annotators for
    `config.annotator_style` ('box', 'ellipse' or 'styled')."""
    palette = Palette(config.team_colors)
    style = config.annotator_style
    box_cls = EllipseAnnotator if style == "ellipse" else BoxAnnotator
    label_cls = StyledLabelAnnotator if style == "styled" else LabelAnnotator
    return (
        box_cls(palette, config.annotation_thickness),
        label_cls(palette, text_scale=config.label_text_scale,
                  text_thickness=config.label_text_thickness),
    )
