"""The comparison of one side's detections with the reference's, frame by
frame.

Detections are matched greedily, the reference's in score order, each to
the unmatched detection of the other side of the same class with the
highest IoU, at IoU MATCH_IOU or more. `match` gives every matched pair's
gaps and every unmatched detection's score; `detection_gaps` reduces
them to the numbers that a cell's checks compare.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

MATCH_IOU = 0.5
# the score band around a cell's floor in which a detection may be on one
# side and not the other: a little over three times the 95th percentile of
# the score gaps of sound bfloat16 runs (0.015), a quarter of the float8
# control's (0.13-0.21)
SCORE_MARGIN = 0.05


def _iou(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    tl = np.maximum(a[:, None, :2], b[None, :, :2])
    br = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.prod(np.clip(br - tl, 0, None), -1)
    area = lambda x: np.prod(np.clip(x[:, 2:] - x[:, :2], 0, None), -1)  # noqa: E731
    return inter / np.maximum(area(a)[:, None] + area(b)[None, :] - inter, 1e-9)


def match(side: Sequence[Dict], ref: Sequence[Dict],
          floor: Optional[float] = None) -> Dict[str, np.ndarray]:
    """Matched pairs' {box: largest coordinate gap in px, score: score gap,
    ref_score: the reference's score} and the unmatched detections'
    scores {unmatched}, over two lists of per-frame {boxes (n, 4), scores
    (n,), classes (n,)}. With the cell's score `floor`, `ref` holds the
    reference's detections down to floor - SCORE_MARGIN, and one of them
    left unmatched counts only from floor + SCORE_MARGIN up: a detection
    within the margin of the floor may be on either side of it."""
    if len(side) != len(ref):
        raise ValueError(f"{len(side)} frames against {len(ref)}")
    box, score, ref_score, unmatched = [], [], [], []
    for s, r in zip(side, ref):
        sb, ss, sc = (np.asarray(s[k], np.float64) for k in ("boxes", "scores", "classes"))
        rb, rs, rc = (np.asarray(r[k], np.float64) for k in ("boxes", "scores", "classes"))
        sb, rb = sb.reshape(-1, 4), rb.reshape(-1, 4)
        iou = _iou(rb, sb) if len(rb) and len(sb) else np.zeros((len(rb), len(sb)))
        iou[rc[:, None] != sc[None, :]] = 0.0
        taken = np.zeros(len(sb), bool)
        for i in np.argsort(-rs, kind="stable"):
            cand = np.where(taken, -1.0, iou[i])
            j = int(np.argmax(cand)) if len(sb) else -1
            if j < 0 or cand[j] < MATCH_IOU:
                if floor is None or rs[i] >= floor + SCORE_MARGIN:
                    unmatched.append(rs[i])
                continue
            taken[j] = True
            box.append(np.abs(rb[i] - sb[j]).max())
            score.append(abs(rs[i] - ss[j]))
            ref_score.append(rs[i])
        unmatched += ss[~taken].tolist()
    return {k: np.asarray(v, np.float64) for k, v in
            (("box", box), ("score", score), ("ref_score", ref_score),
             ("unmatched", unmatched))}


def detection_gaps(side: Sequence[Dict], ref: Sequence[Dict],
                   floor: Optional[float] = None) -> Dict[str, float]:
    """The numbers a cell's checks compare:

    - box_px_p90: the 90th percentile of the matched pairs' largest
      coordinate gaps, in frame px: a fault that moves more than a tenth
      of the boxes shows in it;
    - score_gap_p95: the 95th percentile of the matched pairs' score gaps;
    - unmatched_share: the detections of either side left unmatched (see
      `match` for the floor), over all detections of both sides.

    Widest gaps are not compared: a DFL box whose bin distribution has two
    modes (a player partly behind another) moves by tens of px under
    bfloat16 rounding, on about 1 % of pairs, so the widest gap swings
    from run to run while the bulk of the pairs holds still."""
    m = match(side, ref, floor)
    q = lambda a, p: float(np.quantile(a, p)) if a.size else 0.0  # noqa: E731
    total = 2 * m["box"].size + m["unmatched"].size
    return {"box_px_p90": q(m["box"], 0.9), "score_gap_p95": q(m["score"], 0.95),
            "unmatched_share": m["unmatched"].size / total if total else 0.0}


def spread(side: Sequence[Dict], ref: Sequence[Dict],
           floor: Optional[float] = None) -> Dict[str, List[float]]:
    """Quantiles (50, 75, 90, 95, 99, 100 %) of each of `match`'s arrays
    and their sizes: what the limits are chosen from."""
    m = match(side, ref, floor)
    q = [0.5, 0.75, 0.9, 0.95, 0.99, 1.0]
    out = {k: (np.quantile(v, q).tolist() if v.size else []) for k, v in m.items()}
    out["n"] = [int(v.size) for v in m.values()]
    conf = m["ref_score"] >= 0.5
    out["confident_box"] = np.quantile(m["box"][conf], q).tolist() if conf.any() else []
    out["unmatched_over"] = [int((m["unmatched"] > t).sum()) for t in (0.3, 0.5, 0.7)]
    return out


def padded_rows(boxes, scores, classes, valid) -> List[Dict]:
    """Per-frame detections from padded (B, D, ...) numpy arrays."""
    return [{"boxes": boxes[i][valid[i]], "scores": scores[i][valid[i]],
             "classes": classes[i][valid[i]]} for i in range(len(valid))]
