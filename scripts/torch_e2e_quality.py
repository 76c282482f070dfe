#!/usr/bin/env python3
"""End-to-end quality of the port in TEAM_CLASSIFICATION or PLAYER_TRACKING:
the protocol and scoring of scripts/e2e_quality.py, on a clip from
scripts/render_e2e_clip.py.

    python scripts/torch_e2e_quality.py --clip proof/clips/e2e_a.npz \
        [--mode TEAM_CLASSIFICATION|PLAYER_TRACKING] [--device cuda|cpu] \
        [--frame-batch N] [--match-iou 0.5] [--out F]

The port's VideoProcessor(mode=TEAM_CLASSIFICATION) with the shipped
weights and `Config()` at the clip's resolution fits the team classifier
on the clip (`fit_teams`: every 10th frame) and classifies every frame
(`classify_frames`). The route is the pipeline's own: on the CPU with
frame batch 1, frame by frame with the host ByteTrack and crops sampled
from each frame, as e2e_quality.py's `--cpu` run; on CUDA with frame
batch 8, the fused step (detect, NMS kernel, tracker, team features).
Scored against the clip's ground truth:

- detection precision and recall (greedy match by score at IoU 0.5);
- id stability: the share of ground-truth actors tracked under one
  dominant id (>= 90 % of their matches), and the id switches;
- team accuracy, after mapping each ground-truth team to the predicted
  team it got most often (teams_separable: the mapping is one-to-one).

With `--mode PLAYER_TRACKING` there is no fit: `track_frames` runs with
the jersey-number reader, and instead of the team accuracy it reports
`number_accuracy`: the share of numbered ground-truth actors whose
dominant track carries their number at the end of the clip (a clip
rendered with `--imgsz 960 --span 0.28,0.42`, as e2e_quality.py advises).

Prints one JSON line (also written to `--out`). Imports nothing of the
JAX package and no OpenCV, so it runs on the GPU machine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def _iou(a, b):
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    x1 = np.maximum(a[:, None, 0], b[None, :, 0])
    y1 = np.maximum(a[:, None, 1], b[None, :, 1])
    x2 = np.minimum(a[:, None, 2], b[None, :, 2])
    y2 = np.minimum(a[:, None, 3], b[None, :, 3])
    inter = np.clip(x2 - x1, 0, None) * np.clip(y2 - y1, 0, None)
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(aa[:, None] + ab[None] - inter, 1e-9)


def load_clip(path: str):
    """(frames (N, s, s, 3) uint8, per-frame labels dicts)."""
    z = np.load(path)
    offs = np.concatenate([[0], np.cumsum(z["n"])])
    keys = [k for k in ("boxes", "classes", "track_ids", "team_ids", "numbers")
            if k in z]
    labels = [{k: z[k][a:b] for k in keys} for a, b in zip(offs[:-1], offs[1:])]
    return z["frames"], labels


def score(results, labels, match_iou: float, ocr=None) -> dict:
    """e2e_quality.py's scoring of per-frame results (boxes, scores,
    tracker_ids, team_ids) against the ground truth; with the OCR reader
    `ocr` (PLAYER_TRACKING), the number accuracy instead of the team
    accuracy."""
    tp = fp = fn = 0
    matched_ious, id_seen, team_votes, per_actor_team = [], {}, {}, {}
    actor_numbers = {}
    for res, gt in zip(results, labels):
        pb, tids, pteam = res["boxes"], res["tracker_ids"], res["team_ids"]
        m = _iou(np.asarray(pb, np.float64), np.asarray(gt["boxes"], np.float64))
        taken, matched_pred = set(), set()
        for i in np.argsort(-res["scores"]):
            if m.shape[1] == 0:
                break
            j = int(np.argmax(np.where(
                [k in taken for k in range(m.shape[1])], -1.0, m[i])))
            if m[i, j] >= match_iou and j not in taken:
                taken.add(j)
                matched_pred.add(int(i))
                matched_ious.append(float(m[i, j]))
                actor = int(gt["track_ids"][j])
                id_seen.setdefault(actor, []).append(int(tids[i]))
                if "numbers" in gt and gt["numbers"][j] >= 1:
                    actor_numbers[actor] = int(gt["numbers"][j])
                gt_team = int(gt["team_ids"][j])
                if gt_team in (0, 1):
                    tv = team_votes.setdefault(gt_team, {})
                    tv[int(pteam[i])] = tv.get(int(pteam[i]), 0) + 1
                    per_actor_team.setdefault(actor, []).append(
                        (gt_team, int(pteam[i])))
        tp += len(taken)
        fp += len(pb) - len(matched_pred)
        fn += len(gt["boxes"]) - len(taken)

    switches = stable = 0
    for ids in id_seen.values():
        switches += sum(1 for a, b in zip(ids, ids[1:]) if a != b)
        dominant = max(set(ids), key=ids.count)
        stable += ids.count(dominant) / len(ids) >= 0.9
    mapping = {g: max(v, key=v.get) for g, v in team_votes.items()}
    separable = len(set(mapping.values())) == len(mapping)
    correct = total = 0
    if separable:
        for obs in per_actor_team.values():
            for g, pred in obs:
                total += 1
                correct += int(mapping[g] == pred)
    out = {
        "detection_precision": round(tp / max(tp + fp, 1), 4),
        "detection_recall": round(tp / max(tp + fn, 1), 4),
        "id_stability": round(stable / max(len(id_seen), 1), 4),
        "id_switches": switches,
        "actors": len(id_seen),
        "matched_iou_mean": round(float(np.mean(matched_ious)), 4)
        if matched_ious else None,
    }
    if ocr is None:
        out.update({"team_accuracy": round(correct / max(total, 1), 4),
                    "teams_separable": separable})
        return out
    # each numbered actor's dominant track must carry its number at the
    # end of the clip (e2e_quality.py:214-234)
    num_ok, wrong = 0, []
    scored = [(a, n) for a, n in actor_numbers.items() if id_seen.get(a)]
    for actor, number in scored:
        ids = id_seen[actor]
        got = ocr.get_number(max(set(ids), key=ids.count))
        if got is not None and int(got) == number:
            num_ok += 1
        else:
            wrong.append([number, got])
    out.update({"number_accuracy": round(num_ok / max(len(scored), 1), 4),
                "numbered_actors": len(scored), "number_errors": wrong})
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clip", required=True, help="render_e2e_clip.py's .npz")
    p.add_argument("--mode", default="TEAM_CLASSIFICATION",
                   choices=["TEAM_CLASSIFICATION", "PLAYER_TRACKING"])
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--frame-batch", type=int, default=0,
                   help="frames per device step (0: 8 on CUDA, 1 on the CPU)")
    p.add_argument("--match-iou", type=float, default=0.5)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args()

    import torch

    from hockey_tpu_torch.core.config import Config, ProcessingMode
    from hockey_tpu_torch.pipeline import VideoProcessor

    frames, labels = load_clip(args.clip)
    s = frames.shape[1]
    config = Config(detection_imgsz=s, frame_batch=args.frame_batch)
    os.environ["HOCKEY_TPU_HEADLESS"] = "1"
    mode = ProcessingMode(args.mode)
    proc = VideoProcessor(config=config, device=args.device, mode=mode,
                          frame_hw=(s, s), team_names=("TEAM_A", "TEAM_B"))
    out = {"mode": mode.value, "frames": len(frames), "imgsz": s,
           "match_iou": args.match_iou}
    if mode == ProcessingMode.TEAM_CLASSIFICATION:
        t = time.perf_counter()
        out["fit_crops"] = proc.fit_teams(iter(frames))
        out["fit_s"] = round(time.perf_counter() - t, 3)
        steps = proc.classify_frames(iter(frames))
    else:
        steps = proc.track_frames(iter(frames))
    t = time.perf_counter()
    results = [dict(proc.last_frame_result) for _ in steps]
    run_s = time.perf_counter() - t

    out.update(score(results, labels, args.match_iou, ocr=proc.ocr))
    out.update({
        "generator": "a",
        "device": str(proc.device),
        "route": ("fused" if proc.use_fused_tracker else
                  f"host ByteTrack, frame batch "
                  f"{config.resolved_frame_batch(proc.device)}"),
        "run_s": round(run_s, 3),
    })
    if proc.device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
        out["torch"] = torch.__version__
    line = json.dumps(out)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
