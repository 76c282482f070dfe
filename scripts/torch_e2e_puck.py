#!/usr/bin/env python3
"""End-to-end quality of the port in PUCK_DETECTION: the protocol and
scoring of scripts/e2e_puck.py, on a clip from scripts/render_puck_clip.py.

    python scripts/torch_e2e_puck.py --clip proof/clips/puck_a.npz \
        [--device cuda|cpu] [--dtype bf16|f32] [--out F]

The port's VideoProcessor(mode=PUCK_DETECTION) with the shipped puck
weights and `Config()` at the clip's resolution runs `puck_frames` over
the clip in device steps of 8 frames (e2e_puck.py's batch; tiles of 640
with overlap 0.2, per-tile NMS and the cross-tile merge through the
suppression kernel on CUDA), with the puck tracker on the host. The puck
model runs in bf16 by default on either device, as e2e_puck.py's detector
does on every backend (`--dtype f32` for the port's CPU default). Scored
against the clip's ground truth, each frame at its gt-scaled hit radius:

- detection recall: frames where the tracker's selected detection lies
  within the radius of the puck, over the frames where the puck is
  visible; `detection_recall_raw`: the same for the best-scoring
  detection, before the tracker's gate;
- detection precision: selected detections within the radius, over all
  selected detections;
- trajectory MAE and p90: the tracker's smoothed position against the
  puck, over the frames where both exist;
- gap recovery: frames from the end of each occlusion gap until the
  tracker is within the radius again (up to 30).

Prints one JSON line (also written to `--out`). Imports nothing of the JAX package and no OpenCV, so
it runs on the GPU machine.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hockey_tpu_torch.core.config import Config, ProcessingMode  # noqa: E402
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402

BATCH = 8  # frames per device step, as e2e_puck.py's default


def score(results, puck_xy, visible, radii) -> dict:
    """e2e_puck.py's scoring of per-frame PuckResults."""
    det_tp = det_fp = vis_frames = raw_tp = 0
    traj_err, rec = [], []  # rec: (visible, detection close, tracker close)
    for t, r in enumerate(results):
        gt = None if np.isnan(puck_xy[t]).any() else puck_xy[t]
        if visible[t] and len(r.boxes) and gt is not None:
            bb = r.boxes[int(np.argmax(r.scores))]
            c = np.asarray([(bb[0] + bb[2]) / 2, (bb[1] + bb[3]) / 2])
            raw_tp += int(float(np.linalg.norm(c - gt)) <= radii[t])
        det_close = (r.detection is not None and gt is not None
                     and float(np.linalg.norm(np.asarray(r.detection) - gt))
                     <= radii[t])
        if visible[t]:
            vis_frames += 1
            det_tp += int(det_close)
        if r.detection is not None and not det_close:
            det_fp += 1
        tracker_close = False
        if r.center is not None and gt is not None:
            e = float(np.linalg.norm(np.asarray(r.center) - gt))
            traj_err.append(e)
            tracker_close = e <= radii[t]
        rec.append((bool(visible[t]), det_close, tracker_close))

    n_det = sum(1 for _, d, _ in rec if d) + det_fp
    recoveries, t, n = [], 0, len(rec)
    while t < n:
        if not rec[t][0]:  # the start of an invisible gap
            g0 = t
            while t < n and not rec[t][0]:
                t += 1
            if t >= n or t == g0:
                break
            lock = next((dt - t for dt in range(t, min(t + 30, n))
                         if rec[dt][2]), None)
            if lock is not None:
                recoveries.append(lock)
        else:
            t += 1
    return {
        "frames": len(results),
        "visible_frames": vis_frames,
        "detection_recall": round(det_tp / max(vis_frames, 1), 4),
        "detection_recall_raw": round(raw_tp / max(vis_frames, 1), 4),
        "detection_precision": round((n_det - det_fp) / max(n_det, 1), 4),
        "trajectory_mae_px": round(float(np.mean(traj_err)), 2)
        if traj_err else None,
        "trajectory_p90_px": round(float(np.percentile(traj_err, 90)), 2)
        if traj_err else None,
        "gaps": len(recoveries),
        "gap_recovery_frames_mean": round(float(np.mean(recoveries)), 2)
        if recoveries else 0.0,
        "radius_px": round(float(np.mean(radii)), 2),
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clip", required=True, help="render_puck_clip.py's .npz")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--dtype", default="bf16", choices=["bf16", "f32"],
                   help="the puck model's compute type")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args()

    z = np.load(args.clip)
    frames = z["frames"]
    s = frames.shape[1]
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    proc = VideoProcessor(config=Config(frame_batch=BATCH),
                          device=args.device, mode=ProcessingMode.PUCK_DETECTION,
                          frame_hw=(s, s), dtype=dtype)
    t = time.perf_counter()
    results = list(proc.puck_frames(iter(frames)))
    run_s = time.perf_counter() - t

    out = score(results, z["puck_xy"], z["puck_visible"], z["radii"])
    out.update({
        "imgsz": s,
        "generator": "a",
        "device": str(proc.device),
        "dtype": args.dtype,
        "batch": BATCH,
        "tiles_per_frame": len(proc.puck_pipeline.sliced.grid),
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
