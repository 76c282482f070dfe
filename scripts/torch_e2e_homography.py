#!/usr/bin/env python3
"""End-to-end homography accuracy of the port against the known camera:
the protocol and figures of scripts/e2e_homography.py, on the clip of
`scripts/render_e2e_clip.py --homography`.

    python scripts/torch_e2e_homography.py --clip proof/clips/homography.npz \
        [--draw] [--device cuda|cpu] [--dtype bf16|f32] [--frame-batch N] \
        [--pass-ft 6] [--out F]

The port's VideoProcessor(mode=PLAYER_TRACKING, show_2d_map=True) with the
shipped player and rink weights and `Config()` at the clip's resolution
(detection_imgsz = clip size, rink_imgsz 512) runs the dual step (player
branch, rink pose model), the host ByteTrack, the keypoints and the
calibrator (tiered RANSAC, stabiliser) over the clip's two camera
segments. After each frame the recovered image-to-rink homography
(`calibrator.stabilizer.current`) is scored as e2e_homography.py does:

- calibration error: the ground-truth foot pixels through the recovered
  H against the actors' true rink positions (ft), per frame;
- pipeline rink error: the tracked boxes' feet through H against the
  matched (IoU >= 0.5) actors' rink positions (ft);
- pre- and post-cut means, frames to recover after the cut (error back
  under `--pass-ft`), frames on the fine and the coarse tier.

Two routes. The numeric route (default; the card's) feeds the decoded
frames from the .npz to `track_frames`, which draws nothing, so the
calibrator's camera-motion probe reads the raw frame. `--draw` (CPU, needs
OpenCV) runs `process_video` on the .mp4 beside the .npz, as
e2e_homography.py runs the JAX pipeline: the keypoints are drawn on each
frame before the probe reads it. Both record the frames where the probe
fired (`moved_frames`). The models run in bf16 by default, as the JAX
detectors do on every backend (`--dtype f32` for the port's CPU default).

Prints one JSON line (also written to `--out`). Imports nothing of the
JAX package and, on the numeric route, no OpenCV, so it runs on the GPU
machine.
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

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

from hockey_tpu_torch.core.config import Config, ProcessingMode  # noqa: E402
from hockey_tpu_torch.homography.ransac import project  # noqa: E402
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402
from torch_e2e_quality import _iou, load_clip  # noqa: E402

DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}


def _mean(xs):
    return round(float(np.mean(xs)), 2) if xs else None


def score(h_recs, tiers, results, labels, cut_at: int, pass_ft: float) -> dict:
    """e2e_homography.py's figures from each frame's recovered homography
    (None before the first calibration), the stabiliser's tier and the
    pipeline's `last_frame_result`."""
    calib_err, pipe_err, per_frame = [], [], []
    n_tier = {"fine": 0, "coarse": 0}
    tier_errs = {"fine": [], "coarse": []}
    for h_rec, tier, res, gt in zip(h_recs, tiers, results, labels):
        if h_rec is not None and tier in n_tier:
            n_tier[tier] += 1
        if h_rec is None or len(gt["boxes"]) == 0:
            per_frame.append(None)
            continue
        feet = np.stack([(gt["boxes"][:, 0] + gt["boxes"][:, 2]) / 2,
                         gt["boxes"][:, 3]], 1).astype(np.float64)
        e = float(np.linalg.norm(project(h_rec, feet) - gt["rink_xy"],
                                 axis=1).mean())
        calib_err.append(e)
        per_frame.append(e)
        if tier in tier_errs:
            tier_errs[tier].append(e)
        if res is not None and len(res["boxes"]):
            pb = np.asarray(res["boxes"], np.float64)
            m = _iou(pb, np.asarray(gt["boxes"], np.float64))
            prink = project(h_rec, np.stack([(pb[:, 0] + pb[:, 2]) / 2,
                                             pb[:, 3]], 1))
            for i in range(len(pb)):
                j = int(np.argmax(m[i]))
                if m[i, j] >= 0.5:
                    pipe_err.append(float(np.linalg.norm(
                        prink[i] - gt["rink_xy"][j])))
    recover = next((dt for dt, e in enumerate(per_frame[cut_at:])
                    if e is not None and e <= pass_ft), None)
    pre = [e for e in per_frame[:cut_at] if e is not None]
    post = [e for e in per_frame[cut_at:] if e is not None]
    return {
        "frames": len(h_recs),
        "cut_at": cut_at,
        "calibrated_frames": len(calib_err),
        "calib_err_ft_mean": _mean(calib_err),
        "calib_err_ft_median": round(float(np.median(calib_err)), 2)
        if calib_err else None,
        "pipeline_rink_err_ft_mean": _mean(pipe_err),
        "pre_cut_err_ft": _mean(pre),
        "post_cut_err_ft": _mean(post),
        "cut_recovery_frames": recover,
        "fine_frames": n_tier["fine"],
        "coarse_frames": n_tier["coarse"],
        "fine_err_ft_mean": _mean(tier_errs["fine"]),
        "coarse_err_ft_mean": _mean(tier_errs["coarse"]),
        "generator": "a",
    }


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--clip", required=True,
                   help="render_e2e_clip.py --homography's .npz")
    p.add_argument("--draw", action="store_true",
                   help="process_video on the clip's .mp4, drawing (CPU, cv2)")
    p.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    p.add_argument("--dtype", default="bf16", choices=sorted(DTYPES))
    p.add_argument("--frame-batch", type=int, default=0,
                   help="frames per device step (0: 8 on CUDA, 1 on the CPU)")
    p.add_argument("--pass-ft", type=float, default=6.0,
                   help="recovered-lock threshold for cut recovery (ft)")
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args()

    frames, labels = load_clip(args.clip)
    cut_at = int(np.load(args.clip)["cut_at"])
    s = frames.shape[1]
    config = Config(detection_imgsz=s, frame_batch=args.frame_batch)
    os.environ["HOCKEY_TPU_HEADLESS"] = "1"
    proc = VideoProcessor(config=config, device=args.device,
                          mode=ProcessingMode.PLAYER_TRACKING,
                          frame_hw=(s, s), show_2d_map=True,
                          dtype=DTYPES[args.dtype])
    # the camera-motion probe's verdict on each frame
    moved, probe = [], proc.calibrator.movement.update
    proc.calibrator.movement.update = lambda f: moved.append(probe(f)) or moved[-1]

    if args.draw:
        steps = proc.process_video(os.path.splitext(args.clip)[0] + ".mp4")
    else:
        steps = proc.track_frames(iter(frames))
    h_recs, tiers, results = [], [], []
    t = time.perf_counter()
    for _ in steps:
        st = proc.calibrator.stabilizer
        h_recs.append(None if st.current is None else st.current.copy())
        tiers.append(st.current_tier)
        results.append(proc.last_frame_result)
    run_s = time.perf_counter() - t
    if len(h_recs) != len(frames):
        raise RuntimeError(f"{len(h_recs)} frames out, {len(frames)} in")

    out = score(h_recs, tiers, results, labels, cut_at, args.pass_ft)
    out.update({
        "route": "draw (process_video)" if args.draw else "numeric (track_frames)",
        "moved_frames": [i for i, m in enumerate(moved) if m],
        "device": str(proc.device),
        "dtype": args.dtype,
        "frame_batch": proc._batch(),
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
