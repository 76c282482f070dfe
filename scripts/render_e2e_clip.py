#!/usr/bin/env python3
"""Render the end-to-end quality clip of scripts/e2e_quality.py (or, with
`--homography`, that of scripts/e2e_homography.py) and save it, decoded,
as an .npz that scripts/torch_e2e_quality.py (torch_e2e_homography.py)
scores.

    python scripts/render_e2e_clip.py --out proof/clips/e2e_a.npz \
        [--frames 96] [--seed 7] [--imgsz 640] [--span 0.45,0.8]
    python scripts/render_e2e_clip.py --homography \
        --out proof/clips/homography.npz

The clip is the one e2e_quality.py scores: the JAX package's scene
generator (hockey_tpu/train/scenes.py `render_scene_sequence`, generator
a; numpy and OpenCV, no JAX) draws the frames, which go through an mp4v
file and back as e2e_quality.py's pipeline reads them. The .npz holds the
decoded frames (N, s, s, 3) uint8 BGR and the ground truth: per-frame
counts `n` and the concatenated `boxes`, `classes`, `track_ids`,
`team_ids`, `numbers` (each actor's jersey number, -1 for none) and
`rink_xy` (each actor's rink position, ft).
e2e_quality.py's number scoring (`--mode PLAYER_TRACKING`) wants
`--imgsz 960 --span 0.28,0.42`.

`--homography` renders e2e_homography.py's clip instead: two segments of
`--frames` (default 48) frames from one generator seeded `--seed`
(default 3), each with its own camera (default span 0.82-0.95), so the
second begins with a camera cut at frame `cut_at`, also saved. The mp4
the frames were decoded from stays beside the .npz (same name, .mp4),
for the port's drawing route, which reads a video as e2e_homography.py's
pipeline does.

Needs OpenCV; runs on the CPU. This is the reference's data
source, not part of the port: the port's harness only reads the file.
Write it under a directory that .gitignore lists (proof/).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--homography", action="store_true",
                   help="e2e_homography.py's clip: two segments with a cut")
    p.add_argument("--frames", type=int, default=None,
                   help="frames (per segment with --homography; default "
                        "96, or 48)")
    p.add_argument("--seed", type=int, default=None, help="default 7, or 3")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--span", type=str, default=None,
                   help="default 0.45,0.8, or 0.82,0.95")
    args = p.parse_args()
    hom = args.homography
    n_frames = args.frames or (48 if hom else 96)
    seed = args.seed if args.seed is not None else (3 if hom else 7)
    span = tuple(float(x) for x in
                 (args.span or ("0.82,0.95" if hom else "0.45,0.8")).split(","))

    import cv2

    from hockey_tpu.train.scenes import render_scene_sequence

    rng = np.random.default_rng(seed)
    frames, labels = render_scene_sequence(rng, args.imgsz, n_frames,
                                           span_range=span)
    cut_at = len(frames)
    if hom:  # a second camera from the same generator: the cut
        seg_b = render_scene_sequence(rng, args.imgsz, n_frames,
                                      span_range=span)
        frames, labels = frames + seg_b[0], labels + seg_b[1]
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        clip = os.path.join(tmp, "clip.mp4")
        w = cv2.VideoWriter(clip, cv2.VideoWriter_fourcc(*"mp4v"), 30,
                            (args.imgsz, args.imgsz))
        for f in frames:
            w.write(f)
        w.release()
        cap = cv2.VideoCapture(clip)
        decoded = []
        while True:
            ok, f = cap.read()
            if not ok:
                break
            decoded.append(f)
        cap.release()
        if hom:
            os.replace(clip, os.path.splitext(args.out)[0] + ".mp4")
    if len(decoded) != len(frames):
        raise RuntimeError(f"decoded {len(decoded)} of {len(frames)} frames")
    cat = {k: np.concatenate([np.asarray(lab[k]) for lab in labels])
           for k in ("boxes", "classes", "track_ids", "team_ids", "numbers",
                     "rink_xy")}
    np.savez_compressed(args.out, frames=np.stack(decoded),
                        n=np.asarray([len(lab["boxes"]) for lab in labels]),
                        seed=seed, imgsz=args.imgsz, span=np.asarray(span),
                        cut_at=cut_at, **cat)
    print(f"wrote {args.out}: {len(decoded)} frames, "
          f"{os.path.getsize(args.out) / 2**20:.1f} MiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
