#!/usr/bin/env python3
"""Render the clip of scripts/e2e_puck.py and save it as an .npz that
scripts/torch_e2e_puck.py scores.

    python scripts/render_puck_clip.py --out proof/clips/puck_a.npz \
        [--frames 96] [--seed 11] [--imgsz 960] [--span 0.25,0.45]

The clip is the one e2e_puck.py scores, in memory exactly as it renders
it (no video file in between): the JAX package's scene generator
(hockey_tpu/train/scenes.py `render_scene_sequence`, generator a, with
the moving puck; numpy and OpenCV, no JAX). The .npz holds the frames
(N, s, s, 3) uint8 BGR and the ground truth per frame: `puck_xy` (N, 2)
in pixels (NaN where the puck is out of frame), `puck_visible` (N,) and
`radii` (N,), the gt-scaled hit radii of e2e_puck.py's default scoring
(`gt_radius`, cap 16 px). Needs OpenCV; runs on the CPU. This is the
reference's data source, not part of the port. Write it under a
directory that .gitignore lists (proof/).
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(HERE, ".."))
sys.path.insert(0, HERE)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", required=True, help="the .npz to write")
    p.add_argument("--frames", type=int, default=96)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--imgsz", type=int, default=960)
    p.add_argument("--span", type=str, default="0.25,0.45")
    p.add_argument("--radius", type=float, default=16.0,
                   help="the gt-scaled radii's cap (e2e_puck.py --radius)")
    args = p.parse_args()

    from e2e_puck import gt_radius
    from hockey_tpu.train.scenes import render_scene_sequence

    span = tuple(float(x) for x in args.span.split(","))
    frames, labels = render_scene_sequence(
        np.random.default_rng(args.seed), args.imgsz, args.frames,
        span_range=span, include_puck=True)
    xy = np.full((len(labels), 2), np.nan, np.float64)
    for t, lab in enumerate(labels):
        if lab.get("puck_xy") is not None:
            xy[t] = lab["puck_xy"]
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    np.savez_compressed(
        args.out, frames=np.stack(frames), puck_xy=xy,
        puck_visible=np.asarray([bool(lab.get("puck_visible"))
                                 for lab in labels]),
        radii=np.asarray([gt_radius(lab, "a", cap=args.radius)
                          for lab in labels]),
        seed=args.seed, imgsz=args.imgsz, span=np.asarray(span))
    print(f"wrote {args.out}: {len(frames)} frames, "
          f"{os.path.getsize(args.out) / 2**20:.1f} MiB")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
