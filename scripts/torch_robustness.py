"""Out-of-distribution evaluation of the port: generator B and the
corruption curves, scripts/robustness.py's protocol on pre-rendered pools.

    python scripts/torch_robustness.py --pools proof/pools [--limit 100]
        [--corr-limit 40] [--severities 1,3,5] [--corruptions NAMES]
        [--skip-generator-b] [--pucks] [--device cuda] [--out F]

Runs the shipped player detector (or `--checkpoint`) through
`evaluate_detector` at conf 0.001 on:

1. generator B: the first `--limit` images of `<pools>/hard-b.npz`
   (`hard-puck-b.npz` with `--pucks`);
2. the first `--corr-limit` held-out generator-A images of
   `<pools>/hard.npz` clean, then under each corruption at each severity.
   `contrast`, `gamma` and `gaussian_noise` are applied here by the
   port's `CorruptedDataset`; `motion_blur`, `jpeg` and `pixelate` need
   cv2, so their images are read from `<pools>/hard-<name>-s<sev>.npz`
   (scripts/render_val_set.py --corrupt). A point whose pool is absent
   (for the numpy corruptions, the clean pool) is listed under "not_run",
   so the sweep can be split over several runs.

Pools are rendered on the CPU by scripts/render_val_set.py. Prints one
JSON line, the keys of the JAX script's `logs/robustness.json` plus the
card, images/s and the points not run, and writes it to `--out`.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from hockey_tpu_torch.core.config import Config  # noqa: E402
from hockey_tpu_torch.models.detector import Detector  # noqa: E402
from hockey_tpu_torch.train.corruptions import (  # noqa: E402
    CORRUPTIONS,
    CV2_CORRUPTIONS,
    CorruptedDataset,
)
from hockey_tpu_torch.train.data import PoolDataset  # noqa: E402
from hockey_tpu_torch.train.eval import evaluate_detector  # noqa: E402


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError):
        return "unknown"


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--pools", required=True)
    p.add_argument("--model", type=str, default="hockey-player-detection")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--limit", type=int, default=100, help="generator-B images")
    p.add_argument("--corr-limit", type=int, default=40,
                   help="images per corruption x severity point")
    p.add_argument("--severities", type=str, default="1,3,5")
    p.add_argument("--corruptions", type=str, default=None,
                   help="comma-separated names (default: all six)")
    p.add_argument("--pucks", action="store_true",
                   help="the puck-labelled pools (hard-puck*.npz)")
    p.add_argument("--skip-generator-b", action="store_true")
    p.add_argument("--skip-corruptions", action="store_true")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--device", type=str, default="cuda")
    p.add_argument("--out", type=str, default=None)
    args = p.parse_args()

    config = Config()
    config.detection_imgsz = args.imgsz
    det = Detector(args.model, config, frame_hw=(args.imgsz, args.imgsz),
                   imgsz=args.imgsz, conf=0.001, checkpoint=args.checkpoint,
                   device=args.device)
    stem = "hard-puck" if args.pucks else "hard"
    out = {"model": args.model, "imgsz": args.imgsz,
           "checkpoint": args.checkpoint, "device": args.device,
           "card": card() if args.device == "cuda" else None,
           "images_per_s": {}, "not_run": []}

    def run(key, ds, n):
        t = time.perf_counter()
        m = evaluate_detector(det, ds, range(n))
        out["images_per_s"][key] = round(n / (time.perf_counter() - t), 3)
        return m

    if not args.skip_generator_b:
        ds_b = PoolDataset(os.path.join(args.pools, f"{stem}-b.npz"))
        n = min(args.limit, len(ds_b))
        m = out["generator_b"] = run("generator_b", ds_b, n)
        out["generator_b_images"] = n
        print(f"generator-B ({n} images): mAP50 {m['mAP50']:.4f} "
              f"mAP50-95 {m['mAP50_95']:.4f} P {m['precision']:.3f} "
              f"R {m['recall']:.3f}", flush=True)

    if not args.skip_corruptions:
        sevs = [int(s) for s in args.severities.split(",")]
        names = args.corruptions.split(",") if args.corruptions else list(CORRUPTIONS)
        clean_path = os.path.join(args.pools, f"{stem}.npz")
        ds_a = PoolDataset(clean_path) if os.path.exists(clean_path) else None
        n = out["corruption_images"] = args.corr_limit
        if ds_a is None:
            out["not_run"].append("clean_a")
        else:
            clean = out["clean_a"] = run("clean_a", ds_a, n)
            print(f"clean A (held-out, {n} images): mAP50 {clean['mAP50']:.4f}",
                  flush=True)
        curves = {}
        for name in names:
            curves[name] = {}
            for sev in sevs:
                path = os.path.join(args.pools, f"{stem}-{name}-s{sev}.npz")
                if name in CV2_CORRUPTIONS and os.path.exists(path):
                    ds = PoolDataset(path)
                elif name not in CV2_CORRUPTIONS and ds_a is not None:
                    ds = CorruptedDataset(ds_a, name, sev)
                else:
                    out["not_run"].append(f"{name}:{sev}")
                    continue
                if len(ds) < n:
                    raise SystemExit(f"{name}:{sev} has {len(ds)} images, "
                                     f"fewer than {n}")
                mm = run(f"{name}:{sev}", ds, n)
                curves[name][str(sev)] = round(mm["mAP50"], 4)
                print(f"  {name} s{sev}: mAP50 {mm['mAP50']:.4f}", flush=True)
        out["corruption_mAP50"] = curves

    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
