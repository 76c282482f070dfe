#!/usr/bin/env python3
"""What the held-out mAP50 of chip_smoke.py's full-width training runs
(phase 13 (b)) depends on: the BN statistics or the steps.

    python3 scripts/torch_train_gate_probe.py [--device cuda|cpu] [--imgsz N]
        [--no-train] [--eval-dtype D] [--pools DIR] [--out F]

On phase 13 (b)'s pools (32 `square_players` scenes, seed 21, and 16
held out, seed 22; at an --imgsz other than 640 the figures' heights
scale with it), the shipped player model (YOLOv8x) is scored by the
in-training evaluator:

- with its shipped running statistics;
- after precise-BN (train/trainer.py `precise_bn`) over: the loop's
  recalibration batches (the pool's first 2 batches of 8), with the
  statistics' forward in bf16 and in f32; all 4 batches of the pool; the
  held-out images themselves;
- unless --no-train, after train-loop runs with phase 13 (b)'s flags
  (`--device-data` and the host path, 2 and 6 steps each): the EMA model
  with its own running statistics, and the loop's last validation
  (precise-BN over 2 batches, then the evaluator).

On the card the evaluator runs bf16, on the CPU f32 unless --eval-dtype
says otherwise. --pools DIR also
writes the two pools there, for the JAX package's side of the same
figures (scripts/jax_precise_bn_witness.py). One JSON line; --out also
writes it to a file.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from chip_smoke import (TRAIN_LR, TRAIN_POOL, TRAIN_VAL, square_players,  # noqa: E402
                        write_pool)
from hockey_tpu_torch.core.device import resolve_device  # noqa: E402
from hockey_tpu_torch.models.checkpoint import load_params, shipped_weights_path  # noqa: E402
from hockey_tpu_torch.models.yolov8 import MODEL_ZOO, build_model  # noqa: E402
from hockey_tpu_torch.train import loop as train_loop  # noqa: E402
from hockey_tpu_torch.train.data import PoolDataset  # noqa: E402
from hockey_tpu_torch.train.eval import InTrainingEvaluator  # noqa: E402
from hockey_tpu_torch.train.trainer import make_bn_stats_fn, precise_bn  # noqa: E402

NAME, RB = "hockey-player-detection", 8


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--no-train", action="store_true")
    ap.add_argument("--eval-dtype", default=None,
                    help="the evaluator's dtype (default bfloat16 on the card, "
                         "float32 on the CPU; the JAX evaluator runs bfloat16)")
    ap.add_argument("--pools", default=None, help="also write the pools here")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    device = resolve_device(args.device)
    out = {"imgsz": args.imgsz, "device": str(device), "eval_dtype": args.eval_dtype}
    if device.type == "cuda":
        out["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(out["card"], flush=True)
    s = args.imgsz
    heights = (90 * s / 640, 200 * s / 640)
    frames, boxes = square_players(seed=21, n=TRAIN_POOL, s=s, heights=heights)
    vframes, vboxes = square_players(seed=22, n=TRAIN_VAL, s=s, heights=heights)
    tmp = args.pools or tempfile.mkdtemp(prefix="gate_probe_")
    os.makedirs(tmp, exist_ok=True)
    pool, val = os.path.join(tmp, "pool.npz"), os.path.join(tmp, "val.npz")
    write_pool(pool, frames, boxes)
    write_pool(val, vframes, vboxes)

    cfg, init = MODEL_ZOO[NAME], shipped_weights_path(NAME)
    edt = args.eval_dtype and getattr(torch, args.eval_dtype)
    evaluator = InTrainingEvaluator(cfg, s, device=device, dtype=edt)
    vset = PoolDataset(val)

    def score(m):
        return round(evaluator.evaluate(m, vset, range(TRAIN_VAL))["mAP50"], 4)

    def batches(imgs, n):
        return [np.stack([f.astype(np.float32) / 255.0 for f in imgs[k:k + RB]])
                for k in range(0, n * RB, RB)]

    t0 = time.perf_counter()
    model = build_model(cfg, load_params(init)).to(device)
    cdt = "bfloat16" if device.type == "cuda" else "float32"
    recal = {"loop_2_batches": (batches(frames, 2), cdt),
             "loop_2_batches_f32": (batches(frames, 2), "float32"),
             "pool_4_batches": (batches(frames, 4), cdt),
             "held_out_images": (batches(vframes, 2), cdt)}
    out["shipped_running_stats"] = score(model)
    out["precise_bn"] = {k: score(precise_bn(model, make_bn_stats_fn(dt), b))
                         for k, (b, dt) in recal.items()}
    # how far precise-BN moves each layer's statistics: the median over a
    # layer's channels of |log(var_new / var_shipped)|, first layers and worst
    pb = precise_bn(model, make_bn_stats_fn(cdt), recal["loop_2_batches"][0])
    shift = {}
    for (n, a), b in zip(model.named_buffers(), pb.buffers()):
        if n.endswith("bn.var"):
            r = torch.log((b.double() + 1e-3) / (a.double() + 1e-3)).abs()
            shift[n[:-len(".bn.var")]] = round(float(np.median(r.cpu().numpy())), 3)
    out["log_var_shift_first"] = dict(list(shift.items())[:4])
    worst = sorted(shift, key=shift.get)[-4:]
    out["log_var_shift_worst"] = {k: shift[k] for k in worst}
    del model, pb
    print(json.dumps(out), flush=True)

    if not args.no_train:
        common = ["--model", NAME, "--imgsz", str(s), "--batch", "16", "--init", init,
                  "--ema", "0.999", "--precise-bn", "2", "--val-pool-file", val,
                  "--val-size", str(TRAIN_VAL), "--lr", str(TRAIN_LR),
                  "--log-every", "1", "--save-every", "0", "--mosaic", "1.0",
                  "--mixup", "0.15", "--pool-file", pool, "--device", str(device.type)]
        out["runs"] = {}
        for tag, extra in (("device", ["--device-data"]), ("host", [])):
            for steps in (2, 6):
                run = train_loop.run(common + extra + [
                    "--steps", str(steps), "--val-every", str(steps),
                    "--out", os.path.join(tmp, f"{tag}{steps}.msgpack")])
                out["runs"][f"{tag}_{steps}"] = {
                    "rc": run.rc,
                    "losses": [round(m["loss"], 4) for m in run.history],
                    "grad_norm": [round(m["grad_norm"], 3) for m in run.history],
                    "ema_running_stats": score(run.trainer.ema.model),
                    "loop_val_precise_bn": round(run.val[-1][1]["mAP50"], 4)}
                print(f"{tag} {steps}: {out['runs'][f'{tag}_{steps}']}", flush=True)
                del run
    out["seconds"] = round(time.perf_counter() - t0, 2)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
