#!/usr/bin/env python3
"""The JAX package's precise-BN on the pools of
scripts/torch_train_gate_probe.py: the reference side of its figures.

    python scripts/jax_precise_bn_witness.py --pools DIR [--out F]

Reads DIR/pool.npz and DIR/val.npz (written by the probe's --pools) and
scores the shipped player model (YOLOv8x) with hockey_tpu's in-training
evaluator on the held-out pool: with its shipped running statistics, and
after hockey_tpu.train.trainer.precise_bn over the pool's first 2 batches
of 8 (the loop's recalibration batches; statistics' forward in bf16 and
in f32), all 4 batches, and the held-out images themselves. It prints
the median over channels of |log(var_new / var_shipped)| for the first
BN layers and the worst, as the probe does. Runs on the CPU; one JSON
line, --out also writes it to a file.
"""

import argparse
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402
import numpy as np  # noqa: E402

from hockey_tpu.models.checkpoint import load_params, shipped_weights_path  # noqa: E402
from hockey_tpu.models.yolov8 import MODEL_ZOO  # noqa: E402
from hockey_tpu.train.eval import InTrainingEvaluator  # noqa: E402
from hockey_tpu.train.scenes import HardSyntheticHockeyDataset  # noqa: E402
from hockey_tpu.train.trainer import make_bn_stats_fn, precise_bn  # noqa: E402

NAME, RB = "hockey-player-detection", 8


def read_pool(path):
    with np.load(path) as z:
        n, s = len(z["counts"]), int(z["images"].shape[1])
        images = z["images"]
    ds = HardSyntheticHockeyDataset(imgsz=s, pool_size=n)
    assert ds.load_cache(path), path
    return ds, images


def bn_vars(tree, prefix=()):
    """{conv path: running var} in the tree's order."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        if k == "bn":
            out["/".join(prefix)] = np.asarray(v["var"], np.float64)
        elif isinstance(v, (dict, list, tuple)):
            out.update(bn_vars(v, prefix + (str(k),)))
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--pools", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    pool, frames = read_pool(os.path.join(args.pools, "pool.npz"))
    val, vframes = read_pool(os.path.join(args.pools, "val.npz"))
    s = pool.imgsz
    cfg = MODEL_ZOO[NAME]
    params = load_params(shipped_weights_path(NAME))
    evaluator = InTrainingEvaluator(cfg, s)
    t0 = time.perf_counter()

    def score(p):
        return round(evaluator.evaluate(p, val, range(len(val)))["mAP50"], 4)

    def batches(imgs, n):
        return [np.stack([f.astype(np.float32) / 255.0 for f in imgs[k:k + RB]])
                for k in range(0, n * RB, RB)]

    fns = {dt: make_bn_stats_fn(cfg, dt) for dt in ("bfloat16", "float32")}
    recal = {"loop_2_batches": (batches(frames, 2), "bfloat16"),
             "loop_2_batches_f32": (batches(frames, 2), "float32"),
             "pool_4_batches": (batches(frames, 4), "bfloat16"),
             "held_out_images": (batches(vframes, 2), "bfloat16")}
    out = {"imgsz": s, "platform": jax.devices()[0].platform,
           "shipped_running_stats": score(params), "precise_bn": {}}
    for k, (b, dt) in recal.items():
        out["precise_bn"][k] = score(precise_bn(params, fns[dt], b))
    shipped = bn_vars(params)
    new = bn_vars(precise_bn(params, fns["float32"], recal["loop_2_batches"][0]))
    shift = {k: round(float(np.median(np.abs(np.log((new[k] + 1e-3)
                                                    / (shipped[k] + 1e-3))))), 3)
             for k in shipped}
    out["log_var_shift_first"] = dict(list(shift.items())[:4])
    worst = sorted(shift, key=shift.get)[-4:]
    out["log_var_shift_worst"] = {k: shift[k] for k in worst}
    out["seconds"] = round(time.perf_counter() - t0, 2)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
