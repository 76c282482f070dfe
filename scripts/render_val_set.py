"""Render the held-out validation sets into pools for the port's val CLI.

    python scripts/render_val_set.py [--sets hard,hard-b,...] [--limit N]
        [--seed 7777] [--out proof/pools] [--corrupt motion_blur:1,jpeg:3]

Draws each set with the JAX package's own scene generators on the CPU
(needs cv2) and writes it as `<out>/<set>.npz`, in the arrays
`HardSyntheticHockeyDataset.save_cache` writes ('images' uint8,
'boxes', 'classes', 'counts'), plus 'keypoints' (N, 56, 3) for the rink
sets and the scalars 'name', 'seed' and 'generator'. The sets are those
of scripts/regen_canonical.sh, which the TPU logs `logs/val_*_shipped*.json`
were measured on:

    set          generator                              images  size
    hard         HardSyntheticHockeyDataset             120     640
    hard-b       HardSyntheticHockeyDatasetB            120     640
    hard-puck    HardSyntheticHockeyDataset, pucks      100     640
    hard-puck-b  HardSyntheticHockeyDatasetB, pucks     100     640
    rink         SyntheticRinkDataset                   200     512
    rink-b       SyntheticRinkDatasetB                  100     512

A scene's seed depends only on (seed, index, pucks), so the first N
images of a pool are those of the JAX val CLI's `--limit N` run.
`--corrupt NAME:SEV,...` also writes `<out>/<set>-<NAME>-s<SEV>.npz` for
each detection set, its images corrupted by the JAX package's
`CorruptedDataset` (for the corruptions that need cv2, which the GPU
machine lacks). The port reads a pool with
`hockey_tpu_torch.train.data.PoolDataset`. This script is the data
source of the reference, not part of the port.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# set -> (generator, images, size)
SETS = {
    "hard": ("a", 120, 640), "hard-b": ("b", 120, 640),
    "hard-puck": ("a", 100, 640), "hard-puck-b": ("b", 100, 640),
    "rink": ("a", 200, 512), "rink-b": ("b", 100, 512),
}


def dataset(name: str, n: int, seed: int):
    """The JAX package's dataset of set `name` (n images where it is a
    pool)."""
    from hockey_tpu.train.data import SyntheticRinkDataset
    from hockey_tpu.train.scenes import HardSyntheticHockeyDataset
    from hockey_tpu.train.scenes_b import (HardSyntheticHockeyDatasetB,
                                           SyntheticRinkDatasetB)

    gen, _, size = SETS[name]
    if name.startswith("rink"):
        cls = SyntheticRinkDataset if gen == "a" else SyntheticRinkDatasetB
        return cls(imgsz=size, seed=seed)
    cls = HardSyntheticHockeyDataset if gen == "a" else HardSyntheticHockeyDatasetB
    ds = cls(imgsz=size, seed=seed, pool_size=n, pucks="puck" in name)
    ds.pregenerate()
    return ds


def pool_arrays(ds, n: int) -> dict:
    """The pool's arrays from n items of `ds`: the uint8 images (exactly
    those the items' f32 images were made from), the ground truth unpadded
    into (n, max count) arrays, and a rink set's keypoints."""
    items = [ds.load(i) for i in range(n)]
    counts = np.asarray([int(it["mask"].sum()) for it in items], np.int32)
    m = int(counts.max())
    out = {
        "images": np.stack([np.rint(it["images"] * 255).astype(np.uint8)
                            for it in items]),
        "boxes": np.stack([it["boxes"][:m] for it in items]).astype(np.float32),
        "classes": np.stack([it["classes"][:m] for it in items]).astype(np.int32),
        "counts": counts,
    }
    for it, img in zip(items, out["images"]):
        if not np.array_equal(img.astype(np.float32) / 255.0, it["images"]):
            raise AssertionError("an image is not a uint8 image / 255")
    if "keypoints" in items[0]:
        out["keypoints"] = np.stack([it["keypoints"][0] for it in items]
                                    ).astype(np.float32)
    return out


def write(path: str, arrays: dict, name: str, seed: int, gen: str) -> None:
    np.savez_compressed(path, name=np.asarray(name), seed=np.asarray(seed),
                        generator=np.asarray(gen), **arrays)
    print(f"wrote {path}: {len(arrays['counts'])} images, "
          f"{os.path.getsize(path) / 2**20:.1f} MiB", flush=True)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--sets", default=",".join(SETS),
                   help="comma-separated sets (default: all six)")
    p.add_argument("--limit", type=int, default=None,
                   help="images per set (default: the canonical count)")
    p.add_argument("--seed", type=int, default=7777)
    p.add_argument("--out", default=os.path.join(ROOT, "proof", "pools"))
    p.add_argument("--corrupt", default="",
                   help="NAME:SEV,... corrupted copies of the detection sets")
    args = p.parse_args()

    from hockey_tpu.train.corruptions import CorruptedDataset

    os.makedirs(args.out, exist_ok=True)
    corrupt = [(c.split(":")[0], int(c.split(":")[1]))
               for c in args.corrupt.split(",") if c]
    for name in args.sets.split(","):
        gen, count, _ = SETS[name]
        n = args.limit or count
        t = time.perf_counter()
        ds = dataset(name, n, args.seed)
        write(os.path.join(args.out, f"{name}.npz"), pool_arrays(ds, n),
              name, args.seed, gen)
        if not name.startswith("rink"):
            for cname, sev in corrupt:
                write(os.path.join(args.out, f"{name}-{cname}-s{sev}.npz"),
                      pool_arrays(CorruptedDataset(ds, cname, sev), n),
                      f"{name}-{cname}-s{sev}", args.seed, gen)
        print(f"{name}: {time.perf_counter() - t:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
