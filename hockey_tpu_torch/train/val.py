"""Validation CLI: `python -m hockey_tpu_torch.train.val`.

Port of hockey_tpu/train/val.py: loads a checkpoint (by default the
shipped weights of `--model`) and a dataset and prints mAP50, mAP50-95, P
and R overall and per class, or for the rink pose model PCK@0.05 and the
mean keypoint error. `--json` prints the JAX CLI's keys, so the two
lines compare key by key.

The dataset is a YOLO-format directory (`--images`), a pool rendered
by scripts/render_val_set.py (`--pool`, the port's addition), or, as in
the JAX CLI, one of the `--dataset` renderers at `--seed` (7777, the
train CLI's held-out split for its `--seed 0`): `synthetic` (the
default; 50 images at most, drawn in numpy without cv2), generator A's
`hard` and `hard-puck`, generator B's `hard-b` and `hard-puck-b`, and for
the rink pose model its sterile views, `rink-b` and `rink-rich`. All but
`synthetic` need cv2. It runs on CUDA unless `--device cpu` is given; a
CUDA run without a GPU raises.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Validate a hockey_tpu_torch detector")
    p.add_argument("--images", type=str, default=None,
                   help="images/ dir (labels/ sibling)")
    p.add_argument("--pool", type=str, default=None,
                   help="a pool .npz from scripts/render_val_set.py")
    p.add_argument("--model", type=str, default="hockey-player-detection")
    p.add_argument("--variant", type=str, default=None,
                   help="override variant (n/s/m/l/x), e.g. n for smoke tests")
    p.add_argument("--checkpoint", type=str, default=None)
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--conf", type=float, default=0.001)
    p.add_argument("--limit", type=int, default=200,
                   help="max images to evaluate")
    p.add_argument("--dataset", type=str, default="synthetic",
                   choices=["synthetic", "hard", "hard-puck",
                            "hard-b", "hard-puck-b", "rink-b",
                            "rink-rich"],
                   help="rendered source without --images/--pool: 'hard' "
                        "= generator A's held-out scenes (train/scenes.py), "
                        "the '-b' variants generator B (train/scenes_b.py), "
                        "out of distribution")
    p.add_argument("--seed", type=int, default=None,
                   help="scene seed of --dataset (default 7777, the train "
                        "CLI's held-out split for --seed 0); with --pool, "
                        "the seed the pool must have been rendered with")
    p.add_argument("--json", action="store_true", help="print metrics as JSON")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default, bf16) or cpu (f32)")
    return p


def open_dataset(args, pose: bool):
    """(dataset, image count) of --images or --pool, at most --limit, or
    else of the --dataset renderer, as the JAX CLI chooses it
    (hockey_tpu/train/val.py:80-140)."""
    from .data import PoolDataset, SyntheticHockeyDataset, SyntheticRinkDataset, YoloDataset

    if args.images and args.pool:
        raise SystemExit("give at most one of --images or --pool")
    if args.images:
        ds = YoloDataset(args.images, imgsz=args.imgsz)
        return ds, min(len(ds), args.limit)
    if args.pool:
        ds = PoolDataset(args.pool)
        seed = ds.meta.get("seed")
        if args.seed is not None and seed is not None and seed != args.seed:
            raise SystemExit(f"{args.pool} was rendered with seed {seed}, "
                             f"not {args.seed}")
        if ds.imgsz != args.imgsz:
            raise SystemExit(f"{args.pool} holds {ds.imgsz}-px images, "
                             f"--imgsz is {args.imgsz}")
        return ds, min(len(ds), args.limit)
    seed = 7777 if args.seed is None else args.seed
    if pose:
        if args.dataset == "rink-b":
            from .scenes_b import SyntheticRinkDatasetB

            return SyntheticRinkDatasetB(imgsz=args.imgsz, seed=seed), args.limit
        if args.dataset == "rink-rich":
            # held-out slice of the pose training family (rich scenes)
            return SyntheticRinkDataset(imgsz=args.imgsz, seed=seed + 7777,
                                        rich=True), args.limit
        return SyntheticRinkDataset(imgsz=args.imgsz, seed=seed), args.limit
    if args.dataset in ("hard", "hard-puck"):
        from .scenes import HardSyntheticHockeyDataset

        ds = HardSyntheticHockeyDataset(
            imgsz=args.imgsz, seed=seed, pool_size=args.limit,
            pucks=args.dataset == "hard-puck")
    elif args.dataset in ("hard-b", "hard-puck-b"):
        from .scenes_b import HardSyntheticHockeyDatasetB

        ds = HardSyntheticHockeyDatasetB(
            imgsz=args.imgsz, seed=seed, pool_size=args.limit,
            pucks=args.dataset == "hard-puck-b")
    else:  # the JAX CLI's synthetic set: seed 0, 50 images at most
        return SyntheticHockeyDataset(imgsz=args.imgsz, seed=0), min(args.limit, 50)
    ds.pregenerate()
    return ds, args.limit


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    import numpy as np

    from ..core.config import Config
    from ..models.detector import Detector
    from ..models.yolov8 import MODEL_ZOO, YoloConfig
    from .eval import PoseEvalAccumulator, evaluate_detector

    config = Config()
    config.detection_imgsz = args.imgsz
    if args.variant:
        # process-local zoo override so Detector resolves the right shape
        base = MODEL_ZOO[args.model]
        MODEL_ZOO[args.model] = YoloConfig(
            args.variant, base.num_classes, base.num_keypoints)
    pose = bool(MODEL_ZOO[args.model].num_keypoints)
    ds, n = open_dataset(args, pose)

    if pose:
        # pose model: PCK@0.05 and mean pixel error on held-out rink views
        from ..homography.keypoints import RinkKeypointDetector

        # the shipped weights run at their operating resolution
        # (config.rink_imgsz); an explicit --checkpoint at --imgsz
        if args.checkpoint:
            config.rink_imgsz = args.imgsz
        rkd = RinkKeypointDetector(
            args.model, config, frame_hw=(args.imgsz, args.imgsz),
            checkpoint=args.checkpoint, device=args.device)
        t0 = time.perf_counter()
        acc = PoseEvalAccumulator()
        B = 8
        for k in range(0, n, B):
            items = [ds.load(i) for i in range(k, min(k + B, n))]
            frames = np.stack([(it["images"] * 255).astype(np.uint8)
                               for it in items])
            kpts = rkd.detect_keypoints_batch(frames)
            for j, it in enumerate(items):
                acc.add_image(kpts[j], it["keypoints"][0],
                              (args.imgsz, args.imgsz))
        m = acc.compute()
        _report_time(n, t0)
        if args.json:
            print(json.dumps(m))
        else:
            print(f"images: {n}")
            print(f"PCK@0.05:        {m['pck']:.4f}")
            print(f"mean kpt error:  {m['mean_kpt_error_px']:.2f} px")
        return 0

    det = Detector(
        args.model, config, frame_hw=(args.imgsz, args.imgsz),
        imgsz=args.imgsz, conf=args.conf, checkpoint=args.checkpoint,
        device=args.device,
    )
    t0 = time.perf_counter()
    metrics = evaluate_detector(det, ds, range(n), conf=args.conf)
    _report_time(n, t0)
    if args.json:
        print(json.dumps(metrics))
    else:
        print(f"images: {n}")
        print(f"mAP50:    {metrics['mAP50']:.4f}")
        print(f"mAP50-95: {metrics['mAP50_95']:.4f}")
        print(f"P / R:    {metrics['precision']:.4f} / {metrics['recall']:.4f}")
        for k, v in metrics.items():
            if k.startswith("AP50_class"):
                print(f"  {k}: {v:.4f}")
    return 0


def _report_time(n: int, t0: float) -> None:
    """Images and images/s on stderr, from the weights loaded to the last
    batch's metrics (the first call's warm-up included), so that stdout
    keeps the JAX CLI's lines."""
    dt = time.perf_counter() - t0
    print(f"val: {n} images in {dt:.3f} s, {n / max(dt, 1e-9):.3f} images/s",
          file=sys.stderr)


if __name__ == "__main__":
    raise SystemExit(main())
