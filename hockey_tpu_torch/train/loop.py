"""Training loop CLI: `python -m hockey_tpu_torch.train.loop`.

Port of hockey_tpu/train/loop.py, the counterpart of the reference's
`yolo task=detect mode=train` (notebooks/train_player_detection.ipynb
cell 15): cosine LR, HSV + flip (+ mosaic, mixup) augmentation, EMA
weights, precise-BN, periodic checkpoints and validation with the best
checkpoint kept. It trains on the card (`--device cuda`, the default,
bf16 compute on f32 masters) or on the CPU (`--device cpu`, f32).

The data, chosen in the JAX CLI's order:
- `--images DIR`, a YOLO-format directory (needs cv2);
- `--pool-file PATH`, a pool in the `save_cache` format (the port's
  addition: a pool rendered elsewhere, e.g. by scripts/render_val_set.py);
- a pose model: `SyntheticRinkDataset` (`--domain-rand`: its rich
  scenes), held out at `--seed` + 7777 for `--val-every`;
- `--dataset hard|hard-puck`, or `auto` with `--val-every`: generator A
  (train/scenes.py `HardSyntheticHockeyDataset`), `--pool N` scenes
  pre-rendered and cached in the temporary directory under a name of the
  port's own, held out at `--seed` + 7777 (`--val-size` scenes, legacy
  style);
- otherwise `SyntheticHockeyDataset`, the JAX CLI's default, which draws
  in numpy and so runs where cv2 is absent.
Every choice but the last and `--pool-file` needs cv2. `--val-pool-file`
replaces the held-out set. With `--device-data` the pool (at most
`--pool` items of an unbounded dataset) is staged in device memory and
augmented there (train/device_aug.py); otherwise `batch_iterator`
augments on the host. Checkpoints are the JAX package's msgpack trees
(models/checkpoint.py `save_params`).

Multi-device training follows the JAX CLI's rule: `dp = --dp or
devices // --fsdp`, shrunk to a divisor of `--batch`, and a (dp, fsdp)
mesh (core/mesh.py, parallel/sharding.py) when dp * fsdp > 1 on more than
one device. The devices are the visible cards on CUDA, the processes
under torchrun, and on the CPU the explicit `--dp` x `--fsdp` (gloo; 1
without either flag). Without a launcher, the CLI starts one process per
mesh device itself, each running this module. Under a mesh, as in the
JAX CLI, `--ema`, precise-BN and `--device-data` are off; every rank
draws the host iterator's global batch and trains on its dp rows; rank 0
prints, validates and writes the checkpoints.

The collapse detector stays a tripwire: with gradients leaking through
the assignment the model learns to predict nothing (TAL's degenerate
minimum; train/losses.py keeps the assignment gradient-free).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train a hockey_tpu_torch YOLOv8 detector")
    p.add_argument("--images", type=str, default=None,
                   help="images/ dir of a YOLO-format dataset (labels/ sibling)")
    p.add_argument("--pool-file", type=str, default=None,
                   help="a pre-rendered pool .npz (the save_cache format, "
                        "e.g. scripts/render_val_set.py) to train on")
    p.add_argument("--val-pool-file", type=str, default=None,
                   help="a held-out pool .npz for --val-every (replaces "
                        "the rendered held-out split)")
    p.add_argument("--model", type=str, default="hockey-player-detection")
    p.add_argument("--variant", type=str, default=None,
                   help="override variant (n/s/m/l/x), e.g. n for smoke tests")
    p.add_argument("--imgsz", type=int, default=640)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--lr", type=float, default=0.01)
    p.add_argument("--warmup", type=int, default=100)
    p.add_argument("--out", type=str, default="checkpoints/model.msgpack")
    p.add_argument("--save-every", type=int, default=500)
    p.add_argument("--log-every", type=int, default=20)
    p.add_argument("--dp", type=int, default=0,
                   help="data-parallel ways (0: devices // fsdp)")
    p.add_argument("--fsdp", type=int, default=1,
                   help="parameter-sharded ways")
    p.add_argument("--mosaic", type=float, default=0.0,
                   help="mosaic probability (ultralytics recipe: 1.0)")
    p.add_argument("--mixup", type=float, default=0.0,
                   help="mixup probability (ultralytics recipe: 0.15)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--dataset", type=str, default="auto",
                   choices=["auto", "hard", "hard-puck", "synthetic"],
                   help="synthetic source without --images/--pool-file: "
                        "'hard' = broadcast-like scenes (train/scenes.py), "
                        "'hard-puck' = puck-labelled scenes, 'synthetic' "
                        "(and 'auto' without --val-every) = rectangles")
    p.add_argument("--pool", type=int, default=2000,
                   help="pre-rendered scene pool size (hard datasets; the "
                        "items --device-data stages of an unbounded one)")
    p.add_argument("--domain-rand", action="store_true",
                   help="widen the hard-scene rendering family "
                        "(scenes.sample_style); the held-out pool stays "
                        "legacy-style. A pose model: rich rink scenes")
    p.add_argument("--val-every", type=int, default=0,
                   help="evaluate mAP (PCK for a pose model) on held-out "
                        "scenes every N steps and keep the best checkpoint")
    p.add_argument("--val-size", type=int, default=150)
    p.add_argument("--ema", type=float, default=0.0,
                   help="EMA decay for eval/checkpoint weights (e.g. 0.999)")
    p.add_argument("--init", type=str, default=None,
                   help="initialize from an existing checkpoint")
    p.add_argument("--box-prior", type=float, default=0.0,
                   help="init the DFL reg-head bias toward this extent "
                        "(grid units/side); ~1.0 for tiny objects (puck)")
    p.add_argument("--precise-bn", type=int, default=8,
                   help="recalibrate BN running stats over N clean batches "
                        "before every val/checkpoint (0 = off)")
    p.add_argument("--device-data", action="store_true",
                   help="stage the pool in device memory and augment there "
                        "(train/device_aug.py): no per-step image upload")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (default, bf16 compute) or cpu (f32)")
    return p


def check_ported(args) -> None:
    """Raise for flags that contradict each other."""
    if args.images and args.pool_file:
        raise ValueError("give one of --images or --pool-file, not both")
    if args.fsdp < 1 or args.dp < 0:
        raise ValueError(f"--dp {args.dp} --fsdp {args.fsdp}: need dp >= 0, "
                         "fsdp >= 1")


def mesh_plan(args, device_type: str):
    """(devices, dp, whether to train on a mesh), by the JAX CLI's rule
    (hockey_tpu/train/loop.py:169-174): the devices are the processes under
    a launcher, else the visible cards on CUDA, else --dp x --fsdp."""
    import os

    import torch

    from ..core.mesh import launched

    if launched():
        n_dev = int(os.environ["WORLD_SIZE"])
    elif device_type == "cuda":
        n_dev = torch.cuda.device_count()
    else:
        n_dev = max(args.dp, 1) * args.fsdp
    dp = args.dp or (n_dev // args.fsdp)
    # dp must divide the batch; shrink to the largest divisor that fits
    while dp > 1 and args.batch % dp != 0:
        dp -= 1
    use_mesh = dp * args.fsdp > 1 and n_dev > 1
    if use_mesh and dp * args.fsdp > n_dev:
        raise ValueError(f"a {dp}x{args.fsdp} mesh needs {dp * args.fsdp} "
                         f"devices, {n_dev} visible")
    return n_dev, dp, use_mesh


def scene_cache_path(imgsz: int, pool: int, seed: int, pucks: bool,
                     domain_rand: bool) -> str:
    """Where a rendered generator-A pool is cached: the temporary
    directory, under a name of the port's own keyed by the renderer's
    version and the pool's parameters."""
    import os
    import tempfile

    from .scenes import RENDERER_VERSION

    return os.path.join(tempfile.gettempdir(), (
        f"hockey_tpu_torch_scenes_v{RENDERER_VERSION}_{imgsz}_{pool}_"
        f"{seed}_{int(pucks)}{'_dr' if domain_rand else ''}.npz"))


def open_datasets(args, cfg, log=print):
    """(training dataset, held-out dataset or None), chosen in the JAX
    CLI's order (hockey_tpu/train/loop.py:108-163); `log` prints."""
    from .data import (PoolDataset, SyntheticHockeyDataset,
                       SyntheticRinkDataset, YoloDataset)

    val_dataset = None
    if args.images:
        dataset = YoloDataset(args.images, imgsz=args.imgsz)
        log(f"dataset: {len(dataset)} images from {args.images}")
    elif args.pool_file:
        dataset = PoolDataset(args.pool_file)
        if dataset.imgsz != args.imgsz:
            raise ValueError(f"{args.pool_file} holds {dataset.imgsz}-px "
                             f"images, --imgsz is {args.imgsz}")
        log(f"dataset: pool of {len(dataset)} images from {args.pool_file}")
    elif cfg.num_keypoints:
        dataset = SyntheticRinkDataset(imgsz=args.imgsz, seed=args.seed,
                                       rich=args.domain_rand)
        if args.val_every:
            # held-out seeds; rich as in training
            val_dataset = SyntheticRinkDataset(
                imgsz=args.imgsz, seed=args.seed + 7777, rich=args.domain_rand)
        log("dataset: synthetic rink views (pose model, no --images, "
            f"rich={args.domain_rand})")
    elif args.dataset in ("hard", "hard-puck") or (
            args.dataset == "auto" and args.val_every):
        from .scenes import HardSyntheticHockeyDataset

        pucks = args.dataset == "hard-puck"
        dataset = HardSyntheticHockeyDataset(
            imgsz=args.imgsz, seed=args.seed, pool_size=args.pool,
            pucks=pucks, domain_rand=args.domain_rand)
        # held-out split: disjoint seeds, legacy style
        val_dataset = HardSyntheticHockeyDataset(
            imgsz=args.imgsz, seed=args.seed + 7777,
            pool_size=args.val_size, pucks=pucks)
        log(f"dataset: hard synthetic scenes (pool {args.pool}, "
            f"pucks={pucks}, domain_rand={args.domain_rand}); "
            "pre-rendering...")
        t = time.time()
        cache = scene_cache_path(args.imgsz, args.pool, args.seed, pucks,
                                 args.domain_rand)
        if dataset.load_cache(cache):
            log(f"loaded scene pool from {cache}")
        else:
            dataset.pregenerate()
            dataset.save_cache(cache)
        val_dataset.pregenerate()
        log(f"pre-rendered {args.pool}+{args.val_size} scenes "
            f"in {time.time() - t:.0f}s")
    else:
        dataset = SyntheticHockeyDataset(imgsz=args.imgsz, seed=args.seed)
        log("dataset: synthetic (no --images given)")
    if args.val_pool_file:
        val_dataset = PoolDataset(args.val_pool_file)
    if args.val_every and val_dataset is None:
        raise ValueError("--val-every with --images, --pool-file or "
                         "--dataset synthetic needs --val-pool-file")
    return dataset, val_dataset


@dataclasses.dataclass
class TrainRun:
    """What a run did: its exit code, each step's metrics (floats, with
    the step's wall ms in 'ms'), each validation's (step, metrics), the
    trainer (model, optimizer, EMA), the in-training evaluator (None
    without --val-every) and the best validation score."""

    rc: int
    history: List[Dict[str, float]]
    val: List
    trainer: object
    evaluator: object
    best: float


def run(argv: Optional[List[str]] = None) -> TrainRun:
    """The body of `main`: parse `argv`, train, save; returns the run.
    Where the run needs a mesh and no launcher started this process, it
    starts the mesh's processes and returns their return code alone."""
    import sys

    argv = sys.argv[1:] if argv is None else list(argv)
    args = build_parser().parse_args(argv)
    check_ported(args)

    import torch

    from ..core.device import resolve_device
    from ..core.mesh import init_from_env, launch, launched, make_mesh
    from ..models.checkpoint import load_params, save_params
    from ..models.yolov8 import (MODEL_ZOO, YoloConfig, build_model, init_params,
                                 params_to_jax)
    from .data import batch_iterator
    from .trainer import TrainConfig, Trainer, batch_to, make_bn_stats_fn, precise_bn

    device = resolve_device(args.device)
    n_dev, dp, use_mesh = mesh_plan(args, device.type)
    if use_mesh and not launched():
        print(f"mesh: dp {dp} x fsdp {args.fsdp} of {n_dev} devices; starting "
              f"{dp * args.fsdp} processes on {device.type}", flush=True)
        rc = launch(["-m", "hockey_tpu_torch.train.loop", *argv],
                    dp * args.fsdp, device.type)
        return TrainRun(rc, [], [], None, None, -1.0)
    mesh = None
    if use_mesh:
        import torch.distributed as dist

        device = init_from_env(device.type)
        mesh = make_mesh(dp * args.fsdp, dp=dp, fsdp=args.fsdp, device=device)
    lead = mesh is None or mesh.rank == 0

    def say(*a, **k):  # rank 0 prints
        if lead:
            print(*a, **k)

    if mesh is not None:
        say(f"mesh: {mesh.shape}")
    cfg = MODEL_ZOO[args.model]
    if args.variant:
        cfg = YoloConfig(args.variant, cfg.num_classes, cfg.num_keypoints)
    tc = TrainConfig(imgsz=args.imgsz, learning_rate=args.lr,
                     warmup_steps=args.warmup, total_steps=args.steps,
                     compute_dtype="bfloat16" if device.type == "cuda" else "float32")
    if args.init:
        tree = load_params(args.init)
        say(f"initialized from {args.init}")
    else:
        tree = init_params(cfg, seed=args.seed, box_prior=args.box_prior)
    model = build_model(cfg, tree).to(device)
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)

    if mesh is not None and not lead:
        dist.barrier()  # rank 0 renders (and caches) the pools first
    dataset, val_dataset = open_datasets(args, cfg, log=say)
    if mesh is not None and lead:
        dist.barrier()

    if mesh is not None:
        from ..core.mesh import shard_batch
        from ..parallel.sharding import shard_train_step

        if args.ema:
            say("note: --ema is single-device only; disabled under a mesh")
        trainer = shard_train_step(mesh, cfg, tc, model)
    else:
        trainer = Trainer(cfg, tc, model, ema_decay=args.ema)

    evaluator = None
    if args.val_every and lead:
        if cfg.num_keypoints:
            from .eval import InTrainingPoseEvaluator

            evaluator = InTrainingPoseEvaluator(cfg, imgsz=args.imgsz, device=device)
        else:
            from .eval import InTrainingEvaluator

            evaluator = InTrainingEvaluator(cfg, imgsz=args.imgsz, device=device)
    best = -1.0
    val_log = []

    # precise-BN: recalibrate running stats on clean train-distribution
    # images before any eval/save (single-device only, as in the JAX CLI)
    recal = None
    if args.precise_bn and mesh is None:
        stats_fn = make_bn_stats_fn(tc.compute_dtype)
        rb = min(8, args.batch)

        def recal_batches():
            for k in range(args.precise_bn):
                idx = [(k * rb + j) % len(dataset) for j in range(rb)]
                yield np.stack([dataset.load(int(i))["images"] for i in idx])

        def recal(m):
            return precise_bn(m, stats_fn, recal_batches())

    def prep_ckpt(m):
        return recal(m) if recal is not None else m

    def ckpt_model():
        return trainer.model if trainer.ema is None else trainer.ema.model

    def run_val(i, cur):
        nonlocal best
        cur = prep_ckpt(cur)
        m = evaluator.evaluate(cur, val_dataset,
                               range(min(len(val_dataset), args.val_size)))
        val_log.append((i, m))
        score_key = "pck" if "pck" in m else "mAP50"
        tag = ""
        if m[score_key] > best:
            best = m[score_key]
            save_params(args.out + ".best", params_to_jax(cur))
            tag = " (best, saved)"
        if score_key == "pck":
            print(f"step {i:6d} VAL PCK@0.05 {m['pck']:.4f} "
                  f"kpt_err {m['mean_kpt_error_px']:.2f}px{tag}", flush=True)
        else:
            per_cls = " ".join(f"{k}={v:.3f}" for k, v in m.items()
                               if k.startswith("AP50_class"))
            print(f"step {i:6d} VAL mAP50 {m['mAP50']:.4f} "
                  f"mAP50-95 {m['mAP50_95']:.4f} {per_cls}{tag}", flush=True)

    def log(i, m, t0):
        say(f"step {i:6d} loss {m['loss']:8.4f} box {m['box_loss']:.4f} "
            f"cls {m['cls_loss']:.4f} dfl {m['dfl_loss']:.4f} "
            f"fg {m['num_fg']:.0f} gn {m['grad_norm']:.1f} "
            f"({(time.time() - t0) / max(i, 1):.2f}s/step)", flush=True)

    def collapsing(i, m):
        # TAL degenerate-minimum detector: box_loss ~ 0 with fg anchors
        # present means the targets collapsed (the model predicts nothing)
        return (i > 200 and np.isfinite(m["loss"]) and not cfg.num_keypoints
                and m["box_loss"] < 0.02 and m["num_fg"] > 0)

    def finish(rc):
        if rc == 0 and lead:
            if evaluator is not None:
                run_val(args.steps, ckpt_model())
            save_params(args.out, params_to_jax(prep_ckpt(ckpt_model())))
            print(f"saved {args.out} (best val {best:.4f})" if best >= 0
                  else f"saved {args.out}")
        if mesh is not None:
            dist.destroy_process_group()
        return TrainRun(rc, history, val_log, trainer, evaluator, best)

    history: List[Dict[str, float]] = []

    def step(batch, t):
        """One train step; its metrics as floats, with 'ms' the wall time
        since `t` (the batch's making included)."""
        m = {k: float(v) for k, v in trainer.step(batch).items()}  # syncs
        m["ms"] = 1e3 * (time.perf_counter() - t)
        history.append(m)
        return m

    def periodic(i):
        if evaluator is not None and i and i % args.val_every == 0:
            run_val(i, ckpt_model())
        if lead and args.save_every and i and i % args.save_every == 0:
            save_params(args.out, params_to_jax(prep_ckpt(ckpt_model())))

    if args.device_data and mesh is not None:
        say("note: --device-data is single-device only; the host iterator "
            "feeds the mesh")
    if args.device_data and mesh is None:
        # device-resident pipeline: the pool is staged once, augmentation
        # runs on the device, the host sends nothing per step
        from .device_aug import make_device_batch_fn, make_pose_batch_fn, stage_pool

        # an unbounded dataset (the synthetic ones): its first --pool items
        n_pool = args.pool if len(dataset) >= 1 << 30 else len(dataset)
        say(f"staging the pool ({n_pool} scenes) in device memory...")
        pool = stage_pool(dataset, range(n_pool), device=device)  # keypoints too
        if cfg.num_keypoints:
            if args.mosaic or args.mixup:
                say("note: --mosaic/--mixup are unsupported for pose "
                    "pools; training without them")
            batch_fn = make_pose_batch_fn(args.batch)
        else:
            batch_fn = make_device_batch_fn(args.imgsz, args.batch,
                                            mosaic_prob=args.mosaic,
                                            mixup_prob=args.mixup)
        gen = torch.Generator(device=device).manual_seed(args.seed)
        t0, bad, collapsed = time.time(), 0, 0
        for i in range(args.steps):
            t = time.perf_counter()
            m = step(batch_fn(pool, gen), t)
            # the trainer discards non-finite updates (bf16 spike guard);
            # only a persistent streak means training is hopeless
            bad = bad + 1 if not np.isfinite(m["loss"]) else 0
            if bad >= 25:
                say("non-finite loss for 25 consecutive steps; aborting")
                return TrainRun(1, history, val_log, trainer, evaluator, best)
            collapsed = collapsed + 1 if collapsing(i, m) else 0
            if collapsed >= 100:
                say(f"step {i}: TAL collapse detected (box_loss ~ 0 for "
                    f"100 consecutive steps); stopping early. Restart "
                    f"from the saved best checkpoint at a lower --lr.")
                return TrainRun(3, history, val_log, trainer, evaluator, best)
            if i % args.log_every == 0 or i == args.steps - 1:
                log(i, m, t0)
            periodic(i)
        return finish(0)

    t0, bad, collapsed = time.time(), 0, 0
    it = batch_iterator(dataset, args.batch, args.steps, seed=args.seed,
                        mosaic_prob=args.mosaic, mixup_prob=args.mixup)
    t = time.perf_counter()
    for i, host_batch in enumerate(it):  # the host's augmentation in 'ms'
        # under a mesh each rank draws the global batch and takes its rows
        m = step(batch_to(host_batch, device) if mesh is None
                 else shard_batch(mesh, host_batch), t)
        t = time.perf_counter()
        if i % args.log_every == 0 or i == args.steps - 1:
            log(i, m, t0)
            # skip-guarded updates: only a streak of bad logged losses
            # means training is hopeless
            bad = bad + 1 if not np.isfinite(m["loss"]) else 0
            if bad >= 3:
                say("non-finite loss persists; aborting")
                return TrainRun(1, history, val_log, trainer, evaluator, best)
            collapsed = collapsed + 1 if collapsing(i, m) else 0
            if collapsed >= 5:
                say(f"step {i}: TAL collapse detected (box_loss ~ 0); "
                    f"stopping early. Restart from the saved best "
                    f"checkpoint at a lower --lr.")
                return TrainRun(3, history, val_log, trainer, evaluator, best)
        periodic(i)
    return finish(0)


def main(argv: Optional[List[str]] = None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    raise SystemExit(main())
