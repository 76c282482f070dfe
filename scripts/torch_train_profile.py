#!/usr/bin/env python3
"""Where the time of the port's train step goes, on one GPU.

    python3 scripts/torch_train_profile.py [--model NAME] [--imgsz N] [--batch B] [--out F]

Builds the trainer of `python -m hockey_tpu_torch.train.loop` for the
shipped checkpoint of `--model` (by default the YOLOv8x player model at
640, batch 16, bf16 compute on f32 masters, EMA 0.999) and the
device-resident pipeline (mosaic 1.0, mixup 0.15, flip, HSV) on a pool
of 32 numpy-drawn square scenes (chip_smoke.py's `square_players`), and
reports, after 3 warm-up steps:

- the wall ms per step (host clock around steps that each end, as the
  loop's do, in reading the loss back) over ITERS steps, with
  `torch.backends.cudnn.benchmark` off (the default) and then on;
- from one torch.profiler trace of ITERS steps: the device ms per step of
  each stage's `record_function` range (augment, train_forward,
  train_loss with tal_assign inside it, train_backward, train_update,
  train_ema), the device busy share (device time of all kernels and
  copies over the profiled wall time) and the CUDA kernels with the most
  device time;
- peak device memory of a step;
- the host path's cost: ms per batch of `batch_iterator` (mosaic 1.0,
  mixup 0.15, the HSV round trip in numpy) on the same pool, on the host
  alone.

One JSON line; `--out` also writes it to a file.
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

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import square_players, write_pool  # noqa: E402
from hockey_tpu_torch.models.checkpoint import load_params, shipped_weights_path  # noqa: E402
from hockey_tpu_torch.models.yolov8 import MODEL_ZOO, build_model  # noqa: E402
from hockey_tpu_torch.train.data import PoolDataset, batch_iterator  # noqa: E402
from hockey_tpu_torch.train.device_aug import make_device_batch_fn, stage_pool  # noqa: E402
from hockey_tpu_torch.train.trainer import TrainConfig, Trainer  # noqa: E402

WARMUP, ITERS, HOST_BATCHES = 3, 5, 2
STAGES = ("augment", "train_forward", "train_loss", "tal_assign",
          "train_backward", "train_update", "train_ema")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--model", default="hockey-player-detection")
    ap.add_argument("--imgsz", type=int, default=640)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)

    s, b = args.imgsz, args.batch
    cfg = MODEL_ZOO[args.model]
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "pool.npz")
        write_pool(path, *square_players(seed=21, n=32, s=s))
        dataset = PoolDataset(path)
        pool = stage_pool(dataset, device="cuda")
    model = build_model(cfg, load_params(shipped_weights_path(args.model))).to(
        "cuda", memory_format=torch.channels_last)
    trainer = Trainer(cfg, TrainConfig(imgsz=s, learning_rate=1e-4), model,
                      ema_decay=0.999)
    batch_fn = make_device_batch_fn(s, b, mosaic_prob=1.0, mixup_prob=0.15)
    gen = torch.Generator(device="cuda").manual_seed(0)

    def step():
        return float(trainer.step(batch_fn(pool, gen))["loss"])

    def wall_ms():
        for _ in range(WARMUP):  # cuDNN's algorithm choice
            step()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        return 1e3 * (time.perf_counter() - t) / ITERS

    torch.cuda.reset_peak_memory_stats()
    ms_default = wall_ms()
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(ITERS):
            step()
        torch.cuda.synchronize()
        prof_ms = 1e3 * (time.perf_counter() - t) / ITERS
    torch.backends.cudnn.benchmark = True
    ms_benchmark = wall_ms()
    torch.backends.cudnn.benchmark = False

    events = prof.key_averages()
    stage_ms = {e.key: e.device_time_total / 1e3 / ITERS for e in events
                if e.key in STAGES and e.device_type == DeviceType.CPU}
    kernels = [(e.key[:100], e.self_device_time_total / 1e3 / ITERS, e.count // ITERS)
               for e in events if e.device_type == DeviceType.CUDA
               and e.key not in STAGES and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy = sum(k[1] for k in kernels)

    it = batch_iterator(dataset, b, HOST_BATCHES, seed=0, mosaic_prob=1.0,
                        mixup_prob=0.15)
    t = time.perf_counter()
    for _ in it:
        pass
    host_ms = 1e3 * (time.perf_counter() - t) / HOST_BATCHES

    result = {
        "card": card, "device": torch.cuda.get_device_name(0),
        "model": args.model, "imgsz": s, "batch": b, "compute": "bf16",
        "step_ms_cudnn_default": round(ms_default, 3),
        "step_ms_cudnn_benchmark": round(ms_benchmark, 3),
        "images_per_s_cudnn_default": round(1e3 * b / ms_default, 2),
        "images_per_s_cudnn_benchmark": round(1e3 * b / ms_benchmark, 2),
        "profiled_step_ms": round(prof_ms, 3),
        "stage_device_ms_per_step": {k: round(v, 4) for k, v in stage_ms.items()},
        "all_device_ms_per_step": round(busy, 3),
        "device_busy_share": round(busy / prof_ms, 4),
        "peak_memory_gib": round(peak, 3),
        "host_batch_iterator_ms_per_batch": round(host_ms, 1),
        "top_kernels_ms_per_step": [[k, round(ms, 4), n] for k, ms, n in kernels[:15]],
    }
    line = json.dumps(result)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
