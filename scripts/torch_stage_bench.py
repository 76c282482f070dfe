#!/usr/bin/env python3
"""Host stacking and upload of one frame batch on a CUDA machine.

    python3 scripts/torch_stage_bench.py [--out F]

Eight 1080p frames at a time, taken in turn from a 64-frame clip as the
benchmark's clip is played, are stacked:

- by a fresh `np.stack`, the stacking without staging;
- by `core/staging.py` `stage` on one thread;
- by `stage` on its pool of `staging.WORKERS` threads;

each 40 times while the previous batch is still held, as the pipeline
holds it; the medians, minima and maxima of the last 35 are in ms. Then
30 batches of each kind go through `staging.upload`: host ms of the call
and device ms by CUDA events around it. Prints one JSON line (and writes
it to `--out`), with the staging counters and the pinned allocator's
block count where this PyTorch has `torch.cuda.host_memory_stats`.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from hockey_tpu_torch.core import staging  # noqa: E402

BATCH = 8
CLIP = 64


def _frames(clip: np.ndarray, k: int):
    return [clip[(BATCH * k + j) % CLIP] for j in range(BATCH)]


def time_stack(clip, fn, n: int = 40, skip: int = 5):
    """(median, min, max) host ms of `fn` on n batches, the first `skip`
    left out. `batch` holds the last batch while the next is stacked."""
    ts = []
    for k in range(n):
        t = time.perf_counter()
        batch = fn(_frames(clip, k))
        ts.append(1e3 * (time.perf_counter() - t))
    ts = ts[skip:]
    return [round(statistics.median(ts), 3), round(min(ts), 3), round(max(ts), 3)]


def time_upload(clip, fn, dev, n: int = 30, skip: int = 5):
    host, device = [], []
    for k in range(n):
        batch = fn(_frames(clip, k))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        t = time.perf_counter()
        e0.record()
        staging.upload(batch, dev)
        e1.record()
        host.append(1e3 * (time.perf_counter() - t))
        torch.cuda.synchronize()
        device.append(e0.elapsed_time(e1))
    return {"host_ms": round(statistics.median(host[skip:]), 3),
            "device_ms": round(statistics.median(device[skip:]), 3)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    clip = np.random.default_rng(0).integers(0, 256, (CLIP, 1080, 1920, 3), np.uint8)
    out = {"device": torch.cuda.get_device_name(0), "workers": staging.WORKERS,
           "np_stack_ms": time_stack(clip, np.stack)}
    workers = staging.WORKERS
    staging.WORKERS = 1
    out["stage_1_thread_ms"] = time_stack(clip, staging.stage)
    staging.WORKERS = workers
    out["stage_pool_ms"] = time_stack(clip, staging.stage)
    staging.stats.reset()
    out["upload_pageable"] = time_upload(clip, np.stack, dev)
    out["upload_staged"] = time_upload(clip, staging.stage, dev)
    out["uploads"] = staging.stats.as_dict()
    if hasattr(torch.cuda, "host_memory_stats"):
        out["pinned_blocks"] = torch.cuda.host_memory_stats().get("num_host_alloc")
    line = json.dumps({"stage_bench": out})
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
