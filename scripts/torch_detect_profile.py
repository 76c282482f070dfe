#!/usr/bin/env python3
"""Where the time of the port's PLAYER_DETECTION step goes, on one GPU.

    python3 scripts/torch_detect_profile.py [--out F]

Runs `Detector.detect_batch` (the shipped YOLOv8x player detector, bf16)
on seeded synthetic 1080p frames (736x1280 network input; the frames of
chip_smoke.py), 8 frames per batch, under torch.profiler for 10 batches
after 3 warm-up batches, and reports from that one trace:

- the device time of each stage of the step per batch, from the step's
  own `record_function` ranges (upload, letterbox, forward, decode,
  nms_candidates, nms_select_unmap), and for nms_suppress from the
  suppression kernel's own events by name: the trace does not link a
  kernel launched through the kernel's ctypes library to the range it was
  launched in;
- the device busy share: the device time of all kernels and copies over
  the wall time of the profiled loop;
- the CUDA kernels with the most device time.

Prints one JSON object as its last line (and writes it to `--out` when
given). Needs CUDA.
"""

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import BATCH, FRAME_HW, KERNEL_NAME, synthetic_frames  # noqa: E402
from hockey_tpu_torch.core.config import Config  # noqa: E402
from hockey_tpu_torch.models.detector import Detector  # noqa: E402

ITERS = 10
STAGES = ("upload", "letterbox", "forward", "decode", "nms_candidates",
          "nms_suppress", "nms_select_unmap")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)

    cfg = Config()
    det = Detector(cfg.player_model_name, cfg, frame_hw=FRAME_HW, device="cuda",
                   dtype=torch.bfloat16)
    frames = synthetic_frames(seed=0, n=BATCH)
    for _ in range(3):  # warm-up: cuDNN algorithm choice, kernel build
        det.detect_batch(frames).boxes.cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for _ in range(ITERS):
            det.detect_batch(frames).boxes.cpu()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)

    events = prof.key_averages()
    # a host-side range reports the device time of the work launched in it
    stage_ms = {e.key: e.device_time_total / 1e3 / ITERS for e in events
                if e.key in STAGES and e.device_type == DeviceType.CPU}
    # device-side events only (kernels, copies), without the ranges' own
    # device-side spans: host-side ops report their kernels' time again
    kernels = [(e.key[:120], e.self_device_time_total / 1e3, e.count)
               for e in events
               if e.device_type == DeviceType.CUDA and e.key not in STAGES
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    stage_ms["nms_suppress"] = sum(ms for k, ms, _ in kernels
                                   if KERNEL_NAME in k) / ITERS
    result = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "batch": BATCH,
        "input_hw": list(det.core.in_hw),
        "stage_device_ms_per_batch": {k: round(stage_ms.get(k, 0.0), 4)
                                      for k in STAGES},
        "device_ms_per_batch": round(busy_ms / ITERS, 4),
        "wall_ms_per_batch": round(wall_ms / ITERS, 4),
        "frames_per_s": round(1e3 * BATCH * ITERS / wall_ms, 3),
        "device_busy_share": round(busy_ms / wall_ms, 4),
        "top_kernels_ms": [[k, round(ms, 3), n] for k, ms, n in kernels[:15]],
    }
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
