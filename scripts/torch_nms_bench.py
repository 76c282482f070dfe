#!/usr/bin/env python3
"""The NMS suppression kernel of this tree against another tree's, on one GPU.

    python3 scripts/torch_nms_bench.py [--other DIR] [--out F]

Two inputs, both B=8 frames of K=256 candidates:

- the main path's own candidates: the last batch of chip_smoke.py's
  synthetic 1080p frames through the shipped YOLOv8x player detector in
  bf16, up to `DetectCore.candidates`;
- chip_smoke.py's dense case (`kernel_cases`' containment matrix of random
  boxes), where most candidates are valid and most of those survive.

The kernels: this tree's, and with `--other` the one of the tree at DIR
(its `hockey_tpu_torch/ops/nms_kernel.py`, loaded by path, builds that
tree's own source into that tree's `build/`). They run in turns (other,
this, this, other). On each input each turn takes:

- device ms per launch: the kernel's own durations in a torch.profiler
  trace of 50 launches;
- the same by CUDA events around 50 launches queued behind a device sleep,
  as a check on the profiler;
- call ms: CUDA events over 200 back-to-back wrapper calls, the host's
  call rate;

and checks the kept set against `suppress_reference`. Also prints the
plain version's time and the bound of each input, and, in the same turns,
the detect step's frames/s with each kernel, in twice as many turns:
`Detector.detect_batch` on the last batch, 20 batches after one warm-up,
by the host clock (only the kernel the detect step calls is swapped).
Prints the card line first and one JSON object as the last line (also
written to `--out`).
"""

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import (BATCH, FRAME_HW, N_BATCHES, card_line,  # noqa: E402
                        device_ms, kernel_cases, queued_ms, suppress_bound,
                        synthetic_frames, time_ms)
from hockey_tpu_torch.core.config import Config  # noqa: E402
from hockey_tpu_torch.models import detector as detector_module  # noqa: E402
from hockey_tpu_torch.models.detector import Detector  # noqa: E402
from hockey_tpu_torch.ops.nms_kernel import (suppress,  # noqa: E402
                                             suppress_reference)


def load_wrapper(tree: str):
    """The `suppress` wrapper of the tree at `tree`, as a module of its own."""
    path = os.path.join(tree, "hockey_tpu_torch", "ops", "nms_kernel.py")
    spec = importlib.util.spec_from_file_location("other_nms_kernel", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.suppress


STEP_BATCHES = 20


def step_fps(det, frames, wrapper) -> float:
    """Frames/s of det.detect_batch(frames) with `wrapper` as the step's
    suppression kernel, over STEP_BATCHES batches after one warm-up."""
    detector_module.suppress = wrapper
    try:
        det.detect_batch(frames).boxes.cpu()
        before = wrapper.launches
        t = time.perf_counter()
        for _ in range(STEP_BATCHES):
            det.detect_batch(frames).boxes.cpu()
        fps = len(frames) * STEP_BATCHES / (time.perf_counter() - t)
    finally:
        detector_module.suppress = suppress
    if wrapper.launches - before != STEP_BATCHES:
        raise AssertionError("the detect step did not go through the kernel")
    return fps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", default=None,
                    help="root of another tree whose kernel to time in turns")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    card = card_line()
    print(card, flush=True)

    kernels = {"this": suppress}
    if args.other:
        kernels["other"] = load_wrapper(args.other)
    for wrapper in kernels.values():
        wrapper.load()

    cfg = Config()
    det = Detector(cfg.player_model_name, cfg, frame_hw=FRAME_HW,
                   device="cuda", dtype=torch.bfloat16)
    frames = synthetic_frames(seed=0, n=BATCH * N_BATCHES)
    last = torch.as_tensor(frames[-BATCH:]).to(dev)
    with torch.inference_mode():
        cand = det.core.candidates(det.model, last)
    name, m, keep0, thr = kernel_cases(dev)[1]
    inputs = {"main path B=8 K=256": (cand.matrix, cand.keep0, cand.thr),
              f"dense {name}": (m, keep0, thr)}

    info = {}
    for label, (m, keep0, thr) in inputs.items():
        ref = suppress_reference(m, keep0, thr)
        bound_ms, nbytes, _ = suppress_bound(ref)
        info[label] = {
            "valid": keep0.sum(1).tolist(), "kept": ref.sum(1).tolist(),
            "bound_ms": bound_ms, "bound_bytes": nbytes,
            "plain_ms": time_ms(lambda: suppress_reference(m, keep0, thr), 10)}
        print(label, json.dumps(info[label]), flush=True)

    order = ["other", "this", "this", "other"] if args.other else ["this", "this"]
    runs = []
    for who in order:
        wrapper = kernels[who]
        for label, (m, keep0, thr) in inputs.items():
            def call():
                return wrapper(m, keep0, thr)
            if not torch.equal(call(), suppress_reference(m, keep0, thr)):
                raise AssertionError(f"{who} kernel != plain version on {label}")
            ms, how = device_ms(call)
            run = {"kernel": who, "input": label, "device_ms": ms, "how": how,
                   "queued_ms": queued_ms(call), "call_ms": time_ms(call, 200)}
            runs.append(run)
            print(json.dumps(run), flush=True)
    for who in order * 2:
        run = {"kernel": who, "input": "detect step",
               "frames_per_s": step_fps(det, frames[-BATCH:], kernels[who])}
        runs.append(run)
        print(json.dumps(run), flush=True)

    result = {"card": card, "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "other": args.other,
              "inputs": info, "runs": runs}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
