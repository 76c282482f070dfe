#!/usr/bin/env python3
"""The benchmark of hockey_tpu_torch: one run of one cell on the GPUs of
this machine.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With `--trace 0` it measures the cell's end-to-end metrics over a window
of `--seconds` seconds; with `--trace 1` it profiles a short steady
window and reports the cell's per-layer metrics instead. Either way it
then holds what the timed path produced against the plain reference
(benchmark/reference/) and prints, as the last line of its standard
output, one JSON object: correct, attempted, failed, metrics, device
(and with --trace 1 a breakdown), and last the checks, each number with
its limit. The same checks are the last lines of its standard error.

It exits with a code other than 0, and prints no result, without CUDA or
with fewer GPUs than the cell asks for, or if jax, jaxlib, flax or the
JAX package is loaded once the window has closed. Every build and kernel
cache it or the program writes is inside the checkout (build/).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


# the process started this long before the first line of this file ran;
# set-up is counted from the process's start
T_START = time.perf_counter() - process_age_s()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "build", "benchmark")
os.environ["TRITON_CACHE_DIR"] = os.path.join(CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(CACHE, "torch_extensions")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch

    from benchmark.harness import cell as cellmod

    cell = cellmod.Cell.load(args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the GPU only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} GPUs, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    driver = cellmod.load_module(
        os.path.join(cellmod.BENCH_DIR, "drivers", f"{cell.workload['driver']}.py"),
        f"bench_driver_{cell.workload['driver']}")
    outcome = driver.run(cell, seed=args.seed, seconds=args.seconds,
                         trace=bool(args.trace), device="cuda", t_start=T_START)
    breakdown = outcome.run.breakdown() if args.trace else None
    out, lines = cellmod.result_line(
        cell, outcome, cellmod.device_info(torch, cell.chips,
                                           outcome.memory_peak_bytes),
        bool(args.trace), breakdown)
    found = cellmod.forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package loaded: {found}", file=sys.stderr)
        return 3
    for k, v in outcome.notes.items():
        print(f"{k}: {v}", file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
