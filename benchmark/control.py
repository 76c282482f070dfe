#!/usr/bin/env python3
"""The readings that a cell's limits are set from, on the GPU.

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 [--seconds 4] [--out F]

For each seed, one process runs the cell as benchmark/run.py does (set-up,
a window of `--seconds`, the checks against the plain reference) and, on
the same sampled frames, the control: the reference put in the program's
place one precision lower than the configuration states (the detector
with float8 e4m3 convolutions for bfloat16, the team branch in bfloat16
for float32), read by the same comparison. It prints one JSON line per
seed, {seed, program: {check: reading}, control: {check: reading}}, and
writes them all to `--out`. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "benchmark", "triton")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out")
    args = ap.parse_args()

    import torch

    from benchmark.harness import cell as cellmod

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    rows = []
    for seed in args.seeds:
        cell = cellmod.Cell.load(args.workload)
        driver = cellmod.load_module(
            os.path.join(cellmod.BENCH_DIR, "drivers", f"{cell.workload['driver']}.py"),
            f"bench_driver_{cell.workload['driver']}")
        out = driver.run(cell, seed=seed, seconds=args.seconds, trace=False,
                         device="cuda", t_start=time.perf_counter(), control=True)
        row = {"seed": seed, "program": {c.name: c.value for c in out.checks},
               "control": out.notes["control"],
               "frames_per_s": out.metrics["frames_per_s"],
               "program_gaps": out.notes.get("gaps"),
               "control_gaps": out.notes.get("control_gaps"),
               "team_feat_gap_p99": out.notes.get("team_feat_gap_p99"),
               "fault_half_batch": out.notes.get("fault_half_batch"),
               "spread": out.notes.get("spread")}
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
