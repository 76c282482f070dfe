#!/usr/bin/env python3
"""Run the JAX package's validation CLI (`python -m hockey_tpu.train.val`)
as the reference for the port's (`python -m hockey_tpu_torch.train.val`),
its arguments and JSON line unchanged:

    JAX_PLATFORMS=cpu python scripts/jax_val.py [--f32] -- --cpu \
        --dataset hard --limit 16 --json

Arguments after `--` go to the JAX CLI. With `--f32` its detectors are
built at f32 on the BN-folded f32 weights, the precision of the port's
CPU default: the JAX `Detector` folds BN and casts the weights to bf16,
and its detect program computes in bf16, on every backend, so the plain
JAX CLI on the CPU runs bf16. Needs JAX and OpenCV (CPU).
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--f32", action="store_true",
                   help="the detect program at f32 on f32 folded weights")
    args, rest = p.parse_known_args()
    rest = [a for a in rest if a != "--"]
    if args.f32:
        import jax.numpy as jnp

        from hockey_tpu.models import detector
        from hockey_tpu.models.layers import fuse_model

        build = detector.build_detect_fn
        detector.fuse_for_inference = fuse_model
        detector.build_detect_fn = \
            lambda cfg, **kw: build(cfg, **kw, dtype=jnp.float32)

    from hockey_tpu.train.val import main as val_main

    return val_main(rest)


if __name__ == "__main__":
    raise SystemExit(main())
