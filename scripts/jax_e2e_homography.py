#!/usr/bin/env python3
"""Run the JAX package's homography harness, scripts/e2e_homography.py,
as the reference for scripts/torch_e2e_homography.py, with its protocol
unchanged:

    JAX_PLATFORMS=cpu HOCKEY_E2E_LOGS=logs/torch_e2e/jax_cpu \
        python scripts/jax_e2e_homography.py [--f32] [--tmp DIR] -- --cpu [--tag f32]

Arguments after `--` go to e2e_homography.py. Three changes around it:

- its clip goes to a temporary directory (`--tmp`, default the system's)
  instead of the fixed /tmp/e2e_homography_clip.mp4;
- the frames where the calibrator's camera-motion probe fired are added
  to its JSON line as `moved_frames`, as the port's harness reports them;
- with `--f32` the JAX dual program is rebuilt at f32 on the unfused f32
  weights (the JAX detectors fold and cast them to bf16 on every
  backend), the precision of the port's `--dtype f32`.

`HOCKEY_E2E_LOGS` must be set, so that the TPU run's
logs/e2e_homography.json stays as it is. Needs JAX and OpenCV (CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--f32", action="store_true",
                   help="the dual program at f32 on the unfused weights")
    p.add_argument("--tmp", default=None, help="directory for the clip")
    args, rest = p.parse_known_args()
    rest = [a for a in rest if a != "--"]
    logs = os.environ.get("HOCKEY_E2E_LOGS")
    if not logs:  # logs/e2e_homography.json is the TPU run's record
        raise SystemExit("set HOCKEY_E2E_LOGS to the directory for the JSON")

    import hockey_tpu.pipeline as pipeline

    moved = []

    class Processor(pipeline.VideoProcessor):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            probe = self.calibrator.movement.update
            self.calibrator.movement.update = \
                lambda f: moved.append(probe(f)) or moved[-1]
            if args.f32:
                self._dual_f32()

        def _dual_f32(self):
            import jax
            import jax.numpy as jnp

            from hockey_tpu.models import dual
            from hockey_tpu.models.checkpoint import (load_params,
                                                      shipped_weights_path)

            c, d = self.config, self.player_detector
            tree = lambda name: jax.tree_util.tree_map(  # noqa: E731
                jnp.asarray, load_params(shipped_weights_path(name)))
            d.player_params = tree(c.player_model_name)
            d.rink_params = tree(c.hockey_model_name)
            d._fn = dual.build_dual_fn(
                d.player_cfg, d.rink_cfg, imgsz=c.detection_imgsz,
                frame_hw=self.frame_hw, rink_imgsz=c.rink_imgsz,
                conf=c.detection_confidence, iou=c.nms_iou_threshold,
                containment=c.nms_containment_threshold,
                pre_topk=c.nms_pre_topk, max_det=c.max_detections,
                with_team_features=False, dtype=jnp.float32)

    pipeline.VideoProcessor = Processor
    harness = os.path.join(ROOT, "scripts", "e2e_homography.py")
    with open(harness) as f:
        src = f.read()
    tmp = tempfile.mkdtemp(dir=args.tmp)
    clip = os.path.join(tmp, "e2e_homography_clip.mp4")
    old = '"/tmp/e2e_homography_clip.mp4"'
    if src.count(old) != 1:
        raise RuntimeError("e2e_homography.py no longer names its clip " + old)
    src = src.replace(old, repr(clip))
    sys.argv = [harness] + rest
    scope = {"__name__": "e2e_homography", "__file__": harness}
    exec(compile(src, harness, "exec"), scope)
    rc = scope["main"]()
    os.remove(clip)
    os.rmdir(tmp)

    tag = rest[rest.index("--tag") + 1] if "--tag" in rest else None
    path = os.path.join(logs, f"e2e_homography_{tag}.json" if tag
                        else "e2e_homography.json")
    with open(path) as f:
        out = json.loads(f.read())
    out["moved_frames"] = [i for i, m in enumerate(moved) if m]
    out["dual_dtype"] = "f32" if args.f32 else "bf16"
    line = json.dumps(out)
    with open(path, "w") as f:
        f.write(line + "\n")
    print(line)
    return rc


if __name__ == "__main__":
    raise SystemExit(main())
