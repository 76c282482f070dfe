"""Does a frame's bf16 output on the card depend on its index in the
batch, and do cuDNN's deterministic mode or the memory format remove the
dependence?

    python scripts/torch_batch_position.py [--batch 4] [--out F]

The shipped YOLOv8x player model in bf16 (BN folded, as `Detector`
holds it) at the main path's 736x1280 input on chip_smoke.py's 1080p
scene. The same frame X goes in at index 0 of one batch and at the last
index of another, beside the same companions, under each setting:

- default: channels_last, `cudnn.deterministic` off, benchmark off;
- deterministic: `torch.backends.cudnn.deterministic = True`;
- benchmark: `torch.backends.cudnn.benchmark = True`;
- nchw: the model and its input in contiguous NCHW memory;
- nchw + deterministic;
- f32 (TF32 convolutions, PyTorch's default), channels_last.

For each, the largest |difference| of X's raw class logits and DFL box
logits between the two positions, and of X's padded detections through
`Detector.detect_batch` (the first three settings and f32; the nchw
settings run the network alone). Prints the card line and one JSON line,
also written to `--out`. Needs a CUDA GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from chip_smoke import FRAME_HW, card_line, synthetic_frames  # noqa: E402
from hockey_tpu_torch.core.config import Config  # noqa: E402
from hockey_tpu_torch.models.detector import Detector  # noqa: E402
from hockey_tpu_torch.ops.letterbox import letterbox_rect_batch  # noqa: E402


def raw_logits(det, frames, nchw):
    """(cls (B, A, nc), box (B, A, 64)) raw head logits of the network on
    frames, in f32."""
    x = letterbox_rect_batch(torch.as_tensor(frames).cuda(), det.imgsz, 32, det.dtype)
    x = x.permute(0, 3, 1, 2)
    model = det.model
    if nchw:
        x = x.contiguous()
        model = model.to(memory_format=torch.contiguous_format)
    with torch.inference_mode():
        out = model(x)
    if nchw:
        det.model.to(memory_format=torch.channels_last)
    b = x.shape[0]
    cls = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1])
                     for m in out["cls"]], 1).float()
    box = torch.cat([m.permute(0, 2, 3, 1).reshape(b, -1, m.shape[1])
                     for m in out["box"]], 1).float()
    return cls, box


def compare(det, frames, b, nchw, detections):
    """X = frames[0] at index 0 and at index b - 1, beside frames[1:b]."""
    first = frames[:b]
    last = frames[list(range(1, b)) + [0]]
    c0, x0 = raw_logits(det, first, nchw)
    c1, x1 = raw_logits(det, last, nchw)
    again, _ = raw_logits(det, first, nchw)
    out = {"cls_logit_max_abs_diff": float((c0[0] - c1[-1]).abs().max()),
           "box_logit_max_abs_diff": float((x0[0] - x1[-1]).abs().max()),
           "run_to_run_cls_max_abs_diff": float((c0 - again).abs().max())}
    if detections:
        d0 = det.detect_batch(first)
        d1 = det.detect_batch(last)
        same = (torch.equal(d0.valid[0], d1.valid[-1])
                and torch.equal(d0.classes[0], d1.classes[-1]))
        out["detections_valid_and_classes_equal"] = bool(same)
        out["detection_box_max_abs_diff_px"] = (
            float((d0.boxes[0] - d1.boxes[-1]).abs().max()) if same else None)
        out["detection_score_max_abs_diff"] = (
            float((d0.scores[0] - d1.scores[-1]).abs().max()) if same else None)
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--out", default=None)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(card_line(), flush=True)
    frames = synthetic_frames(seed=1, n=args.batch)
    cfg = Config()
    res = {"card": card_line(), "batch": args.batch}
    cudnn = torch.backends.cudnn
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        det = Detector(cfg.player_model_name, cfg, frame_hw=FRAME_HW,
                       device="cuda", dtype=dtype)
        settings = ([("default", False, False, False),
                     ("deterministic", True, False, False),
                     ("benchmark", False, True, False),
                     ("nchw", False, False, True),
                     ("nchw_deterministic", True, False, True)]
                    if tag == "bf16" else [("default", False, False, False)])
        for name, deterministic, benchmark, nchw in settings:
            cudnn.deterministic, cudnn.benchmark = deterministic, benchmark
            res[f"{tag}_{name}"] = compare(det, frames, args.batch, nchw,
                                           detections=not nchw)
            print(f"{tag} {name}: {res[f'{tag}_{name}']}", flush=True)
        cudnn.deterministic = cudnn.benchmark = False
        del det
    line = json.dumps(res)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
