"""CLI entry point of the port (the flags of hockey_tpu/cli/main.py that
the PLAYER_DETECTION and PLAYER_TRACKING modes use).

    python -m hockey_tpu_torch.cli.main --mode PLAYER_TRACKING \
        --source_path in.mp4 --target_path out.mp4 --headless \
        [--device cuda|cpu] [--conf X] [--annotator box|ellipse|styled] \
        [--imgsz N] [--frame-batch N] [--limit-frames N]
"""

from __future__ import annotations

import argparse
from pathlib import Path

from ..core.config import Config, ProcessingMode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Hockey Vision Analytics (PyTorch/CUDA port)")
    p.add_argument("--source_path", type=str, required=True,
                   help="Path to the source video file.")
    p.add_argument("--target_path", type=str, default=None,
                   help="Path to save the output video.")
    p.add_argument("--device", type=str, default="cuda",
                   help="'cuda' (default) or 'cpu'.")
    p.add_argument("--mode", type=str, default="PLAYER_DETECTION",
                   choices=[m.value for m in ProcessingMode],
                   help="Processing mode; the port runs PLAYER_DETECTION "
                        "and PLAYER_TRACKING (the others raise).")
    p.add_argument("--headless", action="store_true",
                   help="No OpenCV windows.")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Player-model msgpack checkpoint.")
    p.add_argument("--frame-batch", type=int, default=None,
                   help="Frames per device detection batch.")
    p.add_argument("--imgsz", type=int, default=None,
                   help="Detection resolution (default 1280).")
    p.add_argument("--conf", type=float, default=None,
                   help="Detection confidence threshold (default 0.4).")
    p.add_argument("--annotator", type=str, default="box",
                   choices=["box", "ellipse", "styled"],
                   help="Player annotator style: rectangles (reference "
                        "default), ground ellipses, or styled label chips.")
    p.add_argument("--limit-frames", type=int, default=None,
                   help="Stop after N output frames.")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if not Path(args.source_path).exists():
        raise FileNotFoundError(f"Source video not found: {args.source_path}")

    config = Config()
    if args.frame_batch:
        config.frame_batch = args.frame_batch
    if args.imgsz:
        config.detection_imgsz = args.imgsz
    if args.conf is not None:
        config.detection_confidence = args.conf
    config.annotator_style = args.annotator

    from ..pipeline import VideoProcessor, process_video_with_display
    from ..video.io import VideoInfo

    info = VideoInfo.from_video_path(args.source_path)
    processor = VideoProcessor(
        config=config,
        device=args.device,
        mode=ProcessingMode(args.mode),
        frame_hw=(info.height, info.width),
        checkpoint=args.checkpoint,
    )
    n = process_video_with_display(processor, args.source_path,
                                   args.target_path,
                                   display=not args.headless,
                                   limit=args.limit_frames)
    print(f"Processed {n} frames.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
