"""CLI entry point of the port (the flags of hockey_tpu/cli/main.py that
the four modes, the rink keypoints and the 2D map use; TEAM_CLASSIFICATION
is the default, as there).

    python -m hockey_tpu_torch.cli.main --source_path in.mp4 \
        --target_path out.mp4 --headless [--team-names "HOME,AWAY"] \
        [--mode TEAM_CLASSIFICATION|PLAYER_TRACKING|PLAYER_DETECTION|PUCK_DETECTION] \
        [--rink-keypoints] [--show-2d-map] [--calibration PROFILE.json] \
        [--device cuda|cpu] [--conf X] [--annotator box|ellipse|styled] \
        [--checkpoint F] [--rink-checkpoint F] [--puck-checkpoint F] \
        [--imgsz N] [--frame-batch N] [--limit-frames N]
"""

from __future__ import annotations

import argparse
import os
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
    p.add_argument("--rink-keypoints", action="store_true",
                   help="Enable rink keypoint detection.")
    p.add_argument("--mode", type=str, default="TEAM_CLASSIFICATION",
                   choices=[m.value for m in ProcessingMode],
                   help="Processing mode (default TEAM_CLASSIFICATION).")
    p.add_argument("--show-2d-map", action="store_true",
                   help="Overlay the 2D overhead rink map.")
    p.add_argument("--calibration", type=str, default=None,
                   help="Calibration profile JSON to load (2D map).")
    p.add_argument("--headless", action="store_true",
                   help="No OpenCV windows; use default/provided team names.")
    p.add_argument("--team-names", type=str, default=None,
                   help="Comma-separated 'HOME,AWAY' names (headless init).")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="Player-model msgpack checkpoint.")
    p.add_argument("--rink-checkpoint", type=str, default=None,
                   help="Rink pose-model msgpack checkpoint.")
    p.add_argument("--puck-checkpoint", type=str, default=None,
                   help="Puck-model msgpack checkpoint (PUCK_DETECTION).")
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
    if args.headless:  # the team selector takes the names without its UI
        os.environ["HOCKEY_TPU_HEADLESS"] = "1"
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
    team_names = None
    if args.team_names:
        parts = args.team_names.split(",")
        if len(parts) == 2:
            team_names = (parts[0].strip(), parts[1].strip())
    processor = VideoProcessor(
        config=config,
        device=args.device,
        mode=ProcessingMode(args.mode),
        frame_hw=(info.height, info.width),
        checkpoint=args.checkpoint,
        puck_checkpoint=args.puck_checkpoint,
        team_names=team_names,
        enable_rink_keypoints=args.rink_keypoints,
        show_2d_map=args.show_2d_map,
        rink_checkpoint=args.rink_checkpoint,
        calibration_profile=args.calibration,
    )
    n = process_video_with_display(processor, args.source_path,
                                   args.target_path,
                                   display=not args.headless,
                                   limit=args.limit_frames)
    print(f"Processed {n} frames.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
