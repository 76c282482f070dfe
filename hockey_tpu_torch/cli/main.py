"""CLI entry point of the port: the flags of hockey_tpu/cli/main.py, and
its control flow (:120-215); TEAM_CLASSIFICATION is the default, as there.

    python -m hockey_tpu_torch.cli.main --source_path in.mp4 \
        --target_path out.mp4 --headless [--team-names "HOME,AWAY"] \
        [--mode TEAM_CLASSIFICATION|PLAYER_TRACKING|PLAYER_DETECTION|PUCK_DETECTION] \
        [--rink-keypoints] [--show-2d-map] [--calibration PROFILE.json] \
        [--device cuda|cpu] [--conf X] [--annotator box|ellipse|styled] \
        [--checkpoint F] [--rink-checkpoint F] [--puck-checkpoint F] \
        [--imgsz N] [--frame-batch N] [--limit-frames N] \
        [--save-state F [--save-state-every N]] [--resume F] \
        [--json-metrics F] [--profile DIR]
    python -m hockey_tpu_torch.cli.main --sources a.mp4,b.mp4 \
        --target_path out.mp4 ...      # writes out_0.mp4, out_1.mp4

- `--sources`: the multi-clip mode (multiclip.py), one detection batch
  per frame row across the clips; the targets are `<stem>_<i><suffix>`.
- `--save-state` writes the run state (core/session.py) every
  `--save-state-every` frames and at the end; `--resume` restores one and
  continues from its frame, without the team fit.
- `--json-metrics` writes the per-stage timers and counters as JSON (on
  CUDA also `uploads`, the staging counters of core/staging.py);
  `--profile` writes a torch.profiler Chrome trace (`trace.json`) of the
  run into a directory.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

from ..core.config import Config, ProcessingMode


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Hockey Vision Analytics (PyTorch/CUDA port)")
    p.add_argument("--source_path", type=str, default=None,
                   help="Path to the source video file (required unless "
                        "--sources is given).")
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
    p.add_argument("--json-metrics", type=str, default=None,
                   help="Write per-stage timing/counters JSON here.")
    p.add_argument("--sources", type=str, default=None,
                   help="Comma-separated clip list for multi-clip batch "
                        "mode (one detection batch per frame across clips; "
                        "overrides --source_path).")
    p.add_argument("--resume", type=str, default=None,
                   help="Resume from a run-state file (core/session.py).")
    p.add_argument("--save-state", type=str, default=None,
                   help="Write run state here (for later --resume).")
    p.add_argument("--save-state-every", type=int, default=300,
                   help="Autosave interval in frames when --save-state set.")
    p.add_argument("--profile", type=str, default=None,
                   help="Write a torch.profiler trace to this directory.")
    return p


def _config(args) -> Config:
    config = Config()
    if args.frame_batch:
        config.frame_batch = args.frame_batch
    if args.imgsz:
        config.detection_imgsz = args.imgsz
    if args.conf is not None:
        config.detection_confidence = args.conf
    config.annotator_style = args.annotator
    return config


def _team_names(args):
    parts = args.team_names.split(",") if args.team_names else []
    return (parts[0].strip(), parts[1].strip()) if len(parts) == 2 else None


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.headless:  # the team selector takes the names without its UI
        os.environ["HOCKEY_TPU_HEADLESS"] = "1"
    if args.sources:
        return _main_multiclip(args)
    if not args.source_path:
        raise SystemExit("--source_path (or --sources) is required")
    if not Path(args.source_path).exists():
        raise FileNotFoundError(f"Source video not found: {args.source_path}")

    from ..pipeline import (
        VideoProcessor,
        VideoSinkWriter,
        process_video_with_display,
    )
    from ..core import staging
    from ..utils.profiling import device_trace
    from ..video.io import VideoInfo

    info = VideoInfo.from_video_path(args.source_path)
    processor = VideoProcessor(
        config=_config(args),
        device=args.device,
        mode=ProcessingMode(args.mode),
        frame_hw=(info.height, info.width),
        checkpoint=args.checkpoint,
        puck_checkpoint=args.puck_checkpoint,
        team_names=_team_names(args),
        enable_rink_keypoints=args.rink_keypoints,
        show_2d_map=args.show_2d_map,
        rink_checkpoint=args.rink_checkpoint,
        calibration_profile=args.calibration,
    )
    with device_trace(args.profile):
        start_frame = 0
        if args.resume:
            from ..core.session import load_run_state

            start_frame = load_run_state(args.resume, processor)
            print(f"Resumed from {args.resume} at frame {start_frame}")
        if args.resume or args.save_state:
            import cv2

            from ..core.session import save_run_state

            frames = processor.process_video(
                args.source_path, start_frame=start_frame,
                skip_init=bool(args.resume), limit=args.limit_frames)
            sink = (VideoSinkWriter(args.target_path, info)
                    if args.target_path else None)
            n = 0
            try:
                for frame in frames:
                    if sink:
                        sink.write(frame)
                    n += 1
                    if args.save_state and n % args.save_state_every == 0:
                        save_run_state(args.save_state, processor, start_frame + n)
                    if not args.headless:
                        cv2.imshow("Hockey Vision", frame)
                        if cv2.waitKey(1) & 0xFF == ord("q"):
                            break
                if args.save_state:
                    save_run_state(args.save_state, processor, start_frame + n)
                    print(f"Run state saved to {args.save_state}")
            finally:
                # the mp4 is finished and the windows closed on an
                # exception or a 'q' too
                if sink:
                    sink.close()
                if not args.headless:
                    cv2.destroyAllWindows()
        else:
            n = process_video_with_display(processor, args.source_path,
                                           args.target_path,
                                           display=not args.headless,
                                           limit=args.limit_frames)
    print(f"Processed {n} frames.")
    # on CUDA, how many batches were uploaded from page-locked staging
    # and how many by the blocking copy (core/staging.py)
    uploads = ({"uploads": staging.stats.as_dict()}
               if processor.device.type == "cuda" else {})
    processor.timers.dump_json(args.json_metrics, **uploads)
    if args.json_metrics:
        print(f"Metrics written to {args.json_metrics}")
    return 0


def _main_multiclip(args) -> int:
    """The multi-clip mode: K clips, one detection batch per frame row."""
    sources = [s.strip() for s in args.sources.split(",") if s.strip()]
    for s in sources:
        if not Path(s).exists():
            raise FileNotFoundError(f"Source video not found: {s}")
    from ..multiclip import MultiClipProcessor

    mp = MultiClipProcessor(sources, config=_config(args),
                            mode=ProcessingMode(args.mode),
                            team_names=_team_names(args),
                            checkpoint=args.checkpoint, device=args.device)
    targets = None
    if args.target_path:
        base = Path(args.target_path)
        targets = [str(base.with_name(f"{base.stem}_{i}{base.suffix}"))
                   for i in range(len(sources))]
    counts = mp.run(targets, limit_frames=args.limit_frames)
    print(f"Processed {counts} frames across {len(sources)} clips.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
