#!/usr/bin/env python3
"""Where the time of the port's detect step goes, on one GPU.

    python3 scripts/torch_detect_profile.py [--track | --teams | --puck | --rink] [--out F]

Runs `Detector.fetch_batch` (the shipped YOLOv8x player detector, bf16)
on seeded synthetic 1080p frames (736x1280 network input; the frames of
chip_smoke.py), 8 frames per batch, under torch.profiler for 10 batches
after 3 warm-up batches, and reports from that one trace:

- the device time of each stage of the step per batch, from the step's
  own `record_function` ranges (upload, letterbox, forward, decode,
  nms_candidates, nms_select_unmap, pack: the step's result laid out
  for its one copy to the host, `Detector.fetch_batch`), and for
  nms_suppress from the suppression kernel's own events by name: the
  trace does not link a kernel launched through the kernel's ctypes
  library to the range it was launched in;
- the device busy share: the device time of all kernels and copies over
  the wall time of the profiled loop;
- the host-to-device copies per batch (the frames are one; the step's
  constants are built on the device once, at warm-up);
- the CUDA kernels with the most device time.

With `--track` it profiles the fused detect + track step instead,
`Detector.detect_track_batch` with the track state carried from batch to
batch (T = 128, D = 64), over 104 frames of the same scene, and adds:

- the device ms of the `tracker_scan` range, and the host ms
  of the `tracker_scan` range (its first host sync waits for the detect
  work queued before it, so this range holds some of the detector's
  device time as well);
- the tracker alone: `tracker_scan` replayed on the card over the
  profiled batches' own detections, from init_state, in 4 turns, timed
  by the host clock around a synchronize and by CUDA events, with the
  auction's rounds per batch; and its host time's share of the fused
  step's wall time;
- the CUDA kernel launches per batch inside the `tracker_scan` range and
  the auction's host syncs per batch;
- the host ByteTrack (tracking/bytetrack.py, scipy's Hungarian) over the
  same batches' detections as the host path would give it (classes
  player and goalkeeper, score above detection_confidence), its
  `update` calls timed by the host clock: the cost of the host path's
  tracker beside the fused one (not the same semantics: the host path
  starves ByteTrack's low-score stage).

With `--teams` it profiles the fused step of TEAM_CLASSIFICATION, the
same as `--track` with the detector's team branch on (`Detector(...,
with_team_features=True)`, packed (8, 64, 11)), and adds the device ms,
host ms and CUDA kernel launches per batch of the `team_features` range,
and the branch alone (`team_features` on the last profiled batch's frames
and boxes, 10 calls under the profiler): the device ms of its kernels per
call, its kernels per call and those with the most device time.

With `--puck` it profiles PUCK_DETECTION's step instead,
`SlicedDetector.detect_frames` (the shipped YOLOv8s puck model, bf16, 8
tiles of 640 per 1080p frame, so 64 tiles per batch of 8) on
chip_smoke.py's frames with the drawn puck: the ranges upload, slice
(the tiles cut on the device), letterbox, forward, decode,
nms_candidates, nms_select_unmap, merge (the cross-tile merge) and pack, and
the suppression kernel's device time at each of its two call sites per
batch (its launches in time order alternate per-tile NMS, merge), with
the busy share, copies and top kernels as above.

With `--rink` it profiles the dual step of the rink path instead,
`DualDetector.fetch_batch` as TEAM_CLASSIFICATION with the 2D map runs
it (the player branch with the team branch, then the YOLOv8s-pose rink
model on the 512 square, packed into one (8, 64 + 16, 11) copy to the
host), on
chip_smoke.py's frames with the rink drawn under the players: the detect
ranges, team_features, rink_letterbox, rink_forward, rink_decode and pack,
the suppression kernel by name (one launch per batch), with the busy
share, copies and top kernels as above.

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

from chip_smoke import (  # noqa: E402
    BATCH,
    FRAME_HW,
    KERNEL_NAME,
    launches_in,
    puck_scene,
    replay_on_card,
    rink_scene,
    synthetic_frames,
)
from hockey_tpu_torch.core.config import Config  # noqa: E402
from hockey_tpu_torch.models.detector import (  # noqa: E402
    Detector,
    team_features,
    tracker_inputs,
)
from hockey_tpu_torch.models.dual import DualDetector  # noqa: E402
from hockey_tpu_torch.ops import assignment  # noqa: E402
from hockey_tpu_torch.tracking.scan_kernel import scan  # noqa: E402
from hockey_tpu_torch.slicing.sahi import SlicedDetector  # noqa: E402
from hockey_tpu_torch.tracking.bytetrack import ByteTrack  # noqa: E402
from hockey_tpu_torch.tracking.device_tracker import init_state  # noqa: E402

ITERS = 10
WARMUP = 3
STAGES = ("upload", "letterbox", "forward", "decode", "nms_candidates",
          "nms_suppress", "nms_select_unmap", "pack")
TRACK_STAGES = STAGES + ("tracker_scan",)
TEAM_STAGES = STAGES + ("team_features", "tracker_scan")
PUCK_STAGES = ("upload", "slice", "letterbox", "forward", "decode",
               "nms_candidates", "nms_suppress", "nms_select_unmap", "merge",
               "pack")
RINK_STAGES = STAGES + ("team_features", "rink_letterbox", "rink_forward",
                        "rink_decode")
ALONE_TURNS = 4


def tracker_alone(inputs, kwargs, capacity):
    """{host_ms, event_ms, syncs, rounds}: per batch, one value per turn
    (the mean over the batches) of tracker_scan replayed over `inputs`."""
    out = {"host_ms": [], "event_ms": [], "syncs": [], "rounds": []}
    st = assignment.stats
    for _ in range(ALONE_TURNS):
        st.syncs = 0
        scan.reset()
        _, ev, host = replay_on_card(inputs, kwargs, capacity)
        out["host_ms"].append(sum(host) / len(inputs))
        out["event_ms"].append(sum(ev) / len(inputs))
        out["syncs"].append(st.syncs / len(inputs))
        out["rounds"].append(scan.counts()["rounds"] / len(inputs))
    return {m: [round(x, 4) for x in v] for m, v in out.items()}


def team_alone(frames, boxes, calls: int = 10):
    """{the device ms of its kernels per call, kernels per call, the top
    kernels' device ms and count per call} of the team branch alone, with
    the step's memoised matrices."""
    x = torch.as_tensor(frames).to("cuda")
    with torch.inference_mode():
        team_features(x, boxes)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                team_features(x, boxes)
            torch.cuda.synchronize()
    kernels = sorted(((e.key[:100], e.self_device_time_total / 1e3 / calls,
                       e.count / calls) for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA
                      and e.self_device_time_total > 0), key=lambda k: -k[1])
    return {"kernel_ms_per_call": round(sum(k[1] for k in kernels), 4),
            "kernels_per_call": sum(k[2] for k in kernels),
            "top_kernels_ms_per_call": [[k, round(t, 4), n]
                                        for k, t, n in kernels[:12]]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="also write the JSON here")
    ap.add_argument("--track", action="store_true",
                    help="profile the fused detect + track step")
    ap.add_argument("--teams", action="store_true",
                    help="profile the fused detect + track step with the "
                         "team branch (TEAM_CLASSIFICATION)")
    ap.add_argument("--puck", action="store_true",
                    help="profile the sliced puck step (PUCK_DETECTION)")
    ap.add_argument("--rink", action="store_true",
                    help="profile the dual step (player, team and rink "
                         "branches; the 2D map's device side)")
    args = ap.parse_args()
    track = args.track or args.teams
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(card, flush=True)

    cfg = Config()
    stages = (PUCK_STAGES if args.puck else RINK_STAGES if args.rink
              else TEAM_STAGES if args.teams else TRACK_STAGES if track
              else STAGES)
    if args.rink:
        det = DualDetector(cfg, FRAME_HW, device="cuda", dtype=torch.bfloat16,
                           with_team_features=True)
        frames = rink_scene(seed=0, n=BATCH)

        def step(b):
            det.fetch_batch(frames)  # the one copy to the host
    elif args.puck:
        det = SlicedDetector(cfg, FRAME_HW, device="cuda", dtype=torch.bfloat16)
        frames = puck_scene(seed=0, n=BATCH)

        def step(b):
            det.detect_frames(frames)  # ends in the one copy to the host
    else:
        det = Detector(cfg.player_model_name, cfg, frame_hw=FRAME_HW,
                       device="cuda", dtype=torch.bfloat16,
                       with_team_features=args.teams)
    if track:
        frames = synthetic_frames(seed=0, n=BATCH * (WARMUP + ITERS))
        batches = [frames[BATCH * i:BATCH * (i + 1)]
                   for i in range(WARMUP + ITERS)]
        state = [init_state(cfg.max_tracks, "cuda")]
        outs = []

        def step(b):
            out = det.detect_track_batch(batches[b], state[0])
            state[0] = out[-1]
            outs.append(out)
            out[3].cpu()  # the one copy to the host per batch
    elif not (args.puck or args.rink):
        frames = synthetic_frames(seed=0, n=BATCH)

        def step(b):
            det.fetch_batch(frames)  # the one copy to the host
    for b in range(WARMUP):  # warm-up: cuDNN algorithm choice, kernel build
        step(b)
    torch.cuda.synchronize()
    st = assignment.stats
    st.syncs = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        for b in range(WARMUP, WARMUP + ITERS):
            step(b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t)
    syncs = st.syncs

    events = prof.key_averages()
    # a host-side range reports the device time of the work launched in it
    stage_ms = {e.key: e.device_time_total / 1e3 / ITERS for e in events
                if e.key in stages and e.device_type == DeviceType.CPU}
    host_ms = {e.key: e.cpu_time_total / 1e3 / ITERS for e in events
               if e.key in stages and e.device_type == DeviceType.CPU}
    # device-side events only (kernels, copies), without the ranges' own
    # device-side spans: host-side ops report their kernels' time again
    kernels = [(e.key[:120], e.self_device_time_total / 1e3, e.count)
               for e in events
               if e.device_type == DeviceType.CUDA and e.key not in stages
               and e.self_device_time_total > 0]
    kernels.sort(key=lambda k: -k[1])
    busy_ms = sum(k[1] for k in kernels)
    stage_ms["nms_suppress"] = sum(ms for k, ms, _ in kernels
                                   if KERNEL_NAME in k) / ITERS
    h2d = [e for e in prof.events() if e.device_type == DeviceType.CUDA
           and "Memcpy HtoD" in e.name]
    core = det.detector.core if args.puck else det.core
    result = {
        "card": card,
        "device": torch.cuda.get_device_name(0),
        "batch": BATCH,
        "input_hw": list(core.in_hw),
        "stage_device_ms_per_batch": {k: round(stage_ms.get(k, 0.0), 4)
                                      for k in stages},
        "device_ms_per_batch": round(busy_ms / ITERS, 4),
        "wall_ms_per_batch": round(wall_ms / ITERS, 4),
        "frames_per_s": round(1e3 * BATCH * ITERS / wall_ms, 3),
        "device_busy_share": round(busy_ms / wall_ms, 4),
        "h2d_copies_per_batch": len(h2d) / ITERS,
        "top_kernels_ms": [[k, round(ms, 3), n] for k, ms, n in kernels[:15]],
    }
    if args.puck:
        # the kernel's launches in time order: per-tile NMS, merge, ...
        launches = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                          for e in prof.events()
                          if e.device_type == DeviceType.CUDA
                          and KERNEL_NAME in e.name)
        result.update({
            "tiles_per_batch": BATCH * len(det.grid),
            "kernel_launches_per_batch": len(launches) / ITERS,
            "nms_suppress_tile_site_ms_per_batch": round(
                sum(d for _, d in launches[0::2]) / 1e3 / ITERS, 6),
            "nms_suppress_merge_site_ms_per_batch": round(
                sum(d for _, d in launches[1::2]) / 1e3 / ITERS, 6),
        })
    if args.teams:
        result.update({
            "team_features_host_ms_per_batch": round(host_ms["team_features"], 4),
            "team_features_launches_per_batch": launches_in(
                prof, "team_features") / ITERS,
            "team_features_alone": team_alone(
                batches[-1], outs[-1][0].boxes),
        })
    if track:
        kwargs = det.tracker_kwargs()
        inputs = [tracker_inputs(o[0]) for o in outs[WARMUP:]]
        alone = tracker_alone(inputs, kwargs, cfg.max_tracks)
        host_tracker = ByteTrack.from_config(cfg)
        host_ms_bt = []
        for boxes, scores, classes, valid in inputs:
            keep = (valid & (scores > cfg.detection_confidence)).cpu().numpy()
            frames_np = [(b[k], s[k], c[k]) for b, s, c, k in zip(
                boxes.cpu().numpy(), scores.cpu().numpy(),
                classes.cpu().numpy(), keep)]
            t = time.perf_counter()
            for fr in frames_np:
                host_tracker.update(*fr)
            host_ms_bt.append(1e3 * (time.perf_counter() - t))
        alone_ms = alone["host_ms"]
        result.update({
            "tracker_scan_range_host_ms_per_batch": round(
                host_ms["tracker_scan"], 4),
            "tracker_alone_per_batch": alone,
            "tracker_alone_share_of_wall": round(
                sum(alone_ms) / len(alone_ms) / (wall_ms / ITERS), 4),
            "tracker_launches_per_batch": launches_in(prof, "tracker_scan") / ITERS,
            "host_syncs_per_batch": syncs / ITERS,
            "detections_per_frame": [int(v) for o in outs[WARMUP:]
                                     for v in tracker_inputs(o[0])[3].sum(1)],
            "host_bytetrack_ms_per_batch": [round(x, 3) for x in host_ms_bt],
        })
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
