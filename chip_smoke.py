#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (hockey_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, each announced on its own line with the elapsed seconds:

1. card: name and power limit from nvidia-smi;
2. build: nvcc builds the NMS suppression kernel from
   hockey_tpu_torch/csrc/nms_suppress.cu;
3. kernel: the kernel against its plain PyTorch version on the card,
   bit for bit, on the seeded cases of `kernel_cases` (IoU and containment
   matrices at B=8, K=256, ties, all-invalid, K=100, the bitmask's
   edges: K=1, K=33, K=1024, B=1, all overlapping, NaN entries, and the
   puck path's shapes: B=64 K=256, B=8 K=64, B=8 K=32); on the
   dense containment case, the kernel's device time per launch (from a
   torch.profiler trace), the wrapper's call time (CUDA events over
   back-to-back calls), the plain version's time and the bound;
4. main path: the shipped YOLOv8x player model in bf16 on 1080p frames
   (736x1280 network input) through VideoProcessor.detect_frames, three
   batches of 8 seeded synthetic frames; the kernel's launch count over
   that run must be at least 3; the last batch goes again through the
   detect step's two halves (`candidates`, `finish`), where the kernel's
   and the plain suppression's kept sets on those candidates must be
   equal and the kernel's half must give the main path's detections; two
   frames are held against an f32 CPU run of the same detector; the
   kernel's device time per launch, call time, plain time and bound on
   the main path's own candidates;
5. PLAYER_TRACKING: the same detector through
   VideoProcessor(mode=PLAYER_TRACKING).track_frames, the fused detect +
   track step (T = 128 tracks, D = 64 detections), three batches of 8; the
   tracker must be the fused one (no host ByteTrack), the kernel must
   launch at least 3 times, the last batch goes again through the
   tracking core's two halves (NMS floored at 0.1), where the kernel's and
   the plain suppression's kept sets must be equal and the kernel's half
   must give the run's detections, the card's track ids must equal a replay of
   `tracker_scan` on the CPU over the same padded detections copied from
   the card, and every frame's ids must be positive and distinct; it
   prints frames/s, the tracker's ms per batch (CUDA events and host
   clock, from a replay of `tracker_scan` on the card over the run's own
   detections), host syncs per batch (counted in `auction_match`), CUDA
   kernel launches per batch in the tracker (torch.profiler), the count
   of distinct ids and id switches against the generator's own players;
   the jersey-number reader (the digit net on the card) must have read
   crops, whose card logits must match the same net on the CPU in f32
   within 1e-3 with equal argmax; it prints the reads and the reader's
   host ms per batch; and these numbers as one JSON line;
6. TEAM_CLASSIFICATION, the reference's main path: a VideoProcessor in
   that mode builds its own detector with the team branch; `fit_teams`
   fits the team classifier on every 10th of the same 24 frames, then
   `classify_frames` runs the fused step (detect, NMS kernel,
   `tracker_scan`, team features; one packed (8, 64, 11) copy per batch)
   over 3 batches of 8. The tracker must be the fused one and `packed` 11
   wide; the kernel must launch at least 3 times and, on the last batch,
   keep the plain suppression's set; the card's ids must equal a CPU
   replay of `tracker_scan`; the last batch's team features from the card
   must match the plain team branch recomputed on the CPU in f32 from the
   same frames and the card's own boxes (dominant_hue equal, white_ratio
   within 0.01, saturation and brightness within 0.05), with equal team
   ids from the fitted classifier on every valid row; the team accuracy
   against the generator's teams (majority mapping, as
   scripts/e2e_quality.py) must be at least 0.95 with the teams
   separable. It prints frames/s of `classify_frames` after the first
   batch, the `team_features` range's device ms and launches per batch
   (torch.profiler), the fit's seconds and crop count and the accuracy,
   as one JSON line;
7. PUCK_DETECTION: a VideoProcessor in that mode builds the sliced
   YOLOv8s (bf16, 8 tiles of 640 per 1080p frame); `puck_frames` runs
   3 batches of 8 frames of the same scene with a puck drawn on a
   straight pass. The kernel must launch exactly twice per batch (per-tile
   NMS at B = 64, K = 256; the merge at B = 8, K = 64); on the last batch
   both call sites must keep the plain suppression's set and give the
   run's boxes; the kernel's device, call, plain and bound times at both
   sites; the per-tile top-256 candidate scores of the last batch from the
   card must be within 0.05 of an f32 CPU run, which must find the puck; the
   tracker's centre must lie within 16 px of the drawn puck on at least
   3/4 of the frames after its 2-frame acquisition. It prints frames/s,
   ms per batch and these numbers as one JSON line;
8. rink + 2D map: a VideoProcessor in TEAM_CLASSIFICATION with
   `show_2d_map=True` builds the dual step (models/dual.py: YOLOv8x bf16
   at 736x1280 with the team branch, then the shipped YOLOv8s-pose bf16 on
   the 512 square, 56 keypoints) and, having no fused tracker, the host
   ByteTrack; `fit_teams`, then `classify_frames` over 3 batches of 8
   frames of a rink drawn in numpy through a known homography
   (`rink_homography`: boards, red, blue and goal lines, faceoff circles
   and spots) under the same players. The kernel must launch exactly once
   per batch, and on the last batch keep the plain suppression's set and
   give the run's detections; the card's keypoints on 2 frames are held
   against the same rink branch in f32 on the CPU (the nearest of the
   CPU's near-tied best anchors; tolerances at KPT_MAX_PX and below), and
   fresh calibrators fed either side's keypoints must place the frame's
   players within H_MEAN_FT / H_MAX_FT of each other; the CPU must read
   the scene (SCENE_KPTS keypoints, a homography within SCENE_H_FT of the
   known one); `RinkKeypointDetector.detect_keypoints_batch` runs once on
   the same frames, its one NMS launch held to the plain version. It
   prints frames/s, the host ms per frame of the stages (keypoints,
   rink2d among them), the rink ranges' device ms and launches per batch
   (torch.profiler), and the kernel's device, call, plain and bound times
   at both call sites, as one JSON line;
9. the kernel table as one JSON line, then the result line.

Any failure raises and exits non-zero. Without CUDA, or without the
hockey_tpu_torch package beside it, it exits non-zero and prints no result.
"""

import json
import os
import subprocess
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from hockey_tpu_torch.core.config import Config, ProcessingMode  # noqa: E402
from hockey_tpu_torch.homography.ransac import dlt_homography, project  # noqa: E402
from hockey_tpu_torch.homography.calibrator import CalibratorState  # noqa: E402
from hockey_tpu_torch.homography.keypoints import (  # noqa: E402
    RinkKeypointDetector,
    keypoints_from_array,
)
from hockey_tpu_torch.homography.stabilizer import homography_distance  # noqa: E402
from hockey_tpu_torch.models.checkpoint import load_params, shipped_weights_path  # noqa: E402
from hockey_tpu_torch.models.detector import (  # noqa: E402
    Detector,
    HostDetections,
    best_keypoints,
    team_features,
    tracker_inputs,
)
from hockey_tpu_torch.models.dual import DualDetector  # noqa: E402
from hockey_tpu_torch.models.layers import fuse_for_inference  # noqa: E402
from hockey_tpu_torch.models.yolov8 import (  # noqa: E402
    build_model,
    decode_boxes,
    decode_keypoints,
    forward_raw,
)
from hockey_tpu_torch.ops.letterbox import letterbox_batch  # noqa: E402
from hockey_tpu_torch.ocr.digits import DigitNet, load_default_params  # noqa: E402
from hockey_tpu_torch.ops.iou import box_iou  # noqa: E402
from hockey_tpu_torch.ops.nms import nms_select, suppression_matrix  # noqa: E402
from hockey_tpu_torch.ops.nms_kernel import (  # noqa: E402
    build_library,
    suppress,
    suppress_reference,
)
from hockey_tpu_torch.ops import assignment  # noqa: E402
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402
from hockey_tpu_torch.rinkmap.dimensions import NHL  # noqa: E402
from hockey_tpu_torch.rinkmap.renderer import bottom_center_anchors  # noqa: E402
from hockey_tpu_torch.slicing.sahi import MERGE_MAX_DET, SlicedDetector  # noqa: E402
from hockey_tpu_torch.tracking.bytetrack import ByteTrack  # noqa: E402
from hockey_tpu_torch.tracking.device_tracker import (  # noqa: E402
    DeviceByteTrack,
    init_state,
    tracker_scan,
)

FRAME_HW = (1080, 1920)
BATCH = 8
N_BATCHES = 3
# the generator's team of player j is j % 2 (synthetic_frames' `teams`)
N_TEAMS = 2
# H100 SXM peaks (NVIDIA data sheet) for the bound of the suppression
# kernel: it moves f32 matrix rows and does f32 comparisons
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNEL_NAME = "nms_suppress_kernel"  # the CUDA kernel's name in a trace
# phase 8's tolerances, bf16 on the card against f32 on the CPU, in 1080p
# frame px (the rink model sees the frame at 512 / 1920 of its size, so
# 24 px is 6.4 px at its input): keypoints confident (>= 0.3) on both
# sides within KPT_MAX_PX, their median within KPT_MEDIAN_PX, confidences
# within KPT_CONF; the calibrator's homographies from either side's
# keypoints project the frame's players within H_MEAN_FT on average and
# H_MAX_FT at most. The CPU's reading of the scene: >= SCENE_KPTS
# keypoints at >= 0.3 and its homography within SCENE_H_FT (mean
# displacement over the frame's probe grid) of the known one: the shipped
# pose model, trained on square frames, reads 16:9 1080p frames coarsely
KPT_MAX_PX, KPT_MEDIAN_PX, KPT_CONF = 24.0, 6.0, 0.05
H_MEAN_FT, H_MAX_FT = 1.5, 3.0
SCENE_KPTS, SCENE_H_FT = 8, 25.0
# the CPU anchors a card keypoint set may stand for: the 5 best, within
# this score of the best (bf16 can swap near-tied anchors)
NEAR_TIE = 0.01


def phase(name: str) -> None:
    print(f"== [{time.perf_counter() - T0:7.1f} s] {name}", flush=True)


def time_ms(fn, iters: int) -> float:
    """Time per call of fn() over `iters` back-to-back calls, by CUDA
    events. Where a call takes the host longer than the device, this is
    the call rate, not the device time."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, launches: int = 50, kernel: str = KERNEL_NAME):
    """(device ms per launch, how) of the CUDA kernel whose name holds
    `kernel`, over `launches` calls of fn: the mean of the kernel's own
    durations in a torch.profiler trace ("profiler"; the trace may miss a
    launch at the edge of its window), or, where the trace holds none of
    them, `queued_ms` ("events")."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(launches):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key]
    count = sum(e.count for e in hits)
    if not count:
        return queued_ms(fn, launches), "events"
    if count > launches:
        raise AssertionError(f"{count} {kernel} launches traced, {launches} made")
    return sum(e.self_device_time_total for e in hits) / 1e3 / count, "profiler"


def queued_ms(fn, launches: int = 50) -> float:
    """Device ms per call of fn() by CUDA events around `launches` calls
    that the host queues while the device sleeps, so that they run back to
    back and the host's call rate does not set the pace."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)  # about 50 ms of device clock cycles
    start.record()
    for _ in range(launches):
        fn()
    end.record()
    if start.query():
        raise AssertionError("the device woke before the host had queued "
                             "the launches")
    torch.cuda.synchronize()
    return start.elapsed_time(end) / launches


def suppress_bound(keep: torch.Tensor):
    """(bound ms, bytes, operations) of suppression with kept set `keep`
    (B, K): each kept candidate's row tail M[i, i+1:] read and compared,
    keep0 read and keep written once."""
    b, k = keep.shape
    tail = k - 1 - torch.arange(k, device=keep.device)
    elems = int((keep * tail).sum())
    nbytes = 4 * elems + 2 * b * k
    return (1e3 * max(nbytes / HBM_BYTES_PER_S, elems / F32_OPS_PER_S),
            nbytes, elems)


def time_kernel(label, m, keep0, thr):
    """Kernel device ms, call ms, plain ms and bound on one input, printed
    on one line and returned under the kernel table's keys."""
    ms, how = device_ms(lambda: suppress(m, keep0, thr))
    call_ms = time_ms(lambda: suppress(m, keep0, thr), 200)
    plain_ms = time_ms(lambda: suppress_reference(m, keep0, thr), 10)
    bound_ms, nbytes, elems = suppress_bound(suppress_reference(m, keep0, thr))
    print(f"{label}: kernel device {ms:.6f} ms per launch ({how}), call "
          f"{call_ms:.4f} ms (CUDA events, 200 back-to-back calls), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({nbytes} bytes); "
          f"library call: none (no single PyTorch op computes greedy "
          f"suppression)", flush=True)
    return dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="bytes" if nbytes / HBM_BYTES_PER_S
                >= elems / F32_OPS_PER_S else "operations")


# --------------------------------------------------------------------------
# synthetic 1080p frames: ellipse-figure players on a rink, numpy only

def _ellipse(img, cx, cy, ax, ay, color):
    h, w = img.shape[:2]
    x0, x1 = max(int(cx - ax), 0), min(int(cx + ax) + 1, w)
    y0, y1 = max(int(cy - ay), 0), min(int(cy + ay) + 1, h)
    if x0 >= x1 or y0 >= y1:
        return
    yy, xx = np.ogrid[y0:y1, x0:x1]
    img[y0:y1, x0:x1][((xx - cx) / ax) ** 2 + ((yy - cy) / ay) ** 2 <= 1.0] = color


def _player(img, fx, fy, hpx, jersey, pants):
    bw = 0.42 * hpx
    for s in (-1, 1):
        _ellipse(img, fx + s * 0.2 * bw, fy - 0.16 * hpx, 0.14 * bw, 0.17 * hpx, (38, 38, 42))
        _ellipse(img, fx + s * 0.2 * bw, fy - 0.03 * hpx, 0.22 * bw, 0.03 * hpx, (24, 24, 28))
    _ellipse(img, fx, fy - 0.50 * hpx, 0.55 * bw, 0.11 * hpx, pants)
    _ellipse(img, fx, fy - 0.66 * hpx, 0.5 * bw, 0.2 * hpx, jersey)
    for s in (-1, 1):
        _ellipse(img, fx + s * 0.55 * bw, fy - 0.62 * hpx, 0.13 * bw, 0.16 * hpx, jersey)
    _ellipse(img, fx, fy - 0.9 * hpx, 0.2 * bw, 0.08 * hpx, (150, 150, 150))


def _skaters(rng, players: int):
    """(foot (P, 2), velocity (P, 2) px per frame, height (P,)) of the
    synthetic players, drawn from `rng`."""
    h, w = FRAME_HW
    foot = rng.uniform([150, 0.4 * h], [w - 150, h - 40], (players, 2))
    vel = rng.uniform(-10, 10, (players, 2))
    size = rng.uniform(150, 230, players)
    return foot, vel, size


def synthetic_players(seed: int, n: int, players: int = 10):
    """The generator's own players in each of the n frames of
    `synthetic_frames(seed, n, players)`: (centres (n, P, 2), heights
    (n, P)) of each drawn figure in pixels."""
    foot, vel, size = _skaters(np.random.default_rng(seed), players)
    t = np.arange(n)[:, None, None]
    f = foot[None] + vel[None] * t                      # (n, P, 2)
    hpx = size[None] * (0.6 + 0.4 * f[..., 1] / FRAME_HW[0])
    centre = np.stack([f[..., 0], f[..., 1] - 0.49 * hpx], -1)
    return centre, hpx


def synthetic_frames(seed: int, n: int, players: int = 10,
                     base: np.ndarray = None) -> np.ndarray:
    """(n, 1080, 1920, 3) uint8 BGR: skating players over `base`, by
    default a white rink with vertical lines and a dark band on top."""
    rng = np.random.default_rng(seed)
    h, w = FRAME_HW
    if base is None:
        base = np.full((h, w, 3), 228, np.uint8)
        base[..., 0] = 236
        base[:, w // 2 - 6:w // 2 + 6] = (40, 40, 200)
        for x in (w // 3, 2 * w // 3):
            base[:, x - 8:x + 8] = (200, 90, 30)
        base[:int(0.18 * h)] = (60, 70, 80)
    teams = [((200, 160, 40), (40, 40, 40)), ((30, 30, 200), (230, 230, 230))]
    foot, vel, size = _skaters(rng, players)
    out = np.empty((n, h, w, 3), np.uint8)
    for t in range(n):
        f = base.copy()
        for j in np.argsort(foot[:, 1]):
            fx, fy = foot[j] + vel[j] * t
            _player(f, fx, fy, size[j] * (0.6 + 0.4 * fy / h), *teams[j % 2])
        out[t] = f
    return out


# image px of the rink points (10, 0), (190, 0), (10, 85) and (190, 85) ft
# in `rink_scene`: a camera above the near boards that sees 180 ft of the
# 200-ft sheet, the far boards high and narrower, the near ones below the
# frame (the JAX scene generator's camera family at span 0.9)
RINK_CORNERS_PX = ((230.0, 130.0), (1690.0, 130.0), (-192.0, 1134.0),
                   (2112.0, 1134.0))


def rink_homography() -> np.ndarray:
    """The known rink (ft) -> image (px) homography of `rink_scene`."""
    src = np.array([[10.0, 0.0], [190.0, 0.0], [10.0, 85.0], [190.0, 85.0]])
    return dlt_homography(src, np.array(RINK_CORNERS_PX))


def rink_base() -> np.ndarray:
    """(1080, 1920, 3) uint8 BGR: an NHL sheet seen through
    `rink_homography`, marked in numpy by the rink point under each pixel:
    ice, the boards' kickplate and pale boards (a rounded rectangle, 28-ft
    corners), the crowd beyond, the red centre line and blue lines (1 ft
    wide), the goal lines (4 in), the centre and end-zone faceoff circles
    (15 ft, 3-in rings) and the faceoff spots (1-ft radius)."""
    d = NHL
    h, w = FRAME_HW
    v, u = np.mgrid[0:h, 0:w]
    pts = project(np.linalg.inv(rink_homography()),
                  np.stack([u.ravel() + 0.5, v.ravel() + 0.5], 1))
    x, y = pts[:, 0].reshape(h, w), pts[:, 1].reshape(h, w)
    r = d.corner_radius
    out = np.hypot(np.maximum(np.abs(x - d.center_x) - (d.center_x - r), 0),
                   np.maximum(np.abs(y - d.center_y) - (d.center_y - r), 0)) - r
    img = np.empty((h, w, 3), np.uint8)
    img[:] = (236, 228, 228)
    img[out > 0] = (180, 60, 40)                      # kickplate
    img[out > 0.5] = (230, 228, 224)                  # boards
    img[out > 3.5] = (60, 70, 80)                     # crowd
    red, blue = (60, 50, 190), (170, 90, 30)
    ice = out <= 0
    marks = [(np.abs(x - d.center_x) < 0.5, red)]
    for bx in (d.blue_line_from_end, d.length - d.blue_line_from_end):
        marks.append((np.abs(x - bx) < 0.5, blue))
    for gx in (d.goal_line_from_end, d.length - d.goal_line_from_end):
        marks.append((np.abs(x - gx) < 1 / 6, red))
    spot_x = (d.goal_line_from_end + d.endzone_spot_from_goal_line,
              d.length - d.goal_line_from_end - d.endzone_spot_from_goal_line)
    rows = (d.center_y - d.spot_offset_from_center_y,
            d.center_y + d.spot_offset_from_center_y)
    circles = [(d.center_x, d.center_y)] + [(cx, cy) for cx in spot_x
                                            for cy in rows]
    neutral = (d.blue_line_from_end + d.neutral_spot_from_blue,
               d.length - d.blue_line_from_end - d.neutral_spot_from_blue)
    for cx, cy in circles:
        marks.append((np.abs(np.hypot(x - cx, y - cy)
                             - d.faceoff_circle_radius) < 0.125, red))
    for cx, cy in circles[1:] + [(nx, ny) for nx in neutral for ny in rows]:
        marks.append((np.hypot(x - cx, y - cy) < 1.0, red))
    for mask, color in marks:
        img[mask & ice] = color
    return img


def rink_scene(seed: int, n: int) -> np.ndarray:
    """`synthetic_frames` with its players over `rink_base`."""
    return synthetic_frames(seed, n, base=rink_base())


def puck_path(n: int) -> np.ndarray:
    """(n, 2) centres of the drawn puck: a straight pass across the rink,
    22 px per frame to the right and 4 down, from (420, 560)."""
    return np.array([420.0, 560.0]) + np.arange(n)[:, None] * [22.0, 4.0]


def puck_scene(seed: int, n: int) -> np.ndarray:
    """`synthetic_frames` with a puck drawn over the players on
    `puck_path`: a dark ellipse (20, 18, 18), 11 x 7 px half-axes, the
    JAX scene generator's puck for a player about 115 px tall."""
    out = synthetic_frames(seed, n)
    for f, (x, y) in zip(out, puck_path(n)):
        _ellipse(f, x, y, 11, 7, (20, 18, 18))
    return out


# --------------------------------------------------------------------------

def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


# kernel_cases' inputs, in order
KERNEL_CASES = (
    "iou B=8 K=256", "containment B=8 K=256", "ties B=8 K=256",
    "all-invalid B=8 K=256", "iou B=8 K=100",
    # the bitmask's edges: one candidate, a word that is not full, 32 words
    # in dynamic shared memory, one frame, only candidate 0 surviving, and
    # NaN entries (NaN > thr is false)
    "iou B=8 K=1", "iou B=8 K=33", "iou B=8 K=1024", "iou B=1 K=256",
    "all-overlapping B=8 K=256", "NaN entries B=8 K=256",
    # the puck path's shapes: per-tile NMS over 8 tiles of 8 frames (64
    # clusters), and the cross-tile merge at K = min(64, T * 8) for T = 8
    # tiles (1080p) and T = 4 (960x960): one or two mask words
    "iou B=64 K=256", "iou B=8 K=64", "iou B=8 K=32")


def kernel_cases(dev):
    """[(name, matrix, keep0, thr)] for kernel-vs-plain on the card, one
    per name of KERNEL_CASES; the CPU tests hold the same cases to JAX."""
    rng = np.random.default_rng(0)

    def boxes(b, k):
        xy = rng.uniform(0, 1100, (b, k, 2))
        wh = rng.uniform(20, 200, (b, k, 2))
        cls = rng.integers(0, 2, (b, k, 1))
        bx = np.concatenate([xy, xy + wh], -1) + cls * 1e4
        return torch.tensor(bx, dtype=torch.float32, device=dev)

    def keep(b, k, p=0.9):
        return torch.tensor(rng.uniform(size=(b, k)) < p, device=dev)

    b8 = boxes(8, 256)
    cont, cont_thr = suppression_matrix(b8, 0.45, 0.5)
    dup = boxes(8, 128).repeat_interleave(2, dim=1)  # every box twice
    quant = torch.round(box_iou(dup, dup) * 4) / 4   # entries exactly at thr
    b100 = boxes(8, 100)
    inputs = [
        (box_iou(b8, b8), keep(8, 256), 0.45),
        (cont.contiguous(), keep(8, 256), cont_thr),
        (quant.contiguous(), keep(8, 256), 0.5),
        (box_iou(b8, b8), torch.zeros(8, 256, dtype=torch.bool, device=dev),
         0.45),
        (box_iou(b100, b100), keep(8, 100), 0.45),
    ]
    iou = {k: box_iou(x, x) for k, x in
           ((1, boxes(8, 1)), (33, boxes(8, 33)), (1024, boxes(8, 1024)))}
    b1 = boxes(1, 256)
    nan = box_iou(b8, b8).masked_fill(
        torch.tensor(rng.uniform(size=(8, 256, 256)) < 0.1, device=dev),
        float("nan"))
    inputs += [
        (iou[1], keep(8, 1), 0.45),
        (iou[33], keep(8, 33), 0.45),
        (iou[1024], keep(8, 1024), 0.45),
        (box_iou(b1, b1), keep(1, 256), 0.45),
        (torch.ones(8, 256, 256, device=dev),
         torch.ones(8, 256, dtype=torch.bool, device=dev), 0.45),
        (nan, keep(8, 256), 0.45),
    ]
    puck = {k: boxes(b, k) for b, k in ((64, 256), (8, 64), (8, 32))}
    inputs += [(box_iou(x, x), keep(*x.shape[:2]), thr) for x, thr in
               ((puck[256], 0.45), (puck[64], 0.5), (puck[32], 0.5))]
    return [(name, *x) for name, x in zip(KERNEL_CASES, inputs, strict=True)]


# --------------------------------------------------------------------------
# the tracker on the card

def matched_players(boxes, centre, hpx):
    """(generator player j, tracked box i) pairs of one frame: each is the
    other's nearest by centre and the centres lie within 0.3 of the
    player's height. boxes (n, 4); centre (P, 2) and hpx (P,) from
    `synthetic_players`."""
    if not len(boxes):
        return []
    c = (boxes[:, :2] + boxes[:, 2:]) / 2
    dist = np.linalg.norm(c[:, None] - centre[None], axis=-1)
    return [(j, i) for j, i in enumerate(dist.argmin(0))
            if dist[i].argmin() == j and dist[i, j] < 0.3 * hpx[j]]


def id_switches(rows, seed: int, players: int = 10):
    """(distinct ids, id switches) of tracked rows against the generator's
    players (`matched_players`); a switch is a player's matched id
    changing from one matched frame to the next."""
    centre, hpx = synthetic_players(seed, len(rows), players)
    last, switches, ids = {}, 0, set()
    for f, (boxes, _, _, tids) in enumerate(rows):
        ids.update(int(t) for t in tids)
        for j, i in matched_players(boxes, centre[f], hpx[f]):
            if j in last and last[j] != tids[i]:
                switches += 1
            last[j] = int(tids[i])
    return len(ids), switches


def team_accuracy(results, seed: int, players: int = 10):
    """(accuracy, separable, matched players) of the players' team ids in
    `results` (classify_frames' per-frame dicts) against the generator's
    teams, j % 2 for player j: players matched as in `matched_players`,
    each generator team mapped to the predicted team it most often got
    (scripts/e2e_quality.py's rule); separable when the mapping is
    one-to-one, and the accuracy is 0 when it is not."""
    centre, hpx = synthetic_players(seed, len(results), players)
    pairs = []
    for f, r in enumerate(results):
        keep = r["classes"] == 0
        teams = r["team_ids"][keep]
        pairs += [(j % N_TEAMS, int(teams[i])) for j, i in
                  matched_players(r["boxes"][keep], centre[f], hpx[f])]
    votes = {}
    for g, p in pairs:
        votes.setdefault(g, {}).setdefault(p, 0)
        votes[g][p] += 1
    mapping = {g: max(v, key=v.get) for g, v in votes.items()}
    separable = len(mapping) == N_TEAMS and len(set(mapping.values())) == N_TEAMS
    if not separable:
        return 0.0, False, len(pairs)
    return (sum(mapping[g] == p for g, p in pairs) / len(pairs), True,
            len(pairs))


def launches_in(prof, range_name: str) -> int:
    """CUDA kernel launches (runtime launch calls) inside the host ranges
    named `range_name` of a torch.profiler trace. Only the host-side spans
    count: the trace also holds each range's span on the device's
    timeline, later than the host's, over which the host launches the
    next stages' kernels."""
    events = prof.events()
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == range_name and e.device_type == DeviceType.CPU]
    return sum(1 for e in events if "LaunchKernel" in e.name and any(
        a <= e.time_range.start <= b for a, b in spans))


def replay_on_card(inputs, kwargs, capacity: int):
    """tracker_scan over the batches' padded detections on the card, from
    init_state: (det_track_ids per batch, CUDA-event ms per batch, host ms
    per batch)."""
    state = init_state(capacity, "cuda")
    tids, ev_ms, host_ms = [], [], []
    for x in inputs:
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        with torch.inference_mode():
            state, tid = tracker_scan(state, *x, **kwargs)
        end.record()
        torch.cuda.synchronize()
        host_ms.append(1e3 * (time.perf_counter() - t))
        ev_ms.append(start.elapsed_time(end))
        tids.append(tid)
    return tids, ev_ms, host_ms


def match_fraction(a, b, iou_min=0.8):
    """Fraction of the detections in `a` that have a same-class detection
    in `b` with IoU >= iou_min (HostDetections on the host)."""
    if len(a) == 0:
        return 1.0
    if len(b) == 0:
        return 0.0
    iou = box_iou(torch.from_numpy(a.boxes), torch.from_numpy(b.boxes)).numpy()
    same = a.classes[:, None] == b.classes[None, :]
    return float(((iou >= iou_min) & same).any(axis=1).mean())


def ocr_check(ocr, calls, timers):
    """The jersey-number reader of phase 5: its reads, its host ms per
    batch, and the digit net's card logits on every crop it read against
    the same net on the CPU in f32 (tolerance 1e-3: f32 on both sides,
    TF32 off; the argmax must be equal). Returns the numbers for the
    tracking JSON line."""
    if not calls:
        raise AssertionError("the reader read no crop")
    crops = torch.cat([c[0] for c in calls]).cpu()
    cpu_net = DigitNet.from_params(load_default_params())
    with torch.inference_mode():
        ref = cpu_net(crops)
    err = max(float((c.cpu() - r).abs().max()) for c, r in
              zip((torch.cat([c[1] for c in calls]),
                   torch.cat([c[2] for c in calls])), ref))
    same = all(torch.equal(torch.cat([c[i] for c in calls]).cpu().argmax(-1),
                           r.argmax(-1)) for i, r in ((1, ref[0]), (2, ref[1])))
    ocr_ms = 1e3 * timers.totals["ocr"] / N_BATCHES
    print(f"jersey OCR: {len(crops)} crops in {len(calls)} forwards, reads "
          f"{dict(sorted(ocr.numbers.items()))}, host {ocr_ms:.3f} ms per "
          f"batch; digit logits card vs CPU f32: max |diff| {err:.2e} "
          f"(tolerance 1e-3), argmax equal: {same}", flush=True)
    if err > 1e-3 or not same:
        raise AssertionError("card digit logits disagree with the CPU")
    return {"ocr_crops_read": len(crops), "ocr_forwards": len(calls),
            "ocr_reads": {str(k): v for k, v in sorted(ocr.numbers.items())},
            "ocr_host_ms_per_batch": round(ocr_ms, 3),
            "ocr_logit_max_abs_err": err}


def puck_phase(config, max_err):
    """Phase 7; returns (kernel launches over puck_frames, max_err)."""
    frames = puck_scene(seed=0, n=BATCH * N_BATCHES)
    t = time.perf_counter()
    vp = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                        mode=ProcessingMode.PUCK_DETECTION)
    sd = vp.puck_pipeline.sliced
    print(f"sliced YOLOv8s ready in {time.perf_counter() - t:.2f} s: "
          f"{len(sd.grid)} tiles of {sd.size} per frame {sd.grid}, "
          f"{sd.detector.dtype}", flush=True)
    if len(sd.grid) != 8 or sd.detector.dtype != torch.bfloat16:
        raise AssertionError("the puck path is not 8 bf16 tiles per frame")

    suppress.launches = 0
    results, marks = [], []
    t = time.perf_counter()
    for r in vp.puck_frames(iter(frames)):
        results.append(r)
        if len(results) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_p = suppress.launches
    fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
    batch_ms = [1e3 * (b - a) for a, b in zip([t] + marks[:-1], marks)]
    print(f"ms per batch of {BATCH}: {[round(x, 2) for x in batch_ms]}", flush=True)
    print(f"frames/s after the first batch: {fps:.2f}", flush=True)
    print(f"nms_suppress launches per batch: {launches_p / N_BATCHES} "
          f"(per-tile NMS and the merge)", flush=True)
    if len(results) != BATCH * N_BATCHES:
        raise AssertionError(f"{len(results)} frames out, {BATCH * N_BATCHES} in")
    if launches_p != 2 * N_BATCHES:
        raise AssertionError(f"kernel launched {launches_p} times, not "
                             f"{2 * N_BATCHES}")
    for r in results:
        if not (np.isfinite(r.boxes).all() and np.isfinite(r.scores).all()):
            raise AssertionError("non-finite puck detections")

    # the last batch again through both call sites: the kernel's kept set
    # against the plain suppression's, and the merged boxes of the run
    last = torch.as_tensor(frames[-BATCH:]).to("cuda")
    core = sd.detector.core
    with torch.inference_mode():
        cand = core.candidates(sd.detector.model, sd.tiles(last))
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
        mc = sd.merge_candidates(core.finish(cand, keep_k))
        mkeep_k = suppress(mc.matrix, mc.keep0, mc.thr)
        mkeep_r = suppress_reference(mc.matrix, mc.keep0, mc.thr)
        merged = nms_select(mc, mkeep_k, score_threshold=config.puck_confidence,
                            max_det=MERGE_MAX_DET)
    torch.cuda.synchronize()
    same = torch.equal(keep_k, keep_r) and torch.equal(mkeep_k, mkeep_r)
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()),
                  float((mkeep_k.int() - mkeep_r.int()).abs().max()))
    print(f"puck per-tile NMS B={tuple(cand.keep0.shape)}: kept "
          f"{int(keep_k.sum())} of {int(cand.keep0.sum())}; merge "
          f"B={tuple(mc.keep0.shape)}: kept {int(mkeep_k.sum())} of "
          f"{int(mc.keep0.sum())}; kernel kept sets == plain kept sets: {same}",
          flush=True)
    if not same:
        raise AssertionError("puck-path kept sets differ from the plain version")
    for i, r in enumerate(results[-BATCH:]):
        v = merged.valid[i].cpu()
        if not np.array_equal(merged.boxes[i][v].cpu().numpy(), r.boxes):
            raise AssertionError(f"the call sites differ from the run, frame {i}")
    sites = {"tile": time_kernel(
        f"puck per-tile NMS B={cand.keep0.shape[0]} K={cand.keep0.shape[1]}",
        cand.matrix, cand.keep0, cand.thr)}
    sites["merge"] = time_kernel(
        f"puck merge B={mc.keep0.shape[0]} K={mc.keep0.shape[1]}",
        mc.matrix, mc.keep0, mc.thr)

    # the per-tile top-256 candidate scores of the last batch: bf16 on the
    # card against an f32 CPU run (tolerance 0.05, a bf16 forward's sigmoid
    # scores); the CPU run must find the puck in some tile
    t = time.perf_counter()
    ref_sd = SlicedDetector(config, FRAME_HW, device="cpu",
                            dtype=torch.float32)
    with torch.inference_mode():
        ref = ref_sd.detector.core.candidates(
            ref_sd.detector.model, ref_sd.tiles(torch.from_numpy(frames[-BATCH:])))
    score_err = float((cand.scores.cpu() - ref.scores).abs().max())
    found = int((ref.scores[:, 0] > config.puck_confidence).sum())
    print(f"per-tile top-{ref.scores.shape[1]} scores, {ref.scores.shape[0]} "
          f"tiles, card bf16 vs CPU f32 ({time.perf_counter() - t:.1f} s): max "
          f"|diff| {score_err:.4f} (tolerance 0.05); tiles whose best CPU score "
          f"is above {config.puck_confidence}: {found}", flush=True)
    if score_err > 0.05 or not found:
        raise AssertionError("card puck scores disagree with the f32 CPU run")

    # the tracker's centres against the drawn puck
    path = puck_path(len(results))
    err = [None if r.center is None else
           round(float(np.linalg.norm(np.asarray(r.center) - p)), 2)
           for r, p in zip(results, path)]
    near = sum(e is not None and e <= 16.0 for e in err[2:])
    print(f"tracker centre - drawn puck (px) per frame: {err}", flush=True)
    print(f"within 16 px on {near} of {len(err) - 2} frames after the "
          f"tracker's 2-frame acquisition", flush=True)
    if near < 0.75 * (len(err) - 2):
        raise AssertionError("the puck tracker lost the drawn puck")
    puck = {
        "frames_per_s_after_first_batch": round(fps, 2),
        "ms_per_batch": [round(x, 2) for x in batch_ms],
        "kernel_launches_per_batch": launches_p / N_BATCHES,
        "tiles_per_frame": len(sd.grid),
        "tile_nms_shape": list(cand.keep0.shape),
        "merge_nms_shape": list(mc.keep0.shape),
        "kernel_at_tile_site": sites["tile"],
        "kernel_at_merge_site": sites["merge"],
        "tile_score_max_abs_err": round(score_err, 5),
        "centre_within_16px": near,
        "centre_err_px": err,
    }
    print(json.dumps({"puck": puck}), flush=True)
    return launches_p, max_err


def team_phase(config, frames, max_err, track_fps):
    """Phase 6; returns (kernel launches over classify_frames, max_err).
    `track_fps` is phase 5's frames/s, printed beside this path's."""
    t = time.perf_counter()
    vp = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                        mode=ProcessingMode.TEAM_CLASSIFICATION,
                        team_names=("TEAM_A", "TEAM_B"))
    det = vp.player_detector
    print(f"detector with the team branch ready in "
          f"{time.perf_counter() - t:.2f} s", flush=True)
    if not (vp.use_fused_tracker and isinstance(vp.tracker, DeviceByteTrack)
            and det.with_team_features):
        raise AssertionError("TEAM_CLASSIFICATION on CUDA did not take the "
                             "fused device step with team features")
    suppress.launches = 0
    t = time.perf_counter()
    crops = vp.fit_teams(iter(frames))
    fit_s = time.perf_counter() - t
    launches_fit = suppress.launches
    clf = vp.team_classifier._impl
    if vp.team_classifier.active_strategy != "segmentation" or clf.kmeans is None:
        raise AssertionError("the segmentation classifier was not fitted")
    print(f"fit_teams: {crops} crops in {fit_s:.3f} s ({launches_fit} kernel "
          f"launches); centres {np.round(clf.kmeans.cluster_centers_, 3).tolist()}",
          flush=True)

    suppress.launches = 0
    results, outs, marks = [], [], []
    t = time.perf_counter()
    for r in vp.classify_frames(iter(frames)):
        results.append(r)
        if len(results) % BATCH == 1:  # the batch's step has just run
            outs.append(vp.last_track_batch)
        if len(results) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_c = suppress.launches
    fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
    batch_ms = [1e3 * (b - a) for a, b in zip([t] + marks[:-1], marks)]
    print(f"ms per batch of {BATCH}: {[round(x, 2) for x in batch_ms]}", flush=True)
    print(f"frames/s after the first batch: {fps:.2f}", flush=True)
    print(f"nms_suppress launches over classify_frames: {launches_c}", flush=True)
    print(f"players per frame: {[int((r['classes'] == 0).sum()) for r in results]}",
          flush=True)
    if len(results) != BATCH * N_BATCHES or len(outs) != N_BATCHES:
        raise AssertionError(f"{len(results)} frames out, {BATCH * N_BATCHES} in")
    if launches_c < N_BATCHES:
        raise AssertionError(f"kernel launched {launches_c} times, < {N_BATCHES}")
    if any(o[3].shape != (BATCH, det.max_det, 11) for o in outs):
        raise AssertionError("packed is not (B, D, 11)")

    # the kernel on this path's last batch against the plain suppression
    last = torch.as_tensor(frames[-BATCH:]).to("cuda")
    core = det._track_step.core
    with torch.inference_mode():
        cand = core.candidates(det.model, last)
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
        again = core.finish(cand, keep_k)
    torch.cuda.synchronize()
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()))
    if not torch.equal(keep_k, keep_r):
        raise AssertionError("team-path kept sets differ from the plain version")
    if not all(torch.equal(getattr(again, f), getattr(outs[-1][0], f))
               for f in ("boxes", "scores", "classes", "valid")):
        raise AssertionError("the team core's halves differ from the run's "
                             "last batch")
    print(f"team-path NMS (conf {core.conf}), last batch: kernel kept set == "
          f"plain kept set: True", flush=True)

    # the card's ids against tracker_scan replayed on the CPU
    kwargs = det.tracker_kwargs()
    state = init_state(config.max_tracks, "cpu")
    for b, o in enumerate(outs):
        state, cpu_tids = tracker_scan(
            state, *(v.cpu() for v in tracker_inputs(o[0])), **kwargs)
        if not torch.equal(cpu_tids, o[2].cpu()):
            raise AssertionError(f"batch {b}: card track ids differ from the "
                                 "CPU replay")
    print("card track ids == tracker_scan replayed on the CPU: True", flush=True)

    # the last batch's team features: card against the plain branch on the
    # CPU in f32, from the same frames and the card's own boxes
    card = outs[-1][3][..., 7:].cpu().numpy()
    valid = outs[-1][0].valid.cpu().numpy()
    t = time.perf_counter()
    with torch.inference_mode():
        ref = team_features(torch.from_numpy(frames[-BATCH:]),
                            outs[-1][0].boxes.cpu()).numpy()
    ref_s = time.perf_counter() - t
    err = np.abs(card - ref)
    hue_equal = bool((card[..., 1] == ref[..., 1]).all())
    tol = np.array([0.01, 0.0, 0.05, 0.05])
    ids_card = clf.kmeans.predict(card[valid])
    ids_ref = clf.kmeans.predict(ref[valid])
    print(f"team features, last batch ({int(valid.sum())} valid of "
          f"{valid.size} slots; CPU f32 in {ref_s:.1f} s): max |card - CPU| "
          f"per column {np.round(err.max(axis=(0, 1)), 6).tolist()} (tolerance "
          f"{tol.tolist()}), dominant_hue equal: {hue_equal}; team ids equal "
          f"on every valid row: {bool((ids_card == ids_ref).all())}", flush=True)
    if not (err <= tol).all() or not hue_equal:
        raise AssertionError("card team features disagree with the CPU branch")
    if not (ids_card == ids_ref).all():
        raise AssertionError("team ids from card and CPU features differ")

    acc, separable, n_pairs = team_accuracy(results, seed=0)
    print(f"team accuracy against the generator's teams: {acc:.4f} over "
          f"{n_pairs} matched players (separable: {separable})", flush=True)
    if not separable or acc < 0.95:
        raise AssertionError(f"team accuracy {acc:.4f} < 0.95 or teams not "
                             "separable")

    # the team branch's device time and launches: one profiled fused step
    # on the last batch (a fresh state), the `team_features` range
    x = torch.as_tensor(frames[-BATCH:])
    det.detect_track_batch(x, init_state(config.max_tracks, "cuda"))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        det.detect_track_batch(x, init_state(config.max_tracks, "cuda"))[3].cpu()
        torch.cuda.synchronize()
    team_ms = sum(e.device_time_total for e in prof.key_averages()
                  if e.key == "team_features"
                  and e.device_type == DeviceType.CPU) / 1e3
    team_launches = launches_in(prof, "team_features")
    teams = {
        "frames_per_s_after_first_batch": round(fps, 2),
        "tracking_frames_per_s_same_run": round(track_fps, 2),
        "team_features_device_ms_per_batch": round(team_ms, 4),
        "team_features_launches_per_batch": team_launches,
        "fit_s": round(fit_s, 3),
        "fit_crops": crops,
        "team_accuracy": round(acc, 4),
        "matched_players": n_pairs,
        "feature_max_abs_err": np.round(err.max(axis=(0, 1)), 6).tolist(),
    }
    print(f"team_features range: {team_ms:.4f} ms device, {team_launches} "
          f"launches per batch of {BATCH}", flush=True)
    print(json.dumps({"teams": teams}), flush=True)
    return launches_c, max_err


def near_best_keypoints(step, model, frames, top: int = 5):
    """The rink branch of `step` (a DualStep) on the CPU: each frame's
    `top` best anchors' keypoints (B, top, K, 3) in frame px, and their
    scores (B, top)."""
    hw = (step.rink_imgsz, step.rink_imgsz)
    x = letterbox_batch(frames, step.rink_imgsz, torch.float32)
    raw = forward_raw(model, x)
    _, scores = decode_boxes(raw, step.rink_cfg, hw)
    kpts = decode_keypoints(raw, step.rink_cfg, hw)
    best = scores.max(dim=-1).values.topk(top, dim=1)
    # best_keypoints un-maps the anchor that a one-hot score marks
    out = [best_keypoints(kpts, torch.nn.functional.one_hot(
        best.indices[:, j], kpts.shape[1]).float(), step.rink_geometry)
        for j in range(top)]
    return torch.stack(out, 1).numpy(), best.values.numpy()


def fresh_homography(frame, kpts):
    """A fresh calibrator's homography from one frame's (K, 3) keypoints
    (those >= keypoint_confidence_threshold), and its tier."""
    cal = CalibratorState(frame_hw=FRAME_HW)
    h = cal.process_frame(frame, keypoints_from_array(
        kpts, Config().keypoint_confidence_threshold))
    return h, cal.last_tier


def rink_phase(config, max_err):
    """Phase 8; returns (kernel launches over classify_frames and the rink
    detector's call, max_err, the rink line's numbers)."""
    frames = rink_scene(seed=0, n=BATCH * N_BATCHES)
    h_true = np.linalg.inv(rink_homography())  # image -> rink
    t = time.perf_counter()
    vp = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                        mode=ProcessingMode.TEAM_CLASSIFICATION,
                        show_2d_map=True, team_names=("TEAM_A", "TEAM_B"))
    dual = vp.player_detector
    print(f"dual step ready in {time.perf_counter() - t:.2f} s: player "
          f"{dual.core.in_hw} {dual.dtype}, rink {dual.step.rink_imgsz} square, "
          f"tracker {type(vp.tracker).__name__}", flush=True)
    if not (vp.use_dual and isinstance(dual, DualDetector)
            and dual.with_team_features and not vp.use_fused_tracker
            and isinstance(vp.tracker, ByteTrack)):
        raise AssertionError("TEAM_CLASSIFICATION with the 2D map did not take "
                             "the dual step and the host ByteTrack")
    crops = vp.fit_teams(iter(frames))

    outs = []  # (the dual step's host output, keypoints) of each batch
    detect_batch = dual.detect_batch

    def recording(batch):
        out = detect_batch(batch)
        outs.append((out, dual.last_keypoints))
        return out

    dual.detect_batch = recording
    vp.timers.reset()
    suppress.launches = 0
    results, hs, marks = [], [], []
    t = time.perf_counter()
    for r in vp.classify_frames(iter(frames)):
        results.append(r)
        h = vp.calibrator.stabilizer.current
        hs.append(None if h is None else h.copy())
        if len(results) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_d = suppress.launches
    dual.detect_batch = detect_batch
    fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
    batch_ms = [1e3 * (b - a) for a, b in zip([t] + marks[:-1], marks)]
    n = len(results)
    stage_ms = {k: 1e3 * vp.timers.totals[k] / max(n, 1)
                for k in ("detect", "track", "teams", "keypoints", "rink2d")}
    calibrated = sum(h is not None for h in hs)
    print(f"fit_teams: {crops} crops; ms per batch of {BATCH}: "
          f"{[round(x, 2) for x in batch_ms]}", flush=True)
    print(f"frames/s after the first batch: {fps:.2f}", flush=True)
    print(f"nms_suppress launches over classify_frames: {launches_d}", flush=True)
    print(f"host ms per frame by stage: "
          f"{ {k: round(v, 3) for k, v in stage_ms.items()} }", flush=True)
    print(f"keypoints >= 0.3 per frame: "
          f"{[int((o[1][..., 2] >= 0.3).sum()) for o in outs]} per batch; "
          f"calibrated frames {calibrated} of {n}; tier "
          f"{vp.calibrator.stabilizer.current_tier}", flush=True)
    if n != BATCH * N_BATCHES or len(outs) != N_BATCHES:
        raise AssertionError(f"{n} frames out, {BATCH * N_BATCHES} in")
    if launches_d != N_BATCHES:
        raise AssertionError(f"kernel launched {launches_d} times, not "
                             f"{N_BATCHES} (once per batch at the player branch)")
    for (out, kp) in outs:
        if kp.shape != (BATCH, 56, 3) or not np.isfinite(kp).all():
            raise AssertionError("rink keypoints not finite (B, 56, 3)")
        if out[1].shape != (BATCH, dual.max_det, 4):
            raise AssertionError("no team features from the dual step")
    if not calibrated:
        raise AssertionError("the calibrator never produced a homography")
    if any(not np.isfinite(r["boxes"]).all() for r in results):
        raise AssertionError("non-finite tracked boxes")

    # the kernel at the player branch on the last batch: the plain
    # suppression's kept set, and the halves give the run's detections
    last = torch.as_tensor(frames[-BATCH:]).to("cuda")
    core = dual.core
    with torch.inference_mode():
        cand = core.candidates(dual.player_model, last)
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
        again = core.finish(cand, keep_k)
    torch.cuda.synchronize()
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()))
    if not torch.equal(keep_k, keep_r):
        raise AssertionError("dual-path kept sets differ from the plain version")
    run_det = outs[-1][0][0]
    if not all(torch.equal(getattr(again, f).cpu(), getattr(run_det, f))
               for f in ("boxes", "scores", "classes", "valid")):
        raise AssertionError("the dual core's halves differ from the run's "
                             "last batch")
    print(f"dual-path NMS, last batch: kept {keep_k.sum(1).tolist()} of "
          f"{cand.keep0.sum(1).tolist()}; kernel kept set == plain kept set, "
          f"halves == the run: True", flush=True)
    sites = {"dual": time_kernel(
        f"dual player branch NMS B={cand.keep0.shape[0]} K={cand.keep0.shape[1]}",
        cand.matrix, cand.keep0, cand.thr)}

    # the card's keypoints (bf16) on the last batch's first 2 frames
    # against the same rink branch in f32 on the CPU; the card's set is
    # held against the nearest of the CPU's near-tied best anchors
    t = time.perf_counter()
    rink_cpu = fuse_for_inference(build_model(dual.rink_cfg, load_params(
        shipped_weights_path(config.hockey_model_name))), torch.float32)
    two = frames[-BATCH:][:2]
    with torch.inference_mode():
        cpu_k, cpu_s = near_best_keypoints(dual.step, rink_cpu,
                                           torch.from_numpy(two))
    cpu_s_ = time.perf_counter() - t
    card_k = outs[-1][1][:2]
    kpt = {"px_max": 0.0, "px_median": [], "conf_max": 0.0, "cpu_rank": [],
           "common": [], "h_mean_ft": [], "h_max_ft": [], "scene_kpts": [],
           "scene_h_ft": [], "scene_tier": []}
    for i in range(2):
        cand_j = [j for j in range(cpu_k.shape[1])
                  if cpu_s[i, j] >= cpu_s[i, 0] - NEAR_TIE]

        def dist(j):
            both = (card_k[i, :, 2] >= 0.3) & (cpu_k[i, j, :, 2] >= 0.3)
            return both, np.linalg.norm(card_k[i, both, :2]
                                        - cpu_k[i, j, both, :2], axis=1)
        j = min(cand_j, key=lambda j: np.median(dist(j)[1]))
        both, d = dist(j)
        ref = cpu_k[i, j]
        kpt["cpu_rank"].append(j)
        kpt["common"].append(int(both.sum()))
        kpt["px_max"] = max(kpt["px_max"], float(d.max()))
        kpt["px_median"].append(float(np.median(d)))
        kpt["conf_max"] = max(kpt["conf_max"], float(np.abs(
            card_k[i, :, 2] - ref[:, 2]).max()))
        h_card, _ = fresh_homography(two[i], card_k[i])
        h_cpu, tier = fresh_homography(two[i], ref)
        anchors = bottom_center_anchors(results[-BATCH + i]["boxes"])
        if h_card is None or h_cpu is None or not len(anchors):
            raise AssertionError(f"frame {i}: no homography or no players")
        hd = np.linalg.norm(project(h_card, anchors) - project(h_cpu, anchors),
                            axis=1)
        kpt["h_mean_ft"].append(float(hd.mean()))
        kpt["h_max_ft"].append(float(hd.max()))
        # the CPU's reading of the scene (its argmax anchor)
        h0, tier0 = fresh_homography(two[i], cpu_k[i, 0])
        kpt["scene_kpts"].append(int((cpu_k[i, 0, :, 2] >= 0.3).sum()))
        kpt["scene_h_ft"].append(None if h0 is None else
                                 homography_distance(h0, h_true, FRAME_HW))
        kpt["scene_tier"].append(tier0)
    print(f"rink keypoints, card bf16 vs CPU f32 ({cpu_s_:.1f} s), 2 frames: "
          f"CPU anchor rank {kpt['cpu_rank']} (argmax 0), {kpt['common']} "
          f"keypoints >= 0.3 on both sides, max {kpt['px_max']:.3f} px "
          f"(tolerance {KPT_MAX_PX}), median "
          f"{[round(x, 3) for x in kpt['px_median']]} px (tolerance "
          f"{KPT_MEDIAN_PX}), confidence max |diff| {kpt['conf_max']:.4f} "
          f"(tolerance {KPT_CONF}); homographies' players mean "
          f"{[round(x, 3) for x in kpt['h_mean_ft']]} ft (tolerance "
          f"{H_MEAN_FT}), max {[round(x, 3) for x in kpt['h_max_ft']]} ft "
          f"(tolerance {H_MAX_FT})", flush=True)
    print(f"the CPU's reading of the scene: keypoints >= 0.3 "
          f"{kpt['scene_kpts']} (at least {SCENE_KPTS}), homography "
          f"{[None if x is None else round(x, 2) for x in kpt['scene_h_ft']]} "
          f"ft from the known one (at most {SCENE_H_FT}), tier "
          f"{kpt['scene_tier']}", flush=True)
    if (kpt["px_max"] > KPT_MAX_PX or max(kpt["px_median"]) > KPT_MEDIAN_PX
            or kpt["conf_max"] > KPT_CONF or min(kpt["common"]) < SCENE_KPTS):
        raise AssertionError("card keypoints disagree with the f32 CPU run")
    if max(kpt["h_mean_ft"]) > H_MEAN_FT or max(kpt["h_max_ft"]) > H_MAX_FT:
        raise AssertionError("card and CPU keypoints calibrate apart")
    if (min(kpt["scene_kpts"]) < SCENE_KPTS or None in kpt["scene_h_ft"]
            or max(kpt["scene_h_ft"]) > SCENE_H_FT):
        raise AssertionError("the port does not read the rink scene")

    # the rink model alone (an injected player detector's route): one
    # call on the same frames, its NMS kernel against the plain version
    rd = RinkKeypointDetector(config.hockey_model_name, config,
                              frame_hw=FRAME_HW, device="cuda")
    suppress.launches = 0
    rd_k = rd.detect_keypoints_batch(frames[-BATCH:])
    launches_r = suppress.launches
    core_r = rd.detector.core
    with torch.inference_mode():
        cand_r = core_r.candidates(rd.detector.model, last)
        rk = suppress(cand_r.matrix, cand_r.keep0, cand_r.thr)
        rr = suppress_reference(cand_r.matrix, cand_r.keep0, cand_r.thr)
    torch.cuda.synchronize()
    max_err = max(max_err, float((rk.int() - rr.int()).abs().max()))
    print(f"RinkKeypointDetector ({core_r.in_hw} rect): {launches_r} kernel "
          f"launch, kept {rk.sum(1).tolist()} of {cand_r.keep0.sum(1).tolist()}; "
          f"kernel kept set == plain: {torch.equal(rk, rr)}; keypoints "
          f"{rd_k.shape}, >= 0.3 per frame "
          f"{(rd_k[..., 2] >= 0.3).sum(1).tolist()}", flush=True)
    if launches_r != 1 or not torch.equal(rk, rr):
        raise AssertionError("the rink detector's NMS launch failed its check")
    if rd_k.shape != (BATCH, 56, 3) or not np.isfinite(rd_k).all():
        raise AssertionError("rink detector keypoints not finite (B, 56, 3)")
    sites["rink_detector"] = time_kernel(
        f"rink detector NMS B={cand_r.keep0.shape[0]} K={cand_r.keep0.shape[1]}",
        cand_r.matrix, cand_r.keep0, cand_r.thr)

    # the rink branch's ranges on the card: one profiled dual step
    dual.run(frames[-BATCH:])[3].cpu()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dual.run(frames[-BATCH:])[3].cpu()
        torch.cuda.synchronize()
    ranges = ("rink_letterbox", "rink_forward", "rink_decode", "forward",
              "team_features", "pack")
    range_ms = {r: sum(e.device_time_total for e in prof.key_averages()
                       if e.key == r and e.device_type == DeviceType.CPU) / 1e3
                for r in ranges}
    range_launches = {r: launches_in(prof, r) for r in ranges}
    print(f"device ms per batch of {BATCH} by range: "
          f"{ {r: round(v, 4) for r, v in range_ms.items()} }; launches "
          f"{range_launches}", flush=True)
    rink = {
        "frames_per_s_after_first_batch": round(fps, 2),
        "ms_per_batch": [round(x, 2) for x in batch_ms],
        "kernel_launches_per_batch": launches_d / N_BATCHES,
        "host_ms_per_frame": {k: round(v, 3) for k, v in stage_ms.items()},
        "range_device_ms_per_batch": {r: round(v, 4) for r, v in range_ms.items()},
        "range_launches_per_batch": range_launches,
        "calibrated_frames": calibrated,
        "final_h_ft_from_known": round(homography_distance(
            hs[-1], h_true, FRAME_HW), 3) if hs[-1] is not None else None,
        "keypoints_card_vs_cpu": kpt,
        "kernel_at_dual_site": sites["dual"],
        "kernel_at_rink_detector_site": sites["rink_detector"],
    }
    print(json.dumps({"rink": rink}), flush=True)
    return launches_d + launches_r, max_err


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)

    phase("1 card")
    card = card_line()
    print(card, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]} device {kind}", flush=True)

    phase("2 build nms_suppress (nvcc, sm_90a)")
    t = time.perf_counter()
    lib = build_library()
    suppress.load()
    print(f"built {os.path.relpath(lib, ROOT)} in "
          f"{time.perf_counter() - t:.2f} s", flush=True)

    phase("3 kernel vs plain on the card")
    max_err = 0.0
    cases = kernel_cases(dev)
    for name, m, keep0, thr in cases:
        got = suppress(m, keep0, thr)
        ref = suppress_reference(m, keep0, thr)
        torch.cuda.synchronize()
        err = float((got.int() - ref.int()).abs().max())
        max_err = max(max_err, err)
        print(f"{name}: kept {int(got.sum())} of {int(keep0.sum())}, "
              f"bit-equal {torch.equal(got, ref)}", flush=True)
        if not torch.equal(got, ref):
            raise AssertionError(f"kernel != plain version on {name}")
    name, m, keep0, thr = cases[1]
    time_kernel(f"dense case, {name} (random boxes)", m, keep0, thr)

    phase("4 main path: YOLOv8x bf16, 1080p -> 736x1280, VideoProcessor.detect_frames")
    t = time.perf_counter()
    config = Config()
    det = Detector(config.player_model_name, config, frame_hw=FRAME_HW,
                   device="cuda", dtype=torch.bfloat16)
    vp = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                        mode=ProcessingMode.PLAYER_DETECTION, player_detector=det)
    frames = synthetic_frames(seed=0, n=BATCH * N_BATCHES)
    print(f"detector ready in {time.perf_counter() - t:.2f} s "
          f"(imgsz {det.imgsz}, frame batch "
          f"{config.resolved_frame_batch(dev)})", flush=True)
    if config.resolved_frame_batch(dev) != BATCH:
        raise AssertionError("frame batch is not the smoke run's batch")

    torch.cuda.reset_peak_memory_stats()
    suppress.launches = 0
    dets, marks = [], []
    t = time.perf_counter()
    for d in vp.detect_frames(iter(frames)):
        dets.append(d)
        if len(dets) % BATCH == 0:
            marks.append(time.perf_counter())
    launches = suppress.launches
    batch_ms = [1e3 * (b - a) for a, b in zip([t] + marks[:-1], marks)]
    steady_fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
    per_frame = [len(d) for d in dets]
    print(f"ms per batch of {BATCH}: {[round(x, 2) for x in batch_ms]}", flush=True)
    print(f"frames/s after the first batch: {steady_fps:.2f}", flush=True)
    print(f"detections per frame: {per_frame}", flush=True)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"nms_suppress launches over the main path: {launches}", flush=True)
    if len(dets) != BATCH * N_BATCHES:
        raise AssertionError(f"{len(dets)} frames out, {BATCH * N_BATCHES} in")
    if launches < N_BATCHES:
        raise AssertionError(f"kernel launched {launches} times, < {N_BATCHES}")
    h, w = FRAME_HW
    for d in dets:
        if not (np.isfinite(d.boxes).all() and np.isfinite(d.scores).all()):
            raise AssertionError("non-finite detections")
        if len(d) and ((d.boxes < 0).any() or (d.boxes[:, [0, 2]] > w).any()
                       or (d.boxes[:, [1, 3]] > h).any()
                       or (d.scores <= config.detection_confidence).any()):
            raise AssertionError("detections outside the frame or threshold")
    if sum(per_frame) == 0:
        raise AssertionError("no detections on the synthetic frames")

    # the last batch again through the detect step's two halves: the
    # candidates, then the kept set by the kernel and by the plain
    # suppression on that one set of device tensors; the kept sets must be
    # equal, and the kernel's half must give the main path's detections
    last = torch.as_tensor(frames[-BATCH:]).to(dev)
    with torch.inference_mode():
        cand = det.core.candidates(det.model, last)
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
        again = det.core.finish(cand, keep_k)
    torch.cuda.synchronize()
    same = torch.equal(keep_k, keep_r)
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()))
    print(f"main-path NMS, last batch: kept {keep_k.sum(1).tolist()} of "
          f"{cand.keep0.sum(1).tolist()} candidates; kernel kept set == plain "
          f"kept set: {same}", flush=True)
    if not same:
        raise AssertionError("main-path kept sets differ from the plain version")
    for i, d in enumerate(dets[-BATCH:]):
        h_again = vp._filter(HostDetections.from_padded(again, i))
        if not all(np.array_equal(x, y) for x, y in zip(h_again, d)):
            raise AssertionError(f"the halves differ from the main path, frame {i}")
    print("candidates + kernel + finish == detect_frames on the last batch: True",
          flush=True)
    b, k = cand.keep0.shape
    main = time_kernel(f"main-path NMS B={b} K={k}", cand.matrix, cand.keep0,
                       cand.thr)

    # reference: the same detector in f32 on the CPU (plain suppression),
    # two frames; bf16 on the card must find the same players
    t = time.perf_counter()
    ref_det = Detector(config.player_model_name, config, frame_hw=FRAME_HW,
                       device="cpu", dtype=torch.float32)
    ref_vp = VideoProcessor(config, device="cpu", frame_hw=FRAME_HW,
                            mode=ProcessingMode.PLAYER_DETECTION,
                            player_detector=ref_det)
    ref = list(ref_vp.detect_frames(iter(frames[:2])))
    fwd = min(match_fraction(r, d) for r, d in zip(ref, dets[:2]))
    bwd = min(match_fraction(d, r) for r, d in zip(ref, dets[:2]))
    print(f"f32 CPU reference ({time.perf_counter() - t:.1f} s): detections "
          f"{[len(r) for r in ref]} vs card {per_frame[:2]}; matched at IoU>=0.8 "
          f"ref->card {fwd:.3f}, card->ref {bwd:.3f}", flush=True)
    if min(fwd, bwd) < 0.8:
        raise AssertionError("bf16 card detections disagree with the f32 reference")

    phase("5 PLAYER_TRACKING: fused detect + track, VideoProcessor.track_frames "
          "(T=128, D=64)")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the tracker's products must be f32")
    vp_t = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                          mode=ProcessingMode.PLAYER_TRACKING,
                          player_detector=det)
    if not (vp_t.use_fused_tracker and isinstance(vp_t.tracker, DeviceByteTrack)):
        raise AssertionError("PLAYER_TRACKING on CUDA did not take the fused "
                             "device tracker")
    ocr = vp_t.ocr
    if ocr.backend != "digits" or next(ocr.net.buffers()).device.type != "cuda":
        raise AssertionError("PLAYER_TRACKING has no digit reader on the card")
    ocr_calls = []  # (crops, tens logits, ones logits) of each forward
    ocr.net.register_forward_hook(
        lambda mod, inp, out: ocr_calls.append((inp[0], *out)))
    st = assignment.stats
    suppress.launches = 0
    st.syncs = st.rounds = st.fill_steps = 0
    rows, outs, marks = [], [], []
    t = time.perf_counter()
    for r in vp_t.track_frames(iter(frames)):
        rows.append(r)
        if len(rows) % BATCH == 1:  # the batch's step has just run
            outs.append(vp_t.last_track_batch)
        if len(rows) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_t = suppress.launches
    syncs, rounds, fills = st.syncs, st.rounds, st.fill_steps
    track_fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
    batch_ms = [1e3 * (b - a) for a, b in zip([t] + marks[:-1], marks)]
    print(f"ms per batch of {BATCH}: {[round(x, 2) for x in batch_ms]}", flush=True)
    print(f"frames/s after the first batch: {track_fps:.2f}", flush=True)
    print(f"nms_suppress launches over the tracking path: {launches_t}", flush=True)
    print(f"tracked detections per frame: {[len(r[3]) for r in rows]}", flush=True)
    if len(rows) != BATCH * N_BATCHES or len(outs) != N_BATCHES:
        raise AssertionError(f"{len(rows)} frames out, {BATCH * N_BATCHES} in")
    if launches_t < N_BATCHES:
        raise AssertionError(f"kernel launched {launches_t} times, < {N_BATCHES}")
    for f, (_, _, _, tids) in enumerate(rows):
        if (tids <= 0).any() or len(set(tids.tolist())) != len(tids):
            raise AssertionError(f"frame {f}: ids {tids.tolist()}")
    if sum(len(r[3]) for r in rows) == 0:
        raise AssertionError("no tracked detections")

    # the last batch again through the tracking core's two halves (NMS
    # floored at BYTE_FLOOR, so denser candidate sets than phase 4's): the
    # kernel's kept set must equal the plain suppression's, and the
    # kernel's half must give the detections the run handed the tracker
    core_t = det._track_step.core
    with torch.inference_mode():
        cand = core_t.candidates(det.model, last)
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
        again = core_t.finish(cand, keep_k)
    torch.cuda.synchronize()
    same = torch.equal(keep_k, keep_r)
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()))
    print(f"tracking-path NMS (conf {core_t.conf}), last batch: kept "
          f"{keep_k.sum(1).tolist()} of {cand.keep0.sum(1).tolist()} "
          f"candidates; kernel kept set == plain kept set: {same}", flush=True)
    if not same:
        raise AssertionError("tracking-path kept sets differ from the plain "
                             "version")
    run_det = outs[-1][0]
    if not all(torch.equal(getattr(again, f), getattr(run_det, f))
               for f in ("boxes", "scores", "classes", "valid")):
        raise AssertionError("the tracking core's halves differ from the "
                             "run's last batch")
    print("candidates + kernel + finish == the tracking run's last batch: True",
          flush=True)

    # the card's ids against tracker_scan on the CPU over the same padded
    # detections, batch by batch from init_state
    kwargs = det.tracker_kwargs()
    inputs = [tracker_inputs(o[0]) for o in outs]
    state = init_state(config.max_tracks, "cpu")
    for b, (o, x) in enumerate(zip(outs, inputs)):
        state, cpu_tids = tracker_scan(state, *(v.cpu() for v in x), **kwargs)
        if not torch.equal(cpu_tids, o[2].cpu()):
            raise AssertionError(f"batch {b}: card track ids differ from the "
                                 "CPU replay")
    print("card track ids == tracker_scan replayed on the CPU: True", flush=True)

    # the tracker alone on the card, over the run's own detections: CUDA
    # events and host clock, then kernel launches in a profiled replay
    card_tids, ev_ms, host_ms = replay_on_card(inputs, kwargs, config.max_tracks)
    if not all(torch.equal(a, o[2]) for a, o in zip(card_tids, outs)):
        raise AssertionError("a replay on the card gave other ids")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        state = init_state(config.max_tracks, "cuda")
        for x in inputs:
            with torch.inference_mode(), record_function("tracker_scan"):
                state, _ = tracker_scan(state, *x, **kwargs)
        torch.cuda.synchronize()
    tracker_launches = launches_in(prof, "tracker_scan") / N_BATCHES
    n_ids, switches = id_switches(rows, seed=0)
    tracking = {
        "frames_per_s_after_first_batch": round(track_fps, 2),
        "tracker_ms_per_batch_cuda_events": [round(x, 3) for x in ev_ms],
        "tracker_ms_per_batch_host_clock": [round(x, 3) for x in host_ms],
        "host_syncs_per_batch": syncs / N_BATCHES,
        "auction_rounds_per_batch": rounds / N_BATCHES,
        "fill_steps_per_batch": fills / N_BATCHES,
        "kernel_launches_per_batch_in_tracker": tracker_launches,
        "distinct_ids": n_ids,
        "id_switches": switches,
    }
    print(f"tracker per batch of {BATCH} (replay on the card): CUDA events "
          f"{tracking['tracker_ms_per_batch_cuda_events']} ms, host clock "
          f"{tracking['tracker_ms_per_batch_host_clock']} ms; host syncs per "
          f"batch {syncs / N_BATCHES:.1f} ({rounds / N_BATCHES:.1f} auction rounds); "
          f"kernel launches per batch in the tracker {tracker_launches:.0f}",
          flush=True)
    print(f"distinct ids {n_ids}, id switches against the generator's players "
          f"{switches}", flush=True)
    tracking.update(ocr_check(ocr, ocr_calls, vp_t.timers))
    print(json.dumps({"tracking": tracking}), flush=True)

    phase("6 TEAM_CLASSIFICATION: fit_teams, then the fused detect + track + "
          "team step through VideoProcessor.classify_frames")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the crop products must be f32")
    launches_c, max_err = team_phase(config, frames, max_err, track_fps)

    phase("7 PUCK_DETECTION: YOLOv8s bf16 on 8 tiles of 640 per 1080p frame, "
          "VideoProcessor.puck_frames")
    launches_p, max_err = puck_phase(config, max_err)

    phase("8 rink + 2D map: the dual step (YOLOv8x 736x1280 + YOLOv8s-pose "
          "512), host ByteTrack and calibrator, VideoProcessor.classify_frames")
    launches_r, max_err = rink_phase(config, max_err)

    phase("9 results")
    print(f"total wall time {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": [{
        "name": "nms_suppress",
        "route": "cuda",
        "source": "hockey_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "hockey_tpu/ops/pallas/nms_kernel.py:24",
        "launches": launches + launches_t + launches_c + launches_p + launches_r,
        "max_abs_err": max_err,
        **main,
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
