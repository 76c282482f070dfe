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
   the main path's own candidates; every batch must have been uploaded
   from page-locked staging (core/staging.py), none by the pageable copy;
   the conv epilogue kernel must have launched 103 times a forward;
4b. the conv epilogue kernel (csrc/conv_epilogue.cu) on every inference
   conv of one YOLOv8x forward on the last batch: each conv's epilogue
   bit-equal to the plain sequence (bias add, SiLU, residual add) on the
   same operands, the forward bit-equal to the forward with the plain
   epilogue and to the plain ops with the bias inside the conv (the same
   check runs in phase 7 on the puck YOLOv8s's tiles and in phase 8 on
   the rink YOLOv8s-pose at 512; the largest gap of all three is the
   `kernels` line's `max_abs_err`); the `forward` range's device ms
   against its kernels', which must hold the epilogue's; three times each, the
   kernel's device ms a batch and the plain sequence's (`library_ms`), and
   the bound (bytes at the card's memory rate); a `{"conv_epilogue": ...}`
   JSON line;
5. PLAYER_TRACKING: the same detector through
   VideoProcessor(mode=PLAYER_TRACKING).track_frames, the fused detect +
   track step (T = 128 tracks, D = 64 detections), three batches of 8; the
   tracker must be the fused one (no host ByteTrack), the kernel must
   launch at least 3 times, the last batch goes again through the
   tracking core's two halves (NMS floored at 0.1), where the kernel's and
   the plain suppression's kept sets must be equal and the kernel's half
   must give the run's detections, the card's track ids must equal a replay of
   `tracker_scan` on the CPU over the same padded detections copied from
   the card, and every frame's ids must be positive and distinct; the
   tracker must have run as one launch of its CUDA kernel per batch with
   no host sync; it
   prints frames/s, the tracker's ms per batch (CUDA events and host
   clock, from a replay of `tracker_scan` on the card over the run's own
   detections), host syncs per batch (counted in `auction_match`, 0 on
   the card), the kernel's auction rounds and fill steps per batch, CUDA
   kernel launches per batch in the tracker (torch.profiler), the count
   of distinct ids and id switches against the generator's own players;
   the jersey-number reader (the digit net on the card) must have read
   crops, whose card logits must match the same net on the CPU in f32
   within 1e-3 with equal argmax; it prints the reads and the reader's
   host ms per batch; every batch must have been uploaded pinned, as in
   phase 4; the conv epilogue must have launched once a conv of every
   YOLOv8x and digit-net forward (phases 6-8 hold their paths to the same
   count; the `kernels` line's `launches` is the sum); and these numbers, the upload counts too, as one JSON line;
5b. the tracker's kernel (csrc/tracker_scan.cu) against the plain
   `tracker_scan_reference` on the card at the main path's shapes (T =
   128, D = 64, batches of 8), on phase 5's own detections and on a crowd
   of 20-22 overlapping boxes a frame (`crowded_sequence`), each side
   carrying its own state from init_state: ids and every integer and
   boolean field equal batch by batch, mean, cov and score within rtol
   1e-5 and atol 1e-4 (the tests' tolerance; the largest gap is the
   `kernels` line's `max_abs_err`), the kernel's rounds and fill steps
   equal to the plain solver's;
   on a batch from a live state, the kernel's device ms per launch
   (torch.profiler, by the kernel's name), its call ms (CUDA events over
   back-to-back calls), the plain version's ms per batch on the card, the
   bound (its bytes at the card's memory rate), launches, and rounds and
   fill steps per association; a `{"tracker_kernel": ...}` JSON line;
6. TEAM_CLASSIFICATION, the reference's main path: a VideoProcessor in
   that mode builds its own detector with the team branch; `fit_teams`
   fits the team classifier on every 10th of the same 24 frames, then
   `classify_frames` runs the fused step (detect, NMS kernel,
   `tracker_scan`, team features; one packed (8, 64, 11) copy per batch)
   over 3 batches of 8. The tracker must be the fused one and `packed` 11
   wide; the kernel must launch at least 3 times and, on the last batch,
   keep the plain suppression's set; the tracker's kernel must launch
   once a batch; the card's ids must equal a CPU
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
   3/4 of the frames after its 2-frame acquisition; phase 4b's epilogue
   check on the last batch's 64 tiles. It prints frames/s,
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
   the same frames, its one NMS launch held to the plain version; phase
   4b's epilogue check on the rink model at the last batch's 512 input. It
   prints frames/s, the host ms per frame of the stages (keypoints,
   rink2d among them), the rink ranges' device ms and launches per batch
   (torch.profiler), and the kernel's device, call, plain and bound times
   at both call sites, as one JSON line;
9. team cascade: phase 6's detector and scene, fitted on frames 0-20
   (`initialization_stride` 1), headless, so `TeamClassifier(
   use_segmentation=False)` goes interactive -> robust, and with
   `use_robust=False` -> hybrid; each time `fit_teams` and
   `classify_frames` (3 batches of 8), failing unless the strategy asked
   for is the one that ran; MobileNetV3 (f32, TF32 off) on the card
   against the CPU on the last batch's player crops (cosine of each
   embedding >= 0.9999, max |diff| printed), the team ids from the card's
   features equal to those from the CPU's, the kernel at the step's last
   batch equal to its plain version; it prints the team accuracy, the
   fit's and the classifiers' times and the embed's device and call ms
   for the fit's crops and one frame's, as one JSON line;
10. multi-clip: 4 clips of 16 frames through
   `MultiClipProcessor.run_frames` in PLAYER_TRACKING with phase 4's
   detector, one detection batch of B = 4 per frame row (16 kernel
   launches; the kernel at B = 4 against its plain version, timed); each
   clip against the clip alone through a single-clip VideoProcessor at
   frame batch 4: in bf16 reported (a frame's rounding depends on its
   position in the batch), with the detector in f32 ids equal and boxes
   within MULTICLIP_BOX_PX; frames/s over all clips, as one JSON line;
11. session: TEAM_CLASSIFICATION on the fused step over 4 batches; a run
   saved with `save_run_state` after 2 batches and resumed with
   `load_run_state` in a fresh processor must give the uninterrupted
   run's tracker ids, team ids and boxes on every frame;
12. validation: square scenes drawn in numpy (VAL_IMAGES images of
   `_player` figures at 640 with their boxes, VAL_RINK_IMAGES rink views
   at 512 through known homographies with their projected keypoints),
   through `evaluate_detector` with the shipped player Detector at conf
   0.001, `InTrainingEvaluator` (K = 384, max_det 96) on the same images
   with the unfused model, and `InTrainingPoseEvaluator` (K = 64, max_det
   8) with the unfused pose model: two batches of 8 each, the second
   padded, so exactly 2 kernel launches each; bf16, then the same in f32
   on the card, mAP50 and PCK within VAL_TOL of each other; the
   evaluators must leave the caller's model unchanged; the kernel at each
   of the three sites (`val`, `train_eval`, `pose_eval`) on the padded
   last batch keeps the plain suppression's set, with its times there;
   it prints images/s, mAP50, mAP50-95, PCK and the mean keypoint error
   as one JSON line;
13. training, the slice's path: (a) one train step of the shipped
   YOLOv8s (puck) at 640, batch 2, in f32 on the card (TF32 off for
   cuDNN and matmul) against the same step on the CPU: each loss
   component within TRAIN_LOSS_RTOL, every gradient's cosine at least
   TRAIN_GRAD_COS, the BN batch statistics within TRAIN_BN_TOL; (b)
   `hockey_tpu_torch.train.loop` (`run`, the body of `main`) on YOLOv8x,
   640, batch 16, bf16, from the shipped weights, on a pool of
   TRAIN_POOL numpy-drawn square scenes: TRAIN_STEPS_DEVICE steps of
   `--device-data` (mosaic 1.0, mixup 0.15) and TRAIN_STEPS_HOST of the
   host path, each with `--ema 0.999`, `--precise-bn 2` and
   `--val-every` on TRAIN_VAL held-out scenes; every loss finite, no step
   skipped, fg anchors on every step, parameters and running stats
   changed, the checkpoint equal to the EMA weights (precise-BN replaces
   its running statistics), exactly 2 kernel launches per validation, the
   kernel's kept set equal to the plain suppression's at the evaluator's
   site, and held-out mAP50 after the steps no lower than before them by
   more than TRAIN_MAP_DROP on each path: the EMA model each run ends
   with, scored with its own running statistics, against the shipped
   model with its shipped ones, by the same evaluator. The loop's own
   last validation (precise-BN on the pool's first 16 clean images, then
   the evaluator) is printed beside it and not gated: precise-BN on these
   flat drawn scenes lowers the shipped model's score in the JAX package
   too (scripts/jax_precise_bn_witness.py); (c) a cold `init_params` YOLOv8n at 320, batch 16,
   LEARN_STEPS steps on one batch of the square scenes, then precise-BN,
   must detect at least half of that batch's boxes at IoU 0.25
   (tests/test_train.py:165-208); (d) the shipped YOLOv8s-pose at 512,
   bf16, a few `--device-data` steps on `square_rink` views with finite
   keypoint losses and the pose evaluator's kept set equal to the plain
   one. It prints train-step ms and images/s (device-data against host),
   peak memory, the kernel's launches and times at both sites and the
   phase's seconds as one JSON line;
14. the JAX package's default CLI invocations, the converters and the
   last trainers: (a) `hockey_tpu_torch.train.loop` with no data flag
   (YOLOv8x, 640, batch 16, bf16, cold, on SyntheticHockeyDataset drawn
   in numpy) for DEFAULT_TRAIN_STEPS steps, every loss finite, the
   checkpoint equal to the trained model and loading back; (b)
   `hockey_tpu_torch.train.val` with no flag (the shipped player model on
   the JAX CLI's 50 synthetic images), mAP50 and mAP50-95 within VAL_TOL
   of the JAX CLI's f32 figures (JAX_SYNTHETIC_F32), 7 kernel launches,
   the kernel's kept set equal to the plain one at site `val_synthetic`;
   (c) the shipped player weights through an ultralytics-layout state
   dict and `convert_state_dict`: detections of one batch through
   `detect_frames` and the kept sets bit-equal to the shipped model's, and
   the shipped team embedder through a torchvision state dict and
   `convert_torchvision`: embeddings bit-equal; (d) the embedder's
   training step at the JAX defaults (48 designs, 64x32, f32) on
   numpy-drawn pairs: the card's two steps against the CPU's (loss,
   gradients, each leaf's update), EMBED_STEPS steps whose pair accuracy
   must rise by EMBED_ACC_RISE, then `calibrate_bn`; (e) the digit net's
   (batch 128, 48x48 grey) likewise, then DIGIT_STEPS steps from cold
   whose loss must fall below DIGIT_LOSS_FRAC of its start; its times and
   checks as one JSON line;
15. the host runtime and multi-device training and detection: (a)
   tracking/native.py builds csrc/hockey_host.cpp with g++ into a fresh
   directory (its build seconds printed); its IoU must equal the plain numpy
   IoU bit for bit on HOST_PAIRS^2 random pairs, and its assignments must
   reach scipy's total cost on HOST_LSAP random problems (half with tied
   integer costs) and equal scipy's assignment on every problem with
   continuous costs; the host ByteTrack replays phase 8's own tracker
   inputs through the runtime and through the plain route (numpy IoU,
   scipy), in turns, with its ms per frame; (b) a process group of one
   over NCCL and a 1x1 mesh: MESH_STEPS steps of the shipped YOLOv8x at
   640, batch 16, bf16 (square scenes) through `shard_train_step` against
   `Trainer` on the same batches with cuDNN's deterministic algorithms,
   losses and parameters bit-equal (else within MESH_LOSS_RTOL and
   MESH_PARAM_TOL), both then timed in turns with cuDNN's defaults;
   `detect_dp` of phase 4's detector on 8 1080p frames bit-equal to
   `detect_batch`, with exactly one kernel launch, and the kernel's kept
   set at site `detect_dp` equal to the plain one; (c) with two cards or
   more, dp 2 over NCCL (`chip_smoke.py --mesh-rank`, one process per
   card) against (b)'s single-device steps and detections, else it prints
   that one card is visible; its numbers as one JSON line;
16. the kernel table as one JSON line (every site timed in this run under
   `sites`), then the result line.

Any failure raises and exits non-zero. Without CUDA, or without the
hockey_tpu_torch package beside it, it exits non-zero and prints no result.
"""

import contextlib
import ctypes
import dataclasses
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from hockey_tpu_torch.core.config import Config, ProcessingMode  # noqa: E402
from hockey_tpu_torch.core.mesh import (  # noqa: E402
    free_port,
    init_from_env,
    launch,
    make_mesh,
    shard_batch,
)
from hockey_tpu_torch.core.session import load_run_state, save_run_state  # noqa: E402
from hockey_tpu_torch.core import staging  # noqa: E402
from hockey_tpu_torch.homography.ransac import dlt_homography, project  # noqa: E402
from hockey_tpu_torch.homography.calibrator import CalibratorState  # noqa: E402
from hockey_tpu_torch.homography.keypoints import (  # noqa: E402
    RinkKeypointDetector,
    keypoints_from_array,
)
from hockey_tpu_torch.homography.stabilizer import homography_distance  # noqa: E402
from hockey_tpu_torch.models.checkpoint import (  # noqa: E402
    load_params,
    save_params,
    shipped_weights_path,
)
from hockey_tpu_torch.models.convert import BACKBONE_IDX, convert_state_dict  # noqa: E402
from hockey_tpu_torch.models.detector import (  # noqa: E402
    DetectCore,
    Detector,
    HostDetections,
    best_keypoints,
    fetch,
    pack,
    team_features,
    tracker_inputs,
)
from hockey_tpu_torch.models.dual import DualDetector  # noqa: E402
from hockey_tpu_torch.models import layers  # noqa: E402
from hockey_tpu_torch.models.layers import fuse_for_inference, trainable  # noqa: E402
from hockey_tpu_torch.models.mobilenetv3 import (  # noqa: E402
    build_embedder,
    convert_torchvision,
    embed,
)
from hockey_tpu_torch.models.mobilenetv3 import init_params as embed_init_params  # noqa: E402
from hockey_tpu_torch.models.mobilenetv3 import \
    load_default_params as load_embed_params  # noqa: E402
from hockey_tpu_torch.multiclip import MultiClipProcessor  # noqa: E402
from hockey_tpu_torch.models.yolov8 import (  # noqa: E402
    YoloConfig,
    build_model,
    decode_boxes,
    decode_keypoints,
    forward_raw,
    init_params,
    params_to_jax,
)
from hockey_tpu_torch.ops import conv_epilogue as ce  # noqa: E402
from hockey_tpu_torch.ops.letterbox import letterbox_batch, letterbox_rect_batch  # noqa: E402
from hockey_tpu_torch.ocr.digits import (  # noqa: E402
    DigitNet,
    DigitTrainer,
    init_digit_params,
    load_default_params,
)
from hockey_tpu_torch.ops.iou import box_iou  # noqa: E402
from hockey_tpu_torch.ops.nms import nms_select, suppression_matrix  # noqa: E402
from hockey_tpu_torch.ops.nms_kernel import (  # noqa: E402
    build_library,
    suppress,
    suppress_reference,
)
from hockey_tpu_torch.ops import assignment  # noqa: E402
from hockey_tpu_torch.parallel.sharding import (  # noqa: E402
    detect_dp,
    gather_params,
    shard_train_step,
)
from hockey_tpu_torch.pipeline import VideoProcessor  # noqa: E402
from hockey_tpu_torch.rinkmap.dimensions import (  # noqa: E402
    NHL,
    default_keypoint_positions,
)
from hockey_tpu_torch.rinkmap.renderer import bottom_center_anchors  # noqa: E402
from hockey_tpu_torch.slicing.sahi import MERGE_MAX_DET, SlicedDetector  # noqa: E402
from hockey_tpu_torch.teams.base import host_crops, standardize_crops  # noqa: E402
from hockey_tpu_torch.teams.facade import TeamClassifier  # noqa: E402
from hockey_tpu_torch.teams.hybrid import HybridTeamClassifier  # noqa: E402
from hockey_tpu_torch.teams.embed_train import EmbedTrainer  # noqa: E402
from hockey_tpu_torch.teams.robust import RobustTeamClassifier  # noqa: E402
from hockey_tpu_torch.tracking import bytetrack, native  # noqa: E402
from hockey_tpu_torch.tracking.bytetrack import ByteTrack  # noqa: E402
from hockey_tpu_torch.tracking.device_tracker import (  # noqa: E402
    DeviceByteTrack,
    TrackState,
    init_state,
    tracker_scan,
    tracker_scan_reference,
)
from hockey_tpu_torch.tracking.scan_kernel import scan as scan_kernel  # noqa: E402
from hockey_tpu_torch.models.yolov8 import MODEL_ZOO  # noqa: E402
from hockey_tpu_torch.models.checkpoint import flatten_tree  # noqa: E402
from hockey_tpu_torch.train import loop as train_loop  # noqa: E402
from hockey_tpu_torch.train import val as train_val  # noqa: E402
from hockey_tpu_torch.train.data import (  # noqa: E402
    PoolDataset,
    SyntheticHockeyDataset,
    pad_targets,
)
from hockey_tpu_torch.train.losses import detection_loss  # noqa: E402
from hockey_tpu_torch.train.trainer import (  # noqa: E402
    TrainConfig,
    Trainer,
    make_bn_stats_fn,
    precise_bn,
)
from hockey_tpu_torch.train.eval import (  # noqa: E402
    InTrainingEvaluator,
    InTrainingPoseEvaluator,
    evaluate_detector,
    inference_copy,
)

FRAME_HW = (1080, 1920)
BATCH = 8
N_BATCHES = 3
# the generator's team of player j is j % 2 (synthetic_frames' `teams`)
N_TEAMS = 2
MULTICLIP_K = 4  # phase 10's clips, the detection batch of its rows
# phase 10: a clip's boxes in lockstep against the clip alone, both in
# batches of 4, with the detector in f32 (px). A frame sits at another
# position of its batch in the two runs, and the convolutions round a
# sample by its position: cuDNN's f32 convolutions (TF32, PyTorch's
# default for cuDNN) moved boxes by 0.027 px, bf16 by 0.21 px on one
# frame and swapped two ids on 3 of 64 frames; oneDNN f32 on the CPU
# 1.2e-4 px. In f32 the ids must be equal
MULTICLIP_BOX_PX = 0.1
# H100 SXM peaks (NVIDIA data sheet) for the bound of the suppression
# kernel: it moves f32 matrix rows and does f32 comparisons
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
KERNEL_NAME = "nms_suppress_kernel"  # the CUDA kernel's name in a trace
TRACKER_KERNEL_NAME = "tracker_scan_kernel"
EPILOGUE_KERNEL_NAME = "conv_epilogue_kernel"
# the inference convs of a forward, each one launch of the conv epilogue
# kernel: the player YOLOv8x, the puck YOLOv8s, the rink YOLOv8s-pose and
# the jersey-number reader's digit net
EPILOGUE_CONVS = {"hockey-player-detection": 103, "hockey-puck-detection": 63,
                  "hockey-detection": 72, "digits": 7}
EPILOGUE = {"launches": {}, "sites": {}}  # the main paths' launches by phase,
# and each checked forward's numbers by site
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
# phase 12: the square scenes' sizes (the shipped player model's and the
# pose model's validation sizes), their image counts (the player set
# fills one batch of 8 and pads the second, the rink set likewise), and
# the largest gap of mAP50 and PCK in bf16 from the same evaluation with
# the models in f32 on the card
VAL_PLAYER_SIZE, VAL_RINK_SIZE = 640, 512
VAL_IMAGES, VAL_RINK_IMAGES = 14, 12
VAL_TOL = 0.02
# phase 13. (a): the card's f32 step (TF32 off) against the CPU's on the
# same weights and batch: each loss component within TRAIN_LOSS_RTOL
# relative, every gradient's cosine at least TRAIN_GRAD_COS, the BN batch
# statistics within TRAIN_BN_TOL of each vector's largest magnitude (at
# least 1): two f32 convolution libraries summing in other orders (the
# CPU tests measure 1e-4 on the loss at 64 px, tests/test_torch_train_step.py).
# (b): pool sizes, steps of each path, the learning rate (a fine-tune of
# the shipped weights) and the largest drop of held-out mAP50 the steps
# may cause. (c): steps of the cold overfit
TRAIN_LOSS_RTOL, TRAIN_GRAD_COS, TRAIN_BN_TOL = 1e-3, 0.9999, 1e-3
TRAIN_POOL, TRAIN_VAL = 32, 16
TRAIN_STEPS_DEVICE, TRAIN_STEPS_HOST, TRAIN_LR = 6, 2, 0.001
TRAIN_MAP_DROP = 0.1
LEARN_SIZE, LEARN_STEPS = 320, 120
# phase 14. (a): steps of the default train CLI. (b): the JAX val CLI's
# f32 figures on its default set (50 SyntheticHockeyDataset images at 640,
# the shipped player model), which the card's must meet within VAL_TOL:
# `JAX_PLATFORMS=cpu python scripts/jax_val.py --f32 -- --cpu --json`
# (logs/torch_e2e/val/jax_cpu_f32_synthetic.json). (d), (e): the card's
# f32 step (TF32 off, forward and backward) against the CPU's: loss within
# CARD_LOSS_RTOL relative, every gradient within CARD_GRAD_TOL of the
# largest, each leaf's update (Adam's, so a leaf's own scale) within
# CARD_UPDATE_TOL of its own (L2). The embedder's forward agrees to
# 8.6e-6 of its scale, but its backward through 34 batch-statistics BNs
# (96 values each at the 2x1 maps) differs by up to 3.2e-3 of the
# largest gradient (a leaf's cosine down to 0.99978 where its gradient is
# small) and Adam's second update by 2.1e-2 (the card's first runs); the
# digit net, without BN, agrees to 3.1e-7. Steps of the short
# runs; the least rise of the embedder's pair accuracy (mean of the last
# 10 steps against the first 10) and the most the digit net's loss may
# keep of its first 10 steps' mean (CPU rehearsals: +0.13 and +0.17 over
# 60 and 80 steps; 0.64 over 150 steps; the card's first run, 60 steps:
# +0.0542)
DEFAULT_TRAIN_STEPS = 3
JAX_SYNTHETIC_F32 = {"mAP50": 0.0, "mAP50_95": 0.0}
CARD_LOSS_RTOL, CARD_GRAD_TOL, CARD_UPDATE_TOL = 1e-4, 1e-2, 5e-2
EMBED_STEPS, EMBED_ACC_RISE = 80, 0.05
DIGIT_STEPS, DIGIT_LOSS_FRAC = 150, 0.85
# phase 15. (a): random box pairs and assignment problems of the host
# runtime's checks, and the replays of phase 8's tracker inputs per route.
# (b): steps of each trainer at full width and the learning rate; the
# 1x1 mesh's step against `Trainer`'s is checked bit for bit with cuDNN's
# deterministic algorithms, else within MESH_LOSS_RTOL relative on each
# loss and MESH_PARAM_TOL of each leaf's scale (at least 1) on the
# parameters. (c), with two cards: dp 2 against (b)'s single-device steps,
# in bf16 with each rank's convolutions at half the batch: each loss within
# MULTI_LOSS_RTOL relative, the parameters within MULTI_PARAM_TOL, the
# detections matched at IoU 0.8 at least MULTI_MATCH both ways
HOST_PAIRS, HOST_LSAP, HOST_REPLAYS = 100, 1000, 5
MESH_STEPS, MESH_LR = 3, 0.001
MESH_LOSS_RTOL, MESH_PARAM_TOL = 1e-3, 1e-4
MULTI_LOSS_RTOL, MULTI_PARAM_TOL, MULTI_MATCH = 2e-2, 1e-3, 0.95


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


# the kernel's numbers at each call site timed in this run, by site name,
# for the kernel table's line
SITES = {}


def time_kernel(label, m, keep0, thr, site=None):
    """Kernel device ms, call ms, plain ms and bound on one input, printed
    on one line and returned under the kernel table's keys (and kept in
    SITES under `site` with the input's (B, K))."""
    ms, how = device_ms(lambda: suppress(m, keep0, thr))
    call_ms = time_ms(lambda: suppress(m, keep0, thr), 200)
    plain_ms = time_ms(lambda: suppress_reference(m, keep0, thr), 10)
    bound_ms, nbytes, elems = suppress_bound(suppress_reference(m, keep0, thr))
    print(f"{label}: kernel device {ms:.6f} ms per launch ({how}), call "
          f"{call_ms:.4f} ms (CUDA events, 200 back-to-back calls), plain "
          f"{plain_ms:.3f} ms, bound {bound_ms:.6f} ms ({nbytes} bytes); "
          f"library call: none (no single PyTorch op computes greedy "
          f"suppression)", flush=True)
    out = dict(ms=ms, call_ms=call_ms, plain_ms=plain_ms, bound_ms=bound_ms,
               bound_by="bytes" if nbytes / HBM_BYTES_PER_S
               >= elems / F32_OPS_PER_S else "operations")
    if site:
        SITES[site] = dict(out, shape=list(keep0.shape))
    return out


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


def rink_base(hw=FRAME_HW, hom=None) -> np.ndarray:
    """(h, w, 3) uint8 BGR, by default (1080, 1920): an NHL sheet seen
    through `hom` (default `rink_homography`), marked in numpy by the rink
    point under each pixel:
    ice, the boards' kickplate and pale boards (a rounded rectangle, 28-ft
    corners), the crowd beyond, the red centre line and blue lines (1 ft
    wide), the goal lines (4 in), the centre and end-zone faceoff circles
    (15 ft, 3-in rings) and the faceoff spots (1-ft radius)."""
    d = NHL
    h, w = hw
    v, u = np.mgrid[0:h, 0:w]
    pts = project(np.linalg.inv(rink_homography() if hom is None else hom),
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


def square_players(seed: int, n: int, s: int = VAL_PLAYER_SIZE,
                   players: int = 7, heights=(90, 200)):
    """(frames (n, s, s, 3) uint8 BGR, boxes [(P, 4)]): `_player` figures
    on a white rink with a red centre line, each frame's own players
    (`heights` px tall, drawn far to near), and each figure's box, the
    extent of its ellipses clipped to the frame."""
    rng = np.random.default_rng(seed)
    frames, boxes = np.empty((n, s, s, 3), np.uint8), []
    for t in range(n):
        f = np.full((s, s, 3), 228, np.uint8)
        f[..., 0] = 236
        f[:, s // 2 - 4:s // 2 + 4] = (40, 40, 200)
        foot = rng.uniform([60, 0.3 * s], [s - 60, s - 10], (players, 2))
        hpx = rng.uniform(*heights, players)
        b = []
        for j in np.argsort(foot[:, 1]):
            (fx, fy), hj = foot[j], hpx[j]
            _player(f, fx, fy, hj, *((200, 160, 40), (40, 40, 40)) if j % 2
                    else ((30, 30, 200), (230, 230, 230)))
            half = 0.68 * 0.42 * hj
            b.append(np.clip([fx - half, fy - 0.98 * hj, fx + half,
                              fy + 0.01 * hj], 0, s))
        frames[t] = f
        boxes.append(np.asarray(b, np.float32))
    return frames, boxes


def square_rink(seed: int, n: int, s: int = VAL_RINK_SIZE):
    """(frames (n, s, s, 3) uint8 BGR, keypoints (n, 56, 3)): `rink_base`
    through a known homography per frame (a camera above the near boards,
    its corners jittered by up to 4% of the frame), and the 56 rink
    keypoints projected through it, visible (1) inside the frame."""
    rng = np.random.default_rng(seed)
    src = np.array([[10.0, 0.0], [190.0, 0.0], [10.0, 85.0], [190.0, 85.0]])
    base = np.array([[0.12, 0.22], [0.88, 0.22], [-0.08, 0.86], [1.08, 0.86]]) * s
    table = default_keypoint_positions()
    frames, kpts = np.empty((n, s, s, 3), np.uint8), np.zeros((n, 56, 3), np.float32)
    for t in range(n):
        hom = dlt_homography(src, base + rng.uniform(-0.04, 0.04, (4, 2)) * s)
        frames[t] = rink_base((s, s), hom)
        p = project(hom, table)
        kpts[t, :, :2] = p
        kpts[t, :, 2] = (p >= 0).all(1) & (p < s).all(1)
    return frames, kpts


class Items:
    """A validation dataset over a list of items (train/data.py's keys)."""

    def __init__(self, items):
        self.items = items

    def __len__(self):
        return len(self.items)

    def load(self, i):
        return self.items[i]


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


def check_uploads(entry: str, uploads: dict) -> None:
    """Every batch of `entry`'s N_BATCHES was uploaded from page-locked
    staging (core/staging.py), none by the blocking pageable copy."""
    print(f"uploads over {entry}: {uploads['pinned_uploads']} pinned, "
          f"{uploads['pageable_uploads']} pageable", flush=True)
    if uploads != {"pinned_uploads": N_BATCHES, "pageable_uploads": 0}:
        raise AssertionError(f"{entry}: {uploads} over {N_BATCHES} batches; "
                             "every batch must be uploaded pinned")


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


_TRACK_INT_FIELDS = ("track_id", "active", "tracked", "consecutive",
                     "activated", "missed", "class_id", "next_id")
_TRACK_FLOAT_FIELDS = ("mean", "cov", "score")


def crowded_sequence(seed, k, d, n_targets=22):
    """(boxes (K, D, 4), scores, classes, valid) of a crowd: `n_targets`
    overlapping boxes a frame in a 300 x 200 px patch, each jittering by
    a few pixels and now and then swapping places with a neighbour, with
    scores in both bands, so that rows compete for columns through many
    auction rounds and the greedy fill takes what the auction leaves."""
    rng = np.random.default_rng(seed)
    boxes = np.zeros((k, d, 4), np.float32)
    scores = np.full((k, d), -1.0, np.float32)
    classes = np.zeros((k, d), np.int32)
    valid = np.zeros((k, d), bool)
    pos = rng.uniform(0, 1, (n_targets, 2)) * [300, 200] + [600, 400]
    size = rng.uniform(40, 70, (n_targets, 2)) * [1, 2]
    for f in range(k):
        pos = pos + rng.normal(0, 4, pos.shape)
        if f % 3 == 2:  # a pair of neighbours trades places
            a, b = rng.choice(n_targets, 2, replace=False)
            pos[[a, b]] = pos[[b, a]]
        n = int(rng.integers(n_targets - 2, n_targets + 1))
        rows = rng.permutation(n_targets)[:n]
        for i, j in enumerate(rows):
            x, y = pos[j]
            w, h = size[j]
            boxes[f, i] = [x, y, x + w, y + h]
            scores[f, i] = rng.choice([0.9, 0.6, 0.3, 0.15], p=[.5, .2, .2, .1])
            classes[f, i] = int(rng.random() < 0.1)
            valid[f, i] = True
    return boxes, scores, classes, valid


def tracker_bound(state: TrackState, x) -> tuple:
    """(bound ms, bytes) of one tracker launch: the state read and written
    once, the batch's detections read and its ids written once, at the
    card's memory rate (its operations, a (T, D) IoU matrix and a few
    hundred 4x4 solves a batch, take less at its f32 rate)."""
    state_bytes = sum(v.numel() * v.element_size() for v in state)
    det_bytes = sum(v.numel() * v.element_size() for v in x)
    nbytes = 2 * state_bytes + det_bytes + 4 * x[0].shape[0] * x[0].shape[1]
    return 1e3 * nbytes / HBM_BYTES_PER_S, nbytes


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit (a float's -0 and +0 differ here)."""
    ints = {2: torch.int16, 4: torch.int32}[a.element_size()]
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(ints), b.contiguous().view(ints))


def profiled_device_ms(fn, kernel=None) -> float:
    """Device ms of one call of fn() in a torch.profiler trace: the
    kernels whose name holds `kernel`, or every kernel."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA
            and (kernel is None or kernel in e.key)]
    return sum(e.self_device_time_total for e in hits) / 1e3


def gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """The largest |a - b|, in f32."""
    return float((a.float() - b.float()).abs().max())


def epilogue_check(site: str, model, x: torch.Tensor, convs: int):
    """The conv epilogue kernel (csrc/conv_epilogue.cu) on every inference
    conv of one forward of `model` on `x` (NHWC, on the card): `convs`
    launches; each conv's epilogue bit-equal to the plain sequence (bias
    add, SiLU, residual add) on the same operands; the forward with the
    kernel bit-equal to the forward with the plain epilogue and to the
    plain ops with the bias inside the conv. Returns the convs' (y before
    its epilogue, bias, act, residual) and the largest |kernel - plain|
    over the convs and the forward's maps."""
    calls = []

    def record(y, bias, act, residual=None):
        calls.append((y.clone(), bias, act, residual))
        return ce.epilogue(y, bias, act, residual)

    def forward(epilogue, routed=True):
        saved = layers.conv_epilogue, layers.on_card_inference
        layers.conv_epilogue = epilogue
        if not routed:
            layers.on_card_inference = lambda *a: False
        try:
            with torch.inference_mode():
                return forward_raw(model, x)
        finally:
            layers.conv_epilogue, layers.on_card_inference = saved

    ce.epilogue.launches = 0
    got = forward(record)
    launches = ce.epilogue.launches
    if launches != convs or len(calls) != convs:
        raise AssertionError(f"{site}: {launches} epilogue launches and "
                             f"{len(calls)} convs a forward, not {convs}")
    err = 0.0
    for i, (y, bias, act, r) in enumerate(calls):
        with torch.inference_mode():
            k = ce.epilogue(y.clone(), bias, act, r)
            p = ce.conv_epilogue_reference(y.clone(), bias, act, r)
        err = max(err, gap(k, p))
        if not bits_equal(k, p):
            raise AssertionError(f"{site}: conv {i} {tuple(y.shape)}: kernel != plain")
    plain = forward(ce.conv_epilogue_reference)
    replaced = forward(None, routed=False)
    for key, maps in got.items():
        for a, b, c in zip(maps, plain[key], replaced[key]):
            err = max(err, gap(a, b), gap(a, c))
            if not (bits_equal(a, b) and bits_equal(a, c)):
                raise AssertionError(f"{site}: forward {key}: kernel != plain epilogue")
    print(f"{site}: {len(calls)} conv epilogues at {tuple(x.shape)} bit-equal to "
          "the plain sequence; the forward bit-equal to the plain epilogue and to "
          f"the bias inside the conv: True (largest gap {err})", flush=True)
    return calls, err


def count_epilogue(site: str, want: int) -> None:
    """Holds the conv epilogue's launches since the last reset to `want`
    (the convs of the main path's forwards) and records them."""
    n = ce.epilogue.launches
    print(f"conv_epilogue launches over the {site} path: {n}", flush=True)
    if n != want:
        raise AssertionError(f"the epilogue kernel launched {n} times over the "
                             f"{site} path, not {want} (one a conv of each forward)")
    EPILOGUE["launches"][site] = n


def epilogue_site(site: str, model, x: torch.Tensor, convs: int) -> None:
    """`epilogue_check` at a site of a later phase; records its numbers."""
    calls, err = epilogue_check(site, model, x, convs)
    EPILOGUE["sites"][site] = {
        "convs": len(calls), "input": list(x.shape), "max_abs_err": err,
        "vector_launches": sum(ce.vectorized(y, b, r, ce.check(y, b, r))
                               for y, b, _, r in calls)}


def epilogue_phase(det, frames) -> dict:
    """Phase 4b: `epilogue_check` on one YOLOv8x forward at the detect
    cell's shapes (a batch of 8 1080p frames at 736x1280); the `forward`
    range's device ms against the sum of its kernels (the kernel's
    launches must be linked to the range). Three times each: the kernel's
    device ms a batch, and the plain sequence's (`library_ms`, PyTorch's
    own bias add, SiLU and residual add); the bound: the bytes over the
    card's memory rate."""
    x = letterbox_rect_batch(torch.as_tensor(frames[-BATCH:]).to("cuda"),
                             det.imgsz, 32, torch.bfloat16)
    calls, err = epilogue_check("detect", det.model, x,
                                EPILOGUE_CONVS["hockey-player-detection"])

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.inference_mode(), record_function("forward"):
            forward_raw(det.model, x)
        torch.cuda.synchronize()
    averages = prof.key_averages()
    range_ms = sum(e.device_time_total for e in averages
                   if e.key == "forward" and e.device_type == DeviceType.CPU) / 1e3
    kernels_ms = sum(e.self_device_time_total for e in averages  # the range's
                     if e.device_type == DeviceType.CUDA  # own span on the
                     and e.key != "forward") / 1e3  # device is no kernel
    epi_ms = sum(e.self_device_time_total for e in averages
                 if e.device_type == DeviceType.CUDA
                 and EPILOGUE_KERNEL_NAME in e.key) / 1e3

    def run_all(fn):
        ys = [y.clone() for y, *_ in calls]
        torch.cuda.synchronize()

        def go():
            with torch.inference_mode():
                for y, (_, bias, act, r) in zip(ys, calls):
                    fn(y, bias, act, r)
        return go

    kernel_ms, library_ms = [], []
    for _ in range(3):
        kernel_ms.append(profiled_device_ms(run_all(ce.epilogue), EPILOGUE_KERNEL_NAME))
        library_ms.append(profiled_device_ms(run_all(ce.conv_epilogue_reference)))
    nbytes = sum(ce.bound_bytes(y, bias, r) for y, bias, _, r in calls)
    out = {
        "convs": len(calls),
        "max_abs_err": err,
        "vector_launches": sum(ce.vectorized(y, b, r, ce.check(y, b, r))
                               for y, b, _, r in calls),
        "ms": [round(v, 4) for v in kernel_ms],
        "library_ms": [round(v, 4) for v in library_ms],
        "bound_ms": round(1e3 * nbytes / HBM_BYTES_PER_S, 4),
        "bytes": nbytes,
        "forward_range_ms": round(range_ms, 4),
        "forward_kernels_ms": round(kernels_ms, 4),
        "forward_epilogue_ms": round(epi_ms, 4),
        "epilogue_in_range": abs(range_ms - kernels_ms) < 0.5 * epi_ms,
    }
    print(f"epilogue a batch of {BATCH} at 736x1280: kernel {out['ms']} ms, "
          f"plain sequence (library) {out['library_ms']} ms, bound "
          f"{out['bound_ms']} ms ({nbytes} bytes); forward range "
          f"{out['forward_range_ms']} ms of device time against its kernels' "
          f"{out['forward_kernels_ms']} ms (epilogue {out['forward_epilogue_ms']} ms, "
          f"in the range: {out['epilogue_in_range']})", flush=True)
    print(json.dumps({"conv_epilogue": out}), flush=True)
    if not out["epilogue_in_range"]:
        raise AssertionError("the epilogue's launches are not linked to the "
                             "`forward` range")
    EPILOGUE["sites"]["detect"] = out
    return out


def tracker_kernel_phase(inputs, kwargs, capacity: int) -> dict:
    """Phase 5b: the tracker's kernel against the plain version on the
    card, on `inputs` (phase 5's detections) and on a crowd; returns the
    numbers of each (`max_abs_err`: the largest gap of mean, cov and
    score over every batch), and prints them as one JSON line."""
    dev = torch.device("cuda")
    n = sum(x[0].shape[0] for x in inputs)
    crowd = [tuple(torch.from_numpy(v[s:s + BATCH]).to(dev) for v in data)
             for data in [crowded_sequence(0, n, inputs[0][0].shape[1])]
             for s in range(0, n, BATCH)]
    stages = 3 if kwargs.get("lost_reacquire_floor", 0.0) > 0.0 else 2
    out = {}
    for name, batches in (("main", inputs), ("crowd", crowd)):
        st = assignment.stats
        st.syncs = st.rounds = st.fill_steps = 0
        scan_kernel.reset()
        ks = ps = init_state(capacity, dev)
        live = None  # the state before the second batch, for the timing
        err = 0.0
        with torch.inference_mode():
            for b, x in enumerate(batches):
                if b == 1:
                    live = ks
                ks, kt = tracker_scan(ks, *x, **kwargs)
                ps, pt = tracker_scan_reference(ps, *x, **kwargs)
                same = torch.equal(kt, pt) and all(
                    torch.equal(getattr(ks, f), getattr(ps, f))
                    for f in _TRACK_INT_FIELDS)
                if not same:
                    raise AssertionError(f"{name}, batch {b}: the tracker "
                                         "kernel differs from the plain version")
                for f in _TRACK_FLOAT_FIELDS:
                    got, want = getattr(ks, f), getattr(ps, f)
                    err = max(err, (got - want).abs().max().item())
                    if not torch.allclose(got, want, rtol=1e-5, atol=1e-4):
                        raise AssertionError(
                            f"{name}, batch {b}: the kernel's {f} is off the "
                            "plain version's by more than rtol 1e-5, atol 1e-4")
        counts = scan_kernel.counts(dev)
        launches = scan_kernel.launches
        if counts != {"rounds": st.rounds, "fill_steps": st.fill_steps}:
            raise AssertionError(f"{name}: kernel counts {counts}, plain "
                                 f"rounds {st.rounds} fill {st.fill_steps}")
        if launches != len(batches):
            raise AssertionError(f"{name}: {launches} launches for "
                                 f"{len(batches)} batches")
        assoc = stages * n
        x = batches[1]
        with torch.inference_mode():
            def kernel():
                return tracker_scan(live, *x, **kwargs)

            def plain():
                return tracker_scan_reference(live, *x, **kwargs)

            ms, how = device_ms(kernel, kernel=TRACKER_KERNEL_NAME)
            call_ms = time_ms(kernel, 200)
            plain_ms = time_ms(plain, 5)
        bound_ms, nbytes = tracker_bound(live, x)
        out[name] = dict(
            ms=ms, how=how, call_ms=call_ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by="bytes", bytes=nbytes,
            shape=[x[0].shape[0], capacity, x[0].shape[1]],
            launches=launches, frames=n,
            rounds_per_association=counts["rounds"] / assoc,
            fill_steps_per_association=counts["fill_steps"] / assoc,
            plain_host_syncs_per_batch=st.syncs / len(batches),
            ids_equal=True, max_abs_err=err)
        print(f"tracker kernel, {name} (B={BATCH}, T={capacity}, "
              f"D={x[0].shape[1]}): ids and integer fields == plain on "
              f"{len(batches)} batches, mean, cov and score within "
              f"{err:.3g}; device {ms:.4f} ms per launch ({how}), "
              f"call {call_ms:.4f} ms, plain {plain_ms:.3f} ms per batch on "
              f"the card, bound {bound_ms:.6f} ms ({nbytes} bytes); rounds "
              f"{counts['rounds'] / assoc:.2f} and fill steps "
              f"{counts['fill_steps'] / assoc:.2f} per association", flush=True)
    print(json.dumps({"tracker_kernel": out}), flush=True)
    return out


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
    ce.epilogue.launches = 0
    results, marks = [], []
    t = time.perf_counter()
    for r in vp.puck_frames(iter(frames)):
        results.append(r)
        if len(results) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_p = suppress.launches
    count_epilogue("puck", EPILOGUE_CONVS[config.puck_model_name] * N_BATCHES)
    tiles = sd.tiles(torch.as_tensor(frames[-BATCH:]).to("cuda"))
    epilogue_site("puck", sd.detector.model,
                  letterbox_rect_batch(tiles, sd.detector.imgsz, 32, torch.bfloat16),
                  EPILOGUE_CONVS[config.puck_model_name])
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
        cand.matrix, cand.keep0, cand.thr, site="puck_tile")}
    sites["merge"] = time_kernel(
        f"puck merge B={mc.keep0.shape[0]} K={mc.keep0.shape[1]}",
        mc.matrix, mc.keep0, mc.thr, site="puck_merge")

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
    """Phase 6; returns (kernel launches over classify_frames, max_err, the
    detector with the team branch, the tracker kernel's launches over
    classify_frames). `track_fps` is phase 5's frames/s, printed beside
    this path's."""
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
    ce.epilogue.launches = 0
    scan_kernel.reset()
    results, outs, marks = [], [], []
    t = time.perf_counter()
    for r in vp.classify_frames(iter(frames)):
        results.append(r)
        if len(results) % BATCH == 1:  # the batch's step has just run
            outs.append(vp.last_track_batch)
        if len(results) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_c = suppress.launches
    count_epilogue("classify", EPILOGUE_CONVS[config.player_model_name] * N_BATCHES)
    tracker_launches_c = scan_kernel.launches
    if tracker_launches_c != N_BATCHES:
        raise AssertionError(f"the tracker kernel launched {tracker_launches_c} "
                             f"times over {N_BATCHES} batches of classify_frames")
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
    return launches_c, max_err, det, tracker_launches_c


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
    detector's call, max_err, each frame's host ByteTrack inputs)."""
    frames = rink_scene(seed=0, n=BATCH * N_BATCHES)
    h_true = np.linalg.inv(rink_homography())  # image -> rink
    t = time.perf_counter()
    vp = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                        mode=ProcessingMode.TEAM_CLASSIFICATION,
                        show_2d_map=True, team_names=("TEAM_A", "TEAM_B"))
    dual = vp.player_detector
    print(f"dual step ready in {time.perf_counter() - t:.2f} s: player "
          f"{dual.player.core.in_hw} {dual.player.dtype}, rink "
          f"{dual.step.rink_imgsz} square, "
          f"tracker {type(vp.tracker).__name__}", flush=True)
    if not (vp.use_dual and isinstance(dual, DualDetector)
            and dual.with_team_features and not vp.use_fused_tracker
            and isinstance(vp.tracker, ByteTrack)):
        raise AssertionError("TEAM_CLASSIFICATION with the 2D map did not take "
                             "the dual step and the host ByteTrack")
    crops = vp.fit_teams(iter(frames))

    outs = []  # (the dual step's HostBatch, keypoints) of each batch
    fetch_batch = dual.fetch_batch

    def recording(batch):
        host = fetch_batch(batch)
        outs.append((host, dual.last_keypoints))
        return host

    dual.fetch_batch = recording
    track_inputs = []  # each frame's (boxes, scores, classes) for phase 15
    update = vp.tracker.update

    def recording_update(*args):
        track_inputs.append(tuple(np.array(a, copy=True) for a in args))
        return update(*args)

    vp.tracker.update = recording_update
    vp.timers.reset()
    suppress.launches = 0
    ce.epilogue.launches = 0
    results, hs, marks = [], [], []
    t = time.perf_counter()
    for r in vp.classify_frames(iter(frames)):
        results.append(r)
        h = vp.calibrator.stabilizer.current
        hs.append(None if h is None else h.copy())
        if len(results) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_d = suppress.launches
    count_epilogue("dual", N_BATCHES * (EPILOGUE_CONVS[config.player_model_name]
                                        + EPILOGUE_CONVS[config.hockey_model_name]))
    epilogue_site("pose", dual.rink_model,
                  letterbox_batch(torch.as_tensor(frames[-BATCH:]).to("cuda"),
                                  dual.step.rink_imgsz, dual.player.dtype),
                  EPILOGUE_CONVS[config.hockey_model_name])
    dual.fetch_batch = fetch_batch
    vp.tracker.update = update
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
        if out.feats.shape != (BATCH, dual.player.max_det, 4):
            raise AssertionError("no team features from the dual step")
    if not calibrated:
        raise AssertionError("the calibrator never produced a homography")
    if any(not np.isfinite(r["boxes"]).all() for r in results):
        raise AssertionError("non-finite tracked boxes")

    # the kernel at the player branch on the last batch: the plain
    # suppression's kept set, and the halves give the run's detections
    last = torch.as_tensor(frames[-BATCH:]).to("cuda")
    core = dual.player.core
    with torch.inference_mode():
        cand = core.candidates(dual.player.model, last)
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
        again = core.finish(cand, keep_k)
    torch.cuda.synchronize()
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()))
    if not torch.equal(keep_k, keep_r):
        raise AssertionError("dual-path kept sets differ from the plain version")
    run_det = outs[-1][0]
    if not all(np.array_equal(getattr(again, f).cpu().numpy(), getattr(run_det, f))
               for f in ("boxes", "scores", "classes", "valid")):
        raise AssertionError("the dual core's halves differ from the run's "
                             "last batch")
    print(f"dual-path NMS, last batch: kept {keep_k.sum(1).tolist()} of "
          f"{cand.keep0.sum(1).tolist()}; kernel kept set == plain kept set, "
          f"halves == the run: True", flush=True)
    sites = {"dual": time_kernel(
        f"dual player branch NMS B={cand.keep0.shape[0]} K={cand.keep0.shape[1]}",
        cand.matrix, cand.keep0, cand.thr, site="dual")}

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
        cand_r.matrix, cand_r.keep0, cand_r.thr, site="rink_detector")

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
    return launches_d + launches_r, max_err, track_inputs


def kernel_on_batch(label, core, model, x, max_err, site=None):
    """The kernel against the plain suppression on one batch's candidates
    of `core` (kept sets equal, else it raises); with `site`, its times
    there. Returns max_err."""
    with torch.inference_mode():
        cand = core.candidates(model, torch.as_tensor(x).to("cuda"))
        keep_k = suppress(cand.matrix, cand.keep0, cand.thr)
        keep_r = suppress_reference(cand.matrix, cand.keep0, cand.thr)
    torch.cuda.synchronize()
    max_err = max(max_err, float((keep_k.int() - keep_r.int()).abs().max()))
    same = torch.equal(keep_k, keep_r)
    print(f"{label} NMS B={cand.keep0.shape[0]} K={cand.keep0.shape[1]}: kept "
          f"{keep_k.sum(1).tolist()} of {cand.keep0.sum(1).tolist()}; kernel "
          f"kept set == plain kept set: {same}", flush=True)
    if not same:
        raise AssertionError(f"{label}: kept sets differ from the plain version")
    if site:
        time_kernel(f"{label} NMS B={cand.keep0.shape[0]} K={cand.keep0.shape[1]}",
                    cand.matrix, cand.keep0, cand.thr, site=site)
    return max_err


def kernels_device_ms(fn, calls: int = 10) -> float:
    """Device ms per call of fn: the sum of all its CUDA kernels' device
    time in a torch.profiler trace of `calls` calls."""
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA) / 1e3 / calls


def robust_teams(clf, feats):
    """The robust classifier's nearest fitted crop's team of each row of
    `feats` (its assignment before the outlier gate and the history)."""
    r = clf.reduce(feats)
    d2 = ((r[:, None, :] - clf._train_reduced[None]) ** 2).sum(-1)
    return clf._train_labels[d2.argmin(1)]


def cascade_phase(config, frames, det, max_err):
    """Phase 9; returns (kernel launches over classify_frames, max_err)."""
    os.environ["HOCKEY_TPU_HEADLESS"] = "1"  # no click UI: interactive demotes
    # the fit reads frames 0-20 of the scene, 210 crops
    cfg = dataclasses.replace(config, initialization_stride=1)
    cpu_net = build_embedder(load_embed_params(), "cpu")
    cascade, launches = {}, 0
    for want, flags, cpu_cls in (
            ("robust", dict(use_segmentation=False), RobustTeamClassifier),
            ("hybrid", dict(use_segmentation=False, use_robust=False),
             HybridTeamClassifier)):
        vp = VideoProcessor(cfg, device="cuda", frame_hw=FRAME_HW,
                            mode=ProcessingMode.TEAM_CLASSIFICATION,
                            team_names=("TEAM_A", "TEAM_B"), player_detector=det)
        tc = vp.team_classifier = TeamClassifier(device="cuda", **flags)
        first = tc.active_strategy
        fitted = {}
        facade_fit = tc.fit

        def timed_fit(crops, positions=None, frame=None, detections=None):
            t0 = time.perf_counter()
            facade_fit(crops, positions=positions, frame=frame, detections=detections)
            fitted.update(s=time.perf_counter() - t0, crops=crops)

        tc.fit = timed_fit
        t = time.perf_counter()
        n_crops = vp.fit_teams(iter(frames))
        fit_s = time.perf_counter() - t
        print(f"{want}: strategy {first} -> {tc.active_strategy} after fit_teams; "
              f"{n_crops} crops; fit_teams {fit_s:.3f} s, the facade's fit "
              f"{fitted['s']:.3f} s (host clock)", flush=True)
        if tc.active_strategy != want:
            raise AssertionError(f"the cascade landed on {tc.active_strategy}, "
                                 f"not {want}")
        impl = tc._impl
        suppress.launches = 0
        results, marks = [], []
        t = time.perf_counter()
        for r in vp.classify_frames(iter(frames)):
            results.append(r)
            if len(results) % BATCH == 0:
                marks.append(time.perf_counter())
        launches_k = suppress.launches
        launches += launches_k
        fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
        print(f"{want}: classify_frames {fps:.2f} frames/s after the first batch; "
              f"strategy after it: {tc.active_strategy}; {launches_k} kernel "
              f"launches", flush=True)
        if tc.active_strategy != want or len(results) != len(frames):
            raise AssertionError(f"{want} did not classify every frame itself")
        if launches_k < N_BATCHES:
            raise AssertionError(f"kernel launched {launches_k} times, < {N_BATCHES}")
        max_err = kernel_on_batch(f"{want} path", det._track_step.core, det.model,
                                  frames[-BATCH:], max_err)

        # MobileNetV3 on the card (f32) against the CPU on the last
        # batch's players, and the teams from either side's features
        boxes = [r["boxes"][r["classes"] == 0] for r in results[-BATCH:]]
        crops = np.concatenate([standardize_crops(host_crops(f, b))
                                for f, b in zip(frames[-BATCH:], boxes)])
        positions = [p for b in boxes for p in VideoProcessor._positions(b)]
        z_card = embed(impl.net, torch.from_numpy(crops).cuda()).cpu().numpy()
        z_cpu = embed(cpu_net, torch.from_numpy(crops)).numpy()
        cos = (z_card * z_cpu).sum(1) / np.linalg.norm(z_card, axis=1) \
            / np.linalg.norm(z_cpu, axis=1)
        embed_err = float(np.abs(z_card - z_cpu).max())
        cpu_clf = cpu_cls(device="cpu")
        if want == "robust":
            f_card = impl.extract_multimodal_features(crops, positions)
            f_cpu = cpu_clf.extract_multimodal_features(crops, positions)
            ids_card, ids_cpu = robust_teams(impl, f_card), robust_teams(impl, f_cpu)
        else:
            f_card, f_cpu = impl.extract_all_features(crops), cpu_clf.extract_all_features(crops)
            ids_card, ids_cpu = impl.classify_features(f_card), impl.classify_features(f_cpu)
        feat_err = float(np.abs(f_card - f_cpu).max())
        print(f"{want}: MobileNetV3 card f32 vs CPU on {len(crops)} crops: min "
              f"cosine {cos.min():.7f} (>= 0.9999), max |diff| {embed_err:.3e}; "
              f"features max |diff| {feat_err:.3e}; team ids equal: "
              f"{bool((ids_card == ids_cpu).all())}", flush=True)
        if cos.min() < 0.9999:
            raise AssertionError("card embeddings disagree with the CPU")
        if not (ids_card == ids_cpu).all():
            raise AssertionError("team ids from card and CPU features differ")
        acc, separable, n_pairs = team_accuracy(results, seed=0)
        print(f"{want}: team accuracy against the generator's teams {acc:.4f} "
              f"over {n_pairs} matched players (separable: {separable})", flush=True)

        # the embed's device time for the fit's crops and for one frame's
        fit_batch = torch.from_numpy(standardize_crops(fitted["crops"])).cuda()
        frame_batch = torch.from_numpy(crops[:len(boxes[0])]).cuda()
        ms = {n: (kernels_device_ms(lambda x=x: embed(impl.net, x)),
                  time_ms(lambda x=x: embed(impl.net, x), 10))
              for n, x in (("fit", fit_batch), ("frame", frame_batch))}
        print(f"{want}: embed device ms (profiler, all kernels) / call ms (CUDA "
              f"events): {len(fit_batch)} crops {ms['fit'][0]:.4f} / "
              f"{ms['fit'][1]:.4f}; {len(frame_batch)} crops {ms['frame'][0]:.4f} "
              f"/ {ms['frame'][1]:.4f}", flush=True)
        cascade[want] = {
            "strategies": [first, tc.active_strategy],
            "fit_crops": n_crops, "fit_teams_s": round(fit_s, 3),
            "facade_fit_s": round(fitted["s"], 3),
            "frames_per_s_after_first_batch": round(fps, 2),
            "team_accuracy": round(acc, 4), "matched_players": n_pairs,
            "embed_min_cosine": float(cos.min()), "embed_max_abs_err": embed_err,
            "feature_max_abs_err": feat_err,
            "embed_device_ms": {len(fit_batch): round(ms["fit"][0], 4),
                                len(frame_batch): round(ms["frame"][0], 4)},
            "embed_call_ms": {len(fit_batch): round(ms["fit"][1], 4),
                              len(frame_batch): round(ms["frame"][1], 4)},
        }
    print(json.dumps({"cascade": cascade}), flush=True)
    return launches, max_err


def lockstep_and_alone(cfg, det, clips):
    """The clips through MultiClipProcessor.run_frames with `det`, and each
    clip alone through a single-clip VideoProcessor with `det`: (per-clip
    lockstep results, per-clip tracked rows alone, lockstep frames/s over
    all clips, the same after the first row, kernel launches in lockstep)."""
    k = len(clips)
    mp = MultiClipProcessor(config=cfg, mode=ProcessingMode.PLAYER_TRACKING,
                            player_detector=det, device="cuda",
                            frame_hw=FRAME_HW, n_clips=k)
    suppress.launches = 0
    got = {c: [] for c in range(k)}
    marks = []
    t = time.perf_counter()
    for c, r in mp.run_frames(clips):
        got[c].append({f: np.copy(v) for f, v in r.items()})
        if c == k - 1:
            marks.append(time.perf_counter())
    launches = suppress.launches
    fps = k * len(marks) / (marks[-1] - t)
    fps_after = k * (len(marks) - 1) / (marks[-1] - marks[0])
    alone = [list(VideoProcessor(cfg, device="cuda", frame_hw=FRAME_HW,
                                 mode=ProcessingMode.PLAYER_TRACKING,
                                 player_detector=det).track_frames(iter(clip)))
             for clip in clips]
    return got, alone, fps, fps_after, launches


def compare_clips(got, alone):
    """(frames whose ids are equal, frames, max |box diff| px over the
    frames whose ids are equal)."""
    same, total, worst = 0, 0, 0.0
    for c, rows in enumerate(alone):
        for g, a in zip(got[c], rows, strict=True):
            total += 1
            if np.array_equal(g["tracker_ids"], a[3]):
                same += 1
                worst = max(worst, float(np.abs(g["boxes"] - a[0]).max(initial=0.0)))
    return same, total, worst


def multiclip_phase(config, det, max_err):
    """Phase 10; returns (kernel launches over run_frames, max_err)."""
    k = MULTICLIP_K
    clips = [synthetic_frames(seed=1 + c, n=2 * BATCH) for c in range(k)]
    # both runs take the route a single-clip VideoProcessor takes with a
    # batch of K: detection batches of B = K, then the host ByteTrack
    cfg = dataclasses.replace(config, use_device_tracker=False, frame_batch=k)
    got, alone, fps, fps_after, launches_m = lockstep_and_alone(cfg, det, clips)
    rows = len(got[0])
    print(f"{k} clips x {rows} frames in lockstep (bf16): {fps:.2f} frames/s "
          f"over all clips, {fps_after:.2f} after the first row; {launches_m} "
          f"kernel launches", flush=True)
    if launches_m != rows or rows != 2 * BATCH:
        raise AssertionError(f"{launches_m} launches over {rows} rows")
    tracked = [sum(len(r["tracker_ids"]) for r in got[c]) for c in range(k)]
    if min(tracked) == 0:
        raise AssertionError(f"tracked detections per clip {tracked}")
    max_err = kernel_on_batch("multi-clip row", det.core, det.model,
                              np.stack([c[-1] for c in clips]), max_err,
                              site="multiclip")
    same16, total, worst16 = compare_clips(got, alone)
    print(f"bf16, each clip in lockstep against the clip alone (same detector, "
          f"B = {k}): ids equal on {same16} of {total} frames, boxes max |diff| "
          f"{worst16} px; a bf16 sample's convolutions round by its position "
          f"in the batch, which differs between the two runs", flush=True)
    # the equality check: the same runs with the detector in f32
    det32 = Detector(config.player_model_name, config, frame_hw=FRAME_HW,
                     device="cuda", dtype=torch.float32)
    got32, alone32, _, _, _ = lockstep_and_alone(cfg, det32, clips)
    same32, total32, worst32 = compare_clips(got32, alone32)
    print(f"f32, the same comparison: ids equal on {same32} of {total32} frames, "
          f"boxes max |diff| {worst32} px (tolerance {MULTICLIP_BOX_PX})", flush=True)
    if same32 != total32 or worst32 > MULTICLIP_BOX_PX:
        raise AssertionError("a clip in lockstep differs from the clip alone")
    del det32
    print(json.dumps({"multiclip": {
        "clips": k, "frames_per_clip": rows,
        "frames_per_s_all_clips": round(fps, 2),
        "frames_per_s_after_first_row": round(fps_after, 2),
        "kernel_launches": launches_m, "tracked_per_clip": tracked,
        "bf16_frames_ids_equal_alone": [same16, total],
        "bf16_box_max_abs_diff_alone": worst16,
        "f32_frames_ids_equal_alone": [same32, total32],
        "f32_box_max_abs_diff_alone": worst32,
        "kernel_at_multiclip_site": SITES["multiclip"]}}), flush=True)
    return launches_m, max_err


def session_phase(config, det, max_err):
    """Phase 11; returns (kernel launches over the saved and the resumed
    runs, max_err)."""
    frames = synthetic_frames(seed=0, n=4 * BATCH)

    def processor():
        return VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                              mode=ProcessingMode.TEAM_CLASSIFICATION,
                              team_names=("TEAM_A", "TEAM_B"), player_detector=det)

    def run(vp, x):
        return [{f: np.copy(v) for f, v in r.items()}
                for r in vp.classify_frames(iter(x))]

    full_vp = processor()
    full_vp.fit_teams(iter(frames))
    full = run(full_vp, frames)
    half = 2 * BATCH
    saved_vp = processor()
    saved_vp.fit_teams(iter(frames))
    suppress.launches = 0
    first = run(saved_vp, frames[:half])
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "run.state")
        t = time.perf_counter()
        save_run_state(path, saved_vp, half)
        save_ms = 1e3 * (time.perf_counter() - t)
        size = os.path.getsize(path)
        resumed_vp = processor()
        t = time.perf_counter()
        start = load_run_state(path, resumed_vp)
        load_ms = 1e3 * (time.perf_counter() - t)
    rest = run(resumed_vp, frames[start:])
    launches_s = suppress.launches
    if not (resumed_vp.use_fused_tracker
            and isinstance(resumed_vp.tracker, DeviceByteTrack)):
        raise AssertionError("the resumed run did not take the fused tracker")
    batches = len(frames) // config.resolved_frame_batch(resumed_vp.device)
    if launches_s != batches:  # one per batch of the fused step
        raise AssertionError(f"kernel launched {launches_s} times, not {batches}")
    for f, (g, w) in enumerate(zip(first + rest, full, strict=True)):
        for key in ("tracker_ids", "team_ids", "boxes"):
            if not np.array_equal(g[key], w[key]):
                raise AssertionError(f"frame {f}: {key} after resume differ from "
                                     "the uninterrupted run")
    print(f"session: saved at frame {half} ({size} bytes, {save_ms:.2f} ms), "
          f"loaded ({load_ms:.2f} ms) into a fresh processor; frames {start}-"
          f"{len(frames) - 1} resumed; tracker ids, team ids and boxes == the "
          f"uninterrupted run on all {len(frames)} frames: True; {launches_s} "
          f"kernel launches", flush=True)
    print(json.dumps({"session": {
        "frames": len(frames), "saved_at": half, "state_bytes": size,
        "save_ms": round(save_ms, 2), "load_ms": round(load_ms, 2),
        "kernel_launches": launches_s}}), flush=True)
    return launches_s, max_err


def validation_phase(config, max_err):
    """Phase 12; returns (kernel launches over the three evaluations,
    max_err)."""
    s, rs = VAL_PLAYER_SIZE, VAL_RINK_SIZE
    frames, boxes = square_players(seed=5, n=VAL_IMAGES, s=s)
    players = Items([dict(zip(("boxes", "classes", "mask"), pad_targets(
        b, np.zeros(len(b), np.int32))), images=f.astype(np.float32) / 255.0)
        for f, b in zip(frames, boxes)])
    rframes, rkpts = square_rink(seed=6, n=VAL_RINK_IMAGES, s=rs)
    rink = Items([{"images": f.astype(np.float32) / 255.0, "keypoints": k[None]}
                  for f, k in zip(rframes, rkpts)])
    pad = np.concatenate([frames[BATCH:], np.repeat(
        frames[-1:], 2 * BATCH - VAL_IMAGES, 0)])         # the padded tail
    rpad = np.concatenate([rframes[BATCH:], np.repeat(
        rframes[-1:], 2 * BATCH - VAL_RINK_IMAGES, 0)])
    cfg, rcfg = MODEL_ZOO[config.player_model_name], MODEL_ZOO[config.hockey_model_name]
    unfused = build_model(cfg, load_params(shipped_weights_path(
        config.player_model_name))).to("cuda")
    runfused = build_model(rcfg, load_params(shipped_weights_path(
        config.hockey_model_name))).to("cuda")

    def run(fn, n):
        """(metrics, kernel launches, images/s) of a first run of fn, and
        images/s of a second."""
        suppress.launches = 0
        t = time.perf_counter()
        m = fn()
        torch.cuda.synchronize()
        cold, launches = n / (time.perf_counter() - t), suppress.launches
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return m, launches, cold, n / (time.perf_counter() - t)

    out, launches_v = {}, 0
    idx = range(VAL_IMAGES)
    for dtype, tag in ((torch.bfloat16, "bf16"), (torch.float32, "f32")):
        det = Detector(config.player_model_name, config, frame_hw=(s, s), imgsz=s,
                       conf=0.001, device="cuda", dtype=dtype)
        tev = InTrainingEvaluator(cfg, s, device="cuda", dtype=dtype)
        pev = InTrainingPoseEvaluator(rcfg, rs, device="cuda", dtype=dtype)
        before = {k: v.clone() for k, v in unfused.state_dict().items()}
        res = {"val": run(lambda: evaluate_detector(det, players, idx), VAL_IMAGES),
               "train_eval": run(lambda: tev.evaluate(unfused, players, idx),
                                 VAL_IMAGES),
               "pose_eval": run(lambda: pev.evaluate(runfused, rink,
                                                     range(VAL_RINK_IMAGES)),
                                VAL_RINK_IMAGES)}
        after = unfused.state_dict()
        if not (after.keys() == before.keys() and any(".bn." in k for k in after)
                and all(torch.equal(before[k], after[k]) for k in before)):
            raise AssertionError("an evaluator changed the caller's model")
        for site, (m, n, cold, warm) in res.items():
            if n != 2:  # one launch per batch of 8, the tail padded
                raise AssertionError(f"{site} ({tag}): {n} kernel launches, not 2")
            launches_v += n if tag == "bf16" else 0
            out.setdefault(site, {})[tag] = dict(  # no ground truth: None
                {k: round(v, 4) if np.isfinite(v) else None for k, v in m.items()},
                images_per_s_first_run=round(cold, 2), images_per_s=round(warm, 2))
        print(f"validation {tag}: " + "; ".join(
            f"{site} {out[site][tag]}" for site in res), flush=True)
        if tag == "bf16":
            # the kernel against the plain suppression on each site's last
            # (padded) batch, and its times there
            with torch.inference_mode():
                cand = det.core.candidates(det.model, torch.as_tensor(pad).cuda())
            out["val_candidates_above_conf"] = cand.keep0.sum(1).tolist()
            max_err = kernel_on_batch("val (evaluate_detector, conf 0.001)",
                                      det.core, det.model, pad, max_err, site="val")
            max_err = kernel_on_batch("train_eval (InTrainingEvaluator)", tev.core,
                                      inference_copy(unfused, tev.device, dtype),
                                      pad, max_err, site="train_eval")
            max_err = kernel_on_batch("pose_eval (InTrainingPoseEvaluator)", pev.core,
                                      inference_copy(runfused, pev.device, dtype),
                                      rpad, max_err, site="pose_eval")
            shapes = [SITES[k]["shape"] for k in ("val", "train_eval", "pose_eval")]
            if shapes != [[BATCH, 256], [BATCH, 384], [BATCH, 64]]:
                raise AssertionError(f"site shapes {shapes}")
        del det, tev, pev
    gap = {site: round(abs(out[site]["bf16"][k] - out[site]["f32"][k]), 6)
           for site, k in (("val", "mAP50"), ("train_eval", "mAP50"),
                           ("pose_eval", "pck"))}
    print(f"bf16 against f32 on the card: |gap| {gap} (tolerance {VAL_TOL}); "
          f"mean keypoint error bf16 {out['pose_eval']['bf16']['mean_kpt_error_px']} "
          f"px, f32 {out['pose_eval']['f32']['mean_kpt_error_px']} px", flush=True)
    if max(gap.values()) > VAL_TOL:
        raise AssertionError("bf16 validation disagrees with f32")
    for site, k in (("val", "mAP50"), ("train_eval", "mAP50"), ("pose_eval", "pck")):
        if not out[site]["f32"][k] > 0.1:  # a box or keypoint un-mapping fault
            raise AssertionError(f"{site}: {k} {out[site]['f32'][k]}")
    out.update(bf16_f32_gap=gap, kernel_launches=launches_v,
               kernel_at_sites={k: SITES[k] for k in ("val", "train_eval", "pose_eval")})
    print(json.dumps({"validation": out}), flush=True)
    return launches_v, max_err


# --------------------------------------------------------------------------
# phase 13: training

def write_pool(path, frames, boxes, keypoints=None):
    """A pool .npz in the `save_cache` format (class 0 for every box)."""
    counts = np.asarray([len(b) for b in boxes], np.int32)
    m = int(counts.max())
    bx = np.zeros((len(frames), m, 4), np.float32)
    for i, b in enumerate(boxes):
        bx[i, :len(b)] = b
    extra = {} if keypoints is None else {"keypoints": keypoints}
    np.savez(path, images=frames, boxes=bx, classes=np.zeros(bx.shape[:2], np.int32),
             counts=counts, **extra)


def rink_boxes(kpts, s):
    """Each rink view's box: the extent of its visible keypoints
    (hockey_tpu data.py SyntheticRinkDataset)."""
    out = []
    for k in kpts:
        v = k[k[:, 2] > 0, :2]
        out.append(np.asarray([[max(v[:, 0].min(), 0), max(v[:, 1].min(), 0),
                                min(v[:, 0].max(), s - 1), min(v[:, 1].max(), s - 1)]],
                              np.float32))
    return out


def batch_of(frames, boxes, device):
    rows = [pad_targets(b, np.zeros(len(b), np.int32)) for b in boxes]
    return {"images": torch.from_numpy(frames.astype(np.float32) / 255.0).to(device),
            **{k: torch.from_numpy(np.stack([r[j] for r in rows])).to(device)
               for j, k in enumerate(("boxes", "classes", "mask"))}}


def step_grads(cfg, tree, batch, device):
    """(loss metrics, gradients by name, BN batch statistics by path) of
    one f32 train-step forward and backward on `device`."""
    model = trainable(build_model(cfg, tree)).to(device)
    stats = []
    loss, m = detection_loss(forward_raw(model, batch["images"], stats), batch,
                             cfg, batch["images"].shape[1])
    loss.backward()
    return ({k: float(v.detach()) for k, v in m.items()},
            {n: p.grad.detach().cpu().flatten() for n, p in model.named_parameters()},
            {p: torch.cat([mu, var]).cpu() for p, mu, var in stats})


def card_against_cpu():
    """(a): the card's f32 step against the CPU's."""
    name = "hockey-puck-detection"
    cfg, tree = MODEL_ZOO[name], load_params(shipped_weights_path(name))
    frames, boxes = square_players(seed=7, n=2, s=640)
    flags = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        t = time.perf_counter()
        card = step_grads(cfg, tree, batch_of(frames, boxes, "cuda"), "cuda")
        torch.cuda.synchronize()
        card_s = time.perf_counter() - t
        t = time.perf_counter()
        cpu = step_grads(cfg, tree, batch_of(frames, boxes, "cpu"), "cpu")
        cpu_s = time.perf_counter() - t
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = flags
    rel = {k: abs(card[0][k] - cpu[0][k]) / max(abs(cpu[0][k]), 1e-6)
           for k in ("loss", "box_loss", "cls_loss", "dfl_loss")}
    cos = {}
    for n, g in cpu[1].items():
        a, b = card[1][n].double(), g.double()
        na, nb = float(a.norm()), float(b.norm())
        cos[n] = 1.0 if na == nb == 0 else float(a @ b) / max(na * nb, 1e-300)
    bn = max(float((card[2][p] - v).abs().max()) / max(float(v.abs().max()), 1.0)
             for p, v in cpu[2].items())
    worst = min(cos, key=cos.get)
    out = {"model": f"YOLOv8s ({name}), 640, batch 2, f32, TF32 off",
           "num_fg": card[0]["num_fg"], "loss_rel_diff": rel,
           "min_grad_cosine": cos[worst], "min_grad_cosine_at": worst,
           "bn_stats_max_diff": bn, "card_s": round(card_s, 3),
           "cpu_s": round(cpu_s, 3)}
    print(f"(a) card f32 step against the CPU: {out}", flush=True)
    if card[0]["num_fg"] != cpu[0]["num_fg"] or card[0]["num_fg"] <= 0:
        raise AssertionError("(a): fg anchors differ or none")
    if max(rel.values()) > TRAIN_LOSS_RTOL:
        raise AssertionError(f"(a): loss components differ {rel}")
    if cos[worst] < TRAIN_GRAD_COS:
        raise AssertionError(f"(a): gradient cosine {cos[worst]} at {worst}")
    if bn > TRAIN_BN_TOL:
        raise AssertionError(f"(a): BN statistics differ by {bn}")
    return out


def check_history(tag, history, keys):
    for i, m in enumerate(history):
        if m["skipped"] != 0.0 or m["num_fg"] <= 0 or not all(
                np.isfinite(m[k]) for k in keys):
            raise AssertionError(f"{tag} step {i}: {m}")


def step_rate(history, batch):
    """(mean ms per step after the first, images/s) of a run."""
    ms = float(np.mean([m["ms"] for m in history[1:]]))
    return ms, 1e3 * batch / ms


def full_width_runs(tmp, max_err):
    """(b): YOLOv8x at 640, batch 16, bf16, through the train loop."""
    name = "hockey-player-detection"
    cfg, init = MODEL_ZOO[name], shipped_weights_path(name)
    frames, boxes = square_players(seed=21, n=TRAIN_POOL)
    vframes, vboxes = square_players(seed=22, n=TRAIN_VAL)
    pool, val = os.path.join(tmp, "pool.npz"), os.path.join(tmp, "val.npz")
    write_pool(pool, frames, boxes)
    write_pool(val, vframes, vboxes)
    start = load_params(init)
    # before and after, each model with its own running statistics, by one
    # evaluator: the shipped model here, each run's EMA model below
    evaluator, vset = InTrainingEvaluator(cfg, 640, device="cuda"), PoolDataset(val)

    def held_out(model):
        return round(evaluator.evaluate(model, vset, range(TRAIN_VAL))["mAP50"], 4)

    before = held_out(build_model(cfg, start))
    common = ["--model", name, "--imgsz", "640", "--batch", "16", "--init", init,
              "--ema", "0.999", "--precise-bn", "2", "--val-pool-file", val,
              "--val-size", str(TRAIN_VAL), "--lr", str(TRAIN_LR), "--log-every", "1",
              "--save-every", "0", "--mosaic", "1.0", "--mixup", "0.15",
              "--pool-file", pool]
    runs, launches = {}, {}
    for tag, steps, extra in (("device", TRAIN_STEPS_DEVICE, ["--device-data"]),
                              ("host", TRAIN_STEPS_HOST, [])):
        out = os.path.join(tmp, f"{tag}.msgpack")
        torch.cuda.reset_peak_memory_stats()
        suppress.launches = 0
        run = train_loop.run(common + extra + ["--steps", str(steps), "--out", out,
                                               "--val-every", "3"])
        launches[tag] = suppress.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        if run.rc != 0 or len(run.history) != steps:
            raise AssertionError(f"{tag} run: rc {run.rc}, {len(run.history)} steps")
        check_history(f"{tag} run", run.history,
                      ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm"))
        if launches[tag] != 2 * len(run.val):  # 16 images: 2 batches of 8
            raise AssertionError(f"{tag} run: {launches[tag]} kernel launches, "
                                 f"{len(run.val)} validations")
        # parameters and running statistics moved; the checkpoint holds the
        # EMA weights, precise-BN's running statistics in it finite
        now = flatten_tree(params_to_jax(run.trainer.model))
        was = flatten_tree(start)
        moved = {kind: any(not np.array_equal(now[k], was[k]) for k in now
                           if (k[-1] in ("mean", "var")) == (kind == "stats"))
                 for kind in ("params", "stats")}
        if not all(moved.values()):
            raise AssertionError(f"{tag} run: unchanged {moved}")
        ema, saved = flatten_tree(params_to_jax(run.trainer.ema.model)), \
            flatten_tree(load_params(out))
        if saved.keys() != ema.keys() or not all(
                np.isfinite(saved[k]).all() if k[-1] in ("mean", "var")
                else np.array_equal(saved[k], ema[k]) for k in ema):
            raise AssertionError(f"{tag} run: the checkpoint is not the EMA model")
        ms, ips = step_rate(run.history, 16)
        runs[tag] = dict(steps=steps, step_ms=[round(m["ms"], 3) for m in run.history],
                         ms_per_step_after_first=round(ms, 3),
                         images_per_s=round(ips, 2), peak_memory_gib=round(peak, 3),
                         kernel_launches=launches[tag],
                         mAP50_after=held_out(run.trainer.ema.model),
                         mAP50_loop_val=round(run.val[-1][1]["mAP50"], 4),
                         losses=[round(m["loss"], 4) for m in run.history],
                         num_fg=[m["num_fg"] for m in run.history])
        print(f"(b) {tag} path: {runs[tag]}", flush=True)
        if tag == "device":
            max_err = kernel_on_batch(
                "train_eval (train loop, EMA model)", run.evaluator.core,
                inference_copy(run.trainer.ema.model, torch.device("cuda"),
                               torch.bfloat16), vframes[BATCH:], max_err,
                site="train_loop")
        del run
    print(f"(b) held-out mAP50 on {TRAIN_VAL} square scenes, each model with "
          f"its own running statistics: before (the shipped weights) {before}, "
          f"after the device-data run {runs['device']['mAP50_after']}, after "
          f"the host run {runs['host']['mAP50_after']} (the loop's validations "
          f"after precise-BN: {runs['device']['mAP50_loop_val']}, "
          f"{runs['host']['mAP50_loop_val']})", flush=True)
    for tag in runs:
        if before - runs[tag]["mAP50_after"] > TRAIN_MAP_DROP:
            raise AssertionError(f"(b): held-out mAP50 fell after the {tag} run")
    return dict(runs, mAP50_before=before), launches["device"] + launches["host"], max_err


def matched(det, boxes, iou_min=0.25):
    """gt boxes of each frame with a valid detection at IoU >= iou_min."""
    found = 0
    for i, gt in enumerate(boxes):
        pb = det.boxes[i][det.valid[i]].float().cpu()
        if len(pb) and len(gt):
            found += int((box_iou(pb, torch.from_numpy(gt)).amax(0) >= iou_min).sum())
    return found


def learns():
    """(c): a cold YOLOv8n overfits one batch and then finds its boxes
    (at conf 0.05, up to 16 per image), which it must not before."""
    s = LEARN_SIZE
    frames, boxes = square_players(seed=31, n=16, s=s, heights=(45, 100))
    cfg = YoloConfig("n", num_classes=2)
    model = build_model(cfg, init_params(cfg, seed=0)).to(
        "cuda", memory_format=torch.channels_last)
    core = DetectCore(cfg, imgsz=s, frame_hw=(s, s), conf=0.05, rect=False,
                      max_det=16)
    images = torch.from_numpy(frames).cuda()

    def found(m):
        """(gt boxes found, kernel launches)."""
        suppress.launches = 0
        with torch.inference_mode():
            det = core(inference_copy(m, torch.device("cuda"), torch.bfloat16),
                       images)
        return matched(det, boxes), suppress.launches

    before, _ = found(precise_bn(model, make_bn_stats_fn(),
                                 [images.float() / 255.0]))
    trainer = Trainer(cfg, TrainConfig(imgsz=s, total_steps=LEARN_STEPS,
                                       warmup_steps=10, learning_rate=0.01), model)
    batch = batch_of(frames, boxes, "cuda")
    t = time.perf_counter()
    losses = [float(trainer.step(batch)["loss"]) for _ in range(LEARN_STEPS)]
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t
    after, launches = found(precise_bn(trainer.model, make_bn_stats_fn(),
                                       [batch["images"]]))
    total = sum(len(b) for b in boxes)
    out = {"model": f"YOLOv8n cold init, {s}, batch 16, bf16",
           "steps": LEARN_STEPS, "train_s": round(train_s, 3),
           "ms_per_step": round(1e3 * train_s / LEARN_STEPS, 3),
           "loss_first_last": [round(losses[0], 4), round(losses[-1], 4)],
           "found_before": before, "found_after": after, "gt_boxes": total,
           "kernel_launches": launches}
    print(f"(c) it learns: {out}", flush=True)
    if not np.isfinite(losses).all() or after * 2 < total or after <= before:
        raise AssertionError(f"(c): found {after} of {total} boxes "
                             f"({before} before training)")
    return out, launches


def pose_run(tmp, max_err):
    """(d): the shipped pose model at 512 through the train loop."""
    name, s = "hockey-detection", VAL_RINK_SIZE
    frames, kpts = square_rink(seed=41, n=16, s=s)
    vframes, vkpts = square_rink(seed=42, n=BATCH, s=s)
    pool, val = os.path.join(tmp, "rink.npz"), os.path.join(tmp, "rink_val.npz")
    write_pool(pool, frames, rink_boxes(kpts, s), kpts)
    write_pool(val, vframes, rink_boxes(vkpts, s), vkpts)
    suppress.launches = 0
    run = train_loop.run(["--model", name, "--imgsz", str(s), "--batch", "8",
                          "--steps", "3", "--init", shipped_weights_path(name),
                          "--device-data", "--precise-bn", "1", "--val-every", "3",
                          "--val-pool-file", val, "--val-size", str(BATCH), "--lr",
                          str(TRAIN_LR), "--log-every", "1", "--save-every", "0",
                          "--pool-file", pool, "--out", os.path.join(tmp, "pose.msgpack")])
    launches = suppress.launches
    if run.rc != 0:
        raise AssertionError(f"(d): rc {run.rc}")
    check_history("(d)", run.history, ("loss", "kpt_loss", "kobj_loss", "grad_norm"))
    if launches != len(run.val):  # one batch of 8 per validation
        raise AssertionError(f"(d): {launches} kernel launches")
    out = {"model": "YOLOv8s-pose (hockey-detection), 512, batch 8, bf16",
           "kpt_loss": [round(m["kpt_loss"], 4) for m in run.history],
           "kobj_loss": [round(m["kobj_loss"], 4) for m in run.history],
           "step_ms": [round(m["ms"], 3) for m in run.history],
           "pck_after": round(run.val[-1][1]["pck"], 4), "kernel_launches": launches}
    print(f"(d) pose: {out}", flush=True)
    max_err = kernel_on_batch(
        "pose_eval (train loop)", run.evaluator.core,
        inference_copy(run.trainer.model, torch.device("cuda"), torch.bfloat16),
        vframes, max_err, site="train_loop_pose")
    return out, launches, max_err


def training_phase(card, max_err):
    """Phase 13; returns (kernel launches of the training runs, max_err)."""
    t0 = time.perf_counter()
    out = {"card": card, "card_against_cpu": card_against_cpu()}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        out["full_width"], launches_b, max_err = full_width_runs(tmp, max_err)
        out["learns"], launches_c = learns()
        out["pose"], launches_d, max_err = pose_run(tmp, max_err)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["kernel_at_sites"] = {k: SITES[k] for k in ("train_loop", "train_loop_pose")}
    out["kernel_launches"] = launches_b + launches_c + launches_d
    out["phase_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps({"training": out}), flush=True)
    return out["kernel_launches"], max_err


# --------------------------------------------------------------------------
# phase 14: the JAX CLIs' default invocations, the weight converters and
# the last trainers (team embedder, jersey digits)

def ultralytics_state_dict(tree, prefix="model."):
    """A JAX-layout YOLOv8 tree as an ultralytics DetectionModel state
    dict (`convert_state_dict`'s inverse; tests/test_torch_convert.py
    keeps its own copy)."""
    sd = {}

    def conv(node, mp):
        sd[f"{mp}.conv.weight"] = np.ascontiguousarray(node["w"].transpose(3, 2, 0, 1))
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{mp}.bn.{theirs}"] = node["bn"][ours]

    for idx, (group, name) in BACKBONE_IDX.items():
        node, mp = tree[group][name], f"{prefix}{idx}"
        if name.startswith(("stem", "down")):
            conv(node, mp)
            continue
        conv(node["cv1"], f"{mp}.cv1")
        conv(node["cv2"], f"{mp}.cv2")
        for i, m in enumerate(node.get("m", [])):
            conv(m["cv1"], f"{mp}.m.{i}.cv1")
            conv(m["cv2"], f"{mp}.m.{i}.cv2")
    for theirs, ours in (("cv2", "reg"), ("cv3", "cls"), ("cv4", "kpt")):
        for lvl, br in enumerate(tree["head"].get(ours, [])):
            mp = f"{prefix}22.{theirs}.{lvl}"
            conv(br["cv1"], f"{mp}.0")
            conv(br["cv2"], f"{mp}.1")
            sd[f"{mp}.2.weight"] = np.ascontiguousarray(br["out"]["w"].transpose(3, 2, 0, 1))
            sd[f"{mp}.2.bias"] = br["out"]["b"]
    return sd


def torchvision_state_dict(tree):
    """A MobileNetV3 tree as a torchvision mobilenet_v3_small state dict
    (`convert_torchvision`'s inverse)."""
    sd = {}

    def conv_bn(node, prefix):
        sd[f"{prefix}.0.weight"] = np.ascontiguousarray(node["w"].transpose(3, 2, 0, 1))
        for ours, theirs in (("scale", "weight"), ("bias", "bias"),
                             ("mean", "running_mean"), ("var", "running_var")):
            sd[f"{prefix}.1.{theirs}"] = node["bn"][ours]

    conv_bn(tree["stem"], "features.0")
    for i, b in enumerate(tree["blocks"], start=1):
        j, base = 0, f"features.{i}.block"
        for part in ("expand", "dw", "se", "project"):
            if part not in b:
                continue
            if part == "se":
                for fc in ("fc1", "fc2"):
                    sd[f"{base}.{j}.{fc}.weight"] = np.ascontiguousarray(
                        b["se"][fc]["w"].transpose(3, 2, 0, 1))
                    sd[f"{base}.{j}.{fc}.bias"] = b["se"][fc]["b"]
            else:
                conv_bn(b[part], f"{base}.{j}")
            j += 1
    conv_bn(tree["head"], "features.12")
    return sd


def numpy_pair_batch(rng, n, h=64, w=32):
    """Two views of each of n jersey designs drawn in numpy: the five
    patterns of teams/embed_train.py (solid, hoops, stripes, sash, yoke)
    without the number; each view at its own size (48-119 px tall, half
    as wide), shifted, under its own gain, bias and noise, resized to
    (h, w) by nearest neighbour. BGR uint8 (n, h, w, 3) twice."""
    views = ([], [])
    for _ in range(n):
        base, second = rng.uniform(0, 255, 3), rng.uniform(0, 255, 3)
        while np.abs(base - second).sum() < 120:
            second = rng.uniform(0, 255, 3)
        pattern = int(rng.integers(0, 5))
        for out in views:
            s = int(rng.integers(48, 120))
            sw = s // 2
            img = np.empty((s, sw, 3), np.float32)
            img[:] = base
            if pattern == 1:    # hoops
                period = max(s // int(rng.integers(4, 7)), 3)
                img[(np.arange(s) // period) % 2 == 0] = second
            elif pattern == 2:  # vertical stripes
                period = max(sw // int(rng.integers(3, 6)), 2)
                img[:, (np.arange(sw) // period) % 2 == 0] = second
            elif pattern == 3:  # sash
                yy, xx = np.mgrid[0:s, 0:sw]
                img[np.abs(yy - xx * (s / sw)) < s * 0.18] = second
            elif pattern == 4:  # yoke
                img[: int(s * 0.3)] = second
            img = np.roll(img, (int(rng.integers(-(s // 10), s // 10 + 1)),
                                int(rng.integers(-(sw // 10), sw // 10 + 1))), (0, 1))
            img = (img * rng.uniform(0.6, 1.3) + rng.uniform(-25, 25)
                   + rng.normal(0, rng.uniform(1, 8), img.shape))
            ys, xs = (np.arange(h) * s) // h, (np.arange(w) * sw) // w
            out.append(np.clip(img[ys][:, xs], 0, 255).astype(np.uint8))
    return np.stack(views[0]), np.stack(views[1])


GLYPHS = ("01110100011001110101110011000101110", "00100011000010000100001000010001110",
          "01110100010000100010001000100011111", "11110000010000101110000010000111110",
          "00010001100101010010111110001000010", "11111100001111000001000011000101110",
          "00110010001000011110100011000101110", "11111000010001000100010000100001000",
          "01110100011000101110100011000101110", "01110100011000101111000010001001100")


def numpy_digit_batch(rng, n, crop=48):
    """n jersey-number crops drawn in numpy: one or two 5x7 bitmap digits
    (single digits 45% of the time, as ocr/digits.py draws them) at 2-4 px
    a cell, anywhere on a flat jersey of another shade, with noise, then
    stretched between the 5th and 95th percentiles as `normalize_crop`
    does. ((n, crop, crop, 1) f32, tens labels (10: none), ones labels)."""
    xs, tens, ones = [], [], []
    for _ in range(n):
        number = int(rng.integers(1, 10)) if rng.uniform() < 0.45 else int(rng.integers(10, 100))
        digits = [int(c) for c in str(number)]
        glyph = np.zeros((7, 6 * len(digits) - 1), np.float32)
        for j, d in enumerate(digits):
            glyph[:, 6 * j: 6 * j + 5] = np.asarray(list(GLYPHS[d]), np.float32).reshape(7, 5)
        k = int(rng.integers(2, 5))
        glyph = np.kron(glyph, np.ones((k, k), np.float32))
        bg = rng.uniform(0, 255)
        fg = (bg + rng.uniform(80, 175)) % 256
        img = np.full((crop, crop), bg, np.float32)
        y0 = int(rng.integers(0, crop - glyph.shape[0] + 1))
        x0 = int(rng.integers(0, crop - glyph.shape[1] + 1))
        img[y0:y0 + glyph.shape[0], x0:x0 + glyph.shape[1]][glyph > 0] = fg
        img = img + rng.normal(0, rng.uniform(2, 9), img.shape)
        lo, hi = np.percentile(img, 5), np.percentile(img, 95)
        xs.append(np.clip((img - lo) / max(hi - lo, 1.0), 0, 1)[..., None])
        tens.append(number // 10 if number >= 10 else 10)
        ones.append(number % 10)
    return (np.stack(xs).astype(np.float32), np.asarray(tens, np.int32),
            np.asarray(ones, np.int32))


def default_training(tmp):
    """(a): `python -m hockey_tpu_torch.train.loop` with no data flag, the
    JAX CLI's defaults (YOLOv8x, 640, batch 16, bf16, cold init,
    SyntheticHockeyDataset, precise-BN 8) for DEFAULT_TRAIN_STEPS steps."""
    out_path = os.path.join(tmp, "model.msgpack")
    suppress.launches = 0
    t = time.perf_counter()
    run = train_loop.run(["--steps", str(DEFAULT_TRAIN_STEPS), "--log-every", "1",
                          "--out", out_path])
    wall = time.perf_counter() - t
    if run.rc != 0 or len(run.history) != DEFAULT_TRAIN_STEPS:
        raise AssertionError(f"(a): rc {run.rc}, {len(run.history)} steps")
    check_history("(a)", run.history, ("loss", "box_loss", "cls_loss", "dfl_loss",
                                       "grad_norm"))
    saved = load_params(out_path)
    now, back = flatten_tree(params_to_jax(run.trainer.model)), flatten_tree(saved)
    if now.keys() != back.keys() or not all(
            np.isfinite(back[k]).all() if k[-1] in ("mean", "var")
            else np.array_equal(back[k], now[k]) for k in now):
        raise AssertionError("(a): the checkpoint is not the trained model")
    name = Config().player_model_name
    model = build_model(MODEL_ZOO[name], saved).to("cuda")  # loads back, strict
    with torch.inference_mode():
        raw = forward_raw(model, torch.rand(1, 640, 640, 3, device="cuda"))
    if not all(torch.isfinite(v).all() for maps in raw.values() for v in maps):
        raise AssertionError("(a): the saved model's forward is not finite")
    ms, ips = step_rate(run.history, 16)
    out = {"argv": "--steps 3 (every other flag at its default)",
           "model": "YOLOv8x (hockey-player-detection), 640, batch 16, bf16, cold",
           "losses": [round(m["loss"], 4) for m in run.history],
           "step_ms": [round(m["ms"], 3) for m in run.history],
           "ms_per_step_after_first": round(ms, 3), "images_per_s": round(ips, 2),
           "wall_s": round(wall, 2), "kernel_launches": suppress.launches}
    print(f"(a) the default train CLI: {out}", flush=True)
    return out


def default_validation(config, max_err):
    """(b): `python -m hockey_tpu_torch.train.val` with no flag: the
    shipped player model on the JAX CLI's 50 SyntheticHockeyDataset
    images (seed 0, 640), held to the JAX CLI's f32 figures; the kernel
    at site `val_synthetic` on the last 8 images."""
    buf = io.StringIO()
    suppress.launches = 0
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = train_val.main(["--json"])
    wall, launches = time.perf_counter() - t, suppress.launches
    m = json.loads(buf.getvalue().strip().splitlines()[-1])
    gap = {k: abs(m[k] - JAX_SYNTHETIC_F32[k]) for k in ("mAP50", "mAP50_95")}
    out = {"metrics": m, "jax_cpu_f32": JAX_SYNTHETIC_F32, "gap": gap,
           "images": 50, "wall_s": round(wall, 3),
           "images_per_s": round(50 / wall, 2), "kernel_launches": launches}
    print(f"(b) the default val CLI: {out}", flush=True)
    if rc != 0 or launches != 7:  # 50 images: 7 batches of 8, the last padded
        raise AssertionError(f"(b): rc {rc}, {launches} kernel launches")
    if max(gap.values()) > VAL_TOL:
        raise AssertionError(f"(b): mAP off the JAX CLI's by {gap}")
    ds = SyntheticHockeyDataset(imgsz=640, seed=0)
    last = np.stack([(ds.load(i)["images"] * 255).astype(np.uint8) for i in range(42, 50)])
    det = Detector(config.player_model_name, config, frame_hw=(640, 640), imgsz=640,
                   conf=0.001, device="cuda", dtype=torch.bfloat16)
    max_err = kernel_on_batch("val_synthetic (the default val CLI)", det.core,
                              det.model, last, max_err, site="val_synthetic")
    return out, launches, max_err


def converters(config, vp, frames, tmp):
    """(c): the shipped player weights through an ultralytics state dict
    and `convert_state_dict` give bit-equal detections and kept sets; the
    shipped team embedder through a torchvision state dict and
    `convert_torchvision` gives bit-equal embeddings."""
    name = config.player_model_name
    shipped = load_params(shipped_weights_path(name))
    t = time.perf_counter()
    tree = convert_state_dict(ultralytics_state_dict(shipped), MODEL_ZOO[name])
    convert_s = time.perf_counter() - t
    path = os.path.join(tmp, "converted.msgpack")
    save_params(path, tree)
    det2 = Detector(name, config, frame_hw=FRAME_HW, checkpoint=path, device="cuda",
                    dtype=torch.bfloat16)
    vp2 = VideoProcessor(config, device="cuda", frame_hw=FRAME_HW,
                         mode=ProcessingMode.PLAYER_DETECTION, player_detector=det2)
    batch = frames[:BATCH]
    suppress.launches = 0
    got = list(vp2.detect_frames(batch))
    launches = suppress.launches
    want = list(vp.detect_frames(batch))
    same = all(np.array_equal(g.boxes, w.boxes) and np.array_equal(g.scores, w.scores)
               and np.array_equal(g.classes, w.classes) for g, w in zip(got, want))
    with torch.inference_mode():
        x = torch.as_tensor(batch).cuda()
        kept = [suppress(c.matrix, c.keep0, c.thr) for c in (
            d.core.candidates(d.model, x) for d in (vp.player_detector, det2))]
    same_kept = torch.equal(*kept)
    emb_shipped = load_embed_params()
    emb = convert_torchvision(torchvision_state_dict(emb_shipped))
    crops = torch.from_numpy(np.random.default_rng(71).integers(
        0, 256, (32, 64, 32, 3)).astype(np.uint8)).cuda()
    same_embed = torch.equal(embed(build_embedder(emb, "cuda"), crops),
                             embed(build_embedder(emb_shipped, "cuda"), crops))
    out = {"detections_bit_equal": same, "kept_sets_bit_equal": same_kept,
           "boxes": sum(len(g) for g in got), "embeddings_bit_equal": same_embed,
           "convert_s": round(convert_s, 3), "kernel_launches": launches}
    print(f"(c) converters: {out}", flush=True)
    if not (same and same_kept and same_embed and out["boxes"] > 0 and launches == 1):
        raise AssertionError(f"(c): {out}")
    return out, launches


def card_and_cpu_steps(make, b1, b2):
    """Two steps of a trainer made by make(device) on the card and on
    the CPU from the same tree and batches: the first (lr 0) compares the
    loss and the gradients, the second each leaf's update. Leaves whose
    CPU gradient is rounding noise (at most 1e-4 of the largest: BN
    biases before a batch-statistics BN, 0 in exact arithmetic) are left
    out of the cosines and the updates."""
    card, cpu = make("cuda"), make("cpu")
    lc, _, gc = card.grads(*b1)
    lp, _, gp = cpu.grads(*b1)
    names = card.names
    scale = max(float(g.abs().max()) for g in gp if g is not None)
    noise = [p is not None and float(p.abs().max()) <= 1e-4 * scale for p in gp]
    grad_err, cos = 0.0, {}
    for n, c, p, nz in zip(names, gc, gp, noise):
        if p is None:
            continue
        c, p = c.cpu().double().flatten(), p.double().flatten()
        grad_err = max(grad_err, float((c - p).abs().max()) / scale)
        if not nz:
            cos[n] = float(c @ p) / max(float(c.norm() * p.norm()), 1e-300)
    card.opt.step(gc)
    cpu.opt.step(gp)
    before = [(c.detach().cpu().clone(), p.detach().clone())
              for c, p in zip(card.leaves, cpu.leaves)]
    l2c, _ = card.step(*b2)
    l2p, _ = cpu.step(*b2)
    upd, upd_at = 0.0, None
    for n, (c0, p0), c, p, nz in zip(names, before, card.leaves, cpu.leaves, noise):
        dc, dp = c.detach().cpu() - c0, p.detach() - p0
        if not nz and float(dp.norm()) > 0:
            r = float((dc - dp).norm() / dp.norm())
            upd, upd_at = (r, n) if r > upd else (upd, upd_at)
    worst = min(cos, key=cos.get)
    return card, {"loss_rel_diff": [abs(float(lc) - float(lp)) / abs(float(lp)),
                                    abs(l2c - l2p) / abs(l2p)],
                  "grad_max_diff_of_largest": grad_err,
                  "grad_min_cosine": cos[worst], "grad_min_cosine_at": worst,
                  "update_rel_diff_max": upd, "update_rel_diff_max_at": upd_at,
                  "noise_leaves": int(sum(noise))}


def check_card_step(tag, cmp):
    if (max(cmp["loss_rel_diff"]) > CARD_LOSS_RTOL or cmp["grad_max_diff_of_largest"]
            > CARD_GRAD_TOL or cmp["update_rel_diff_max"] > CARD_UPDATE_TOL):
        raise AssertionError(f"{tag}: the card's step is not the CPU's: {cmp}")


def embed_training(rng):
    """(d): the embedder's step at the JAX defaults (48 designs, 64x32, f32,
    from `init_params`) on numpy-drawn pairs: card against CPU, a short
    run whose pair accuracy rises, then `calibrate_bn`."""
    tree = embed_init_params(torch.Generator().manual_seed(0))
    b1, b2 = numpy_pair_batch(rng, 48), numpy_pair_batch(rng, 48)
    trainer, cmp = card_and_cpu_steps(lambda d: EmbedTrainer(tree, 1200, device=d), b1, b2)
    accs, ms = [], []
    for _ in range(EMBED_STEPS):
        a, b = numpy_pair_batch(rng, 48)
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, acc = trainer.step(a, b)  # syncs
        ms.append(1e3 * (time.perf_counter() - t))
        accs.append(acc)
    first, last = float(np.mean(accs[:10])), float(np.mean(accs[-10:]))
    trainer.calibrate([numpy_pair_batch(rng, 48)[0] for _ in range(16)])
    params = trainer.params()
    stats_ok = all(np.isfinite(v).all() for k, v in flatten_tree(params).items()
                   if k[-1] in ("mean", "var"))
    a, b = numpy_pair_batch(rng, 48)
    net = build_embedder(params, "cuda")
    za, zb = (torch.nn.functional.normalize(embed(net, torch.from_numpy(v).cuda()), dim=1)
              for v in (a, b))
    eval_acc = float(((za @ zb.T).argmax(1) == torch.arange(48, device="cuda")).float().mean())
    step_ms = float(np.median(ms[1:]))
    out = dict(cmp, steps=EMBED_STEPS, pair_acc_first10=round(first, 4),
               pair_acc_last10=round(last, 4), pair_acc_rise=round(last - first, 4),
               calibrated_eval_pair_acc=round(eval_acc, 4), stats_finite=stats_ok,
               ms_per_step=round(step_ms, 3), images_per_s=round(96e3 / step_ms, 1))
    print(f"(d) embedder training: {out}", flush=True)
    check_card_step("(d)", cmp)
    if last - first < EMBED_ACC_RISE or not stats_ok or not np.isfinite(eval_acc):
        raise AssertionError(f"(d): {out}")
    return out


def digit_training(rng):
    """(e): the digit net's step at the JAX defaults (batch 128, 48x48
    grey, f32, cold) on numpy-drawn digits: card against CPU, then a short
    run from cold on a drawn pool of 1024."""
    tree = init_digit_params(torch.Generator().manual_seed(0))
    x, t, o = numpy_digit_batch(rng, 1024)
    b1, b2 = (x[:128], t[:128], o[:128]), (x[128:256], t[128:256], o[128:256])
    trainer, cmp = card_and_cpu_steps(lambda d: DigitTrainer(tree, 3000, device=d), b1, b2)
    losses, accs, ms = [], [], []
    for _ in range(DIGIT_STEPS):
        idx = rng.integers(0, len(x), 128)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        loss, acc = trainer.step(x[idx], t[idx], o[idx])
        ms.append(1e3 * (time.perf_counter() - t0))
        losses.append(loss)
        accs.append(acc)
    step_ms = float(np.median(ms[1:]))
    out = dict(cmp, steps=DIGIT_STEPS, loss_first10=round(float(np.mean(losses[:10])), 4),
               loss_last10=round(float(np.mean(losses[-10:])), 4),
               exact_first10=round(float(np.mean(accs[:10])), 4),
               exact_last10=round(float(np.mean(accs[-10:])), 4),
               ms_per_step=round(step_ms, 3), images_per_s=round(128e3 / step_ms, 1))
    print(f"(e) digit net training: {out}", flush=True)
    check_card_step("(e)", cmp)
    if not np.isfinite(losses).all() or out["loss_last10"] > DIGIT_LOSS_FRAC * out["loss_first10"]:
        raise AssertionError(f"(e): {out}")
    return out


def slice10_phase(config, vp, frames, max_err):
    """Phase 14; returns (kernel launches of its runs, max_err)."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(14)
    out = {}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice10_")
    try:
        out["default_train"] = default_training(tmp)
        out["default_val"], launches_b, max_err = default_validation(config, max_err)
        out["converters"], launches_c = converters(config, vp, frames, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["embed_train"] = embed_training(rng)
    out["digit_train"] = digit_training(rng)
    out["kernel_at_sites"] = {"val_synthetic": SITES["val_synthetic"]}
    out["kernel_launches"] = out["default_train"]["kernel_launches"] + launches_b + launches_c
    out["phase_s"] = round(time.perf_counter() - t0, 2)
    print(json.dumps({"slice10": out}), flush=True)
    return out["kernel_launches"], max_err


# --------------------------------------------------------------------------
# phase 15: the host runtime, and multi-device training and detection

@contextlib.contextmanager
def plain_route():
    """The host ByteTrack's plain route (numpy IoU, scipy's solver) for
    the duration of a `with`."""
    iou, lsa = bytetrack._iou_matrix, native.linear_sum_assignment
    bytetrack._iou_matrix = native._iou_numpy
    native.linear_sum_assignment = native.linear_sum_assignment_reference
    try:
        yield
    finally:
        bytetrack._iou_matrix, native.linear_sum_assignment = iou, lsa


def replay_tracker(config, inputs):
    """(ms per frame, each frame's outputs) of a fresh host ByteTrack over
    `inputs`, by the host clock."""
    tr = ByteTrack.from_config(config)
    t = time.perf_counter()
    out = [tr.update(*x) for x in inputs]
    return 1e3 * (time.perf_counter() - t) / len(inputs), out


def host_runtime(config, inputs):
    """(a): the host runtime built cold, held against its plain versions,
    and the host ByteTrack's ms per frame through either route."""
    build_dir = native.BUILD_DIR
    with tempfile.TemporaryDirectory() as d:
        native.BUILD_DIR = d
        try:
            t = time.perf_counter()
            ctypes.CDLL(native.build_library())
            build_s = time.perf_counter() - t
        finally:
            native.BUILD_DIR = build_dir
    rng = np.random.default_rng(15)

    def boxes(n):  # positive areas: the two IoUs' rules for a degenerate pair differ
        xy = rng.uniform(0, 1800, (n, 2))
        return np.concatenate([xy, xy + rng.uniform(4, 200, (n, 2))], 1).astype(np.float32)

    a, b = boxes(HOST_PAIRS), boxes(HOST_PAIRS)
    iou_equal = np.array_equal(native.iou_matrix(a, b), native._iou_numpy(a, b))
    cost_equal = assign_equal = ties_other = 0
    for i in range(HOST_LSAP):
        r, c = rng.integers(1, 31, 2)
        tied = i % 2 == 0  # integer costs: optima tie; continuous: one optimum
        cost = rng.integers(0, 4, (r, c)).astype(np.float64) if tied else rng.random((r, c))
        rows, cols = native.linear_sum_assignment(cost)
        pr, pc = native.linear_sum_assignment_reference(cost)
        # the same pairs (for r > c the runtime lists them by column)
        same = sorted(zip(rows.tolist(), cols.tolist())) == sorted(
            zip(pr.tolist(), pc.tolist()))
        cost_equal += bool(np.isclose(cost[rows, cols].sum(), cost[pr, pc].sum(),
                                      rtol=1e-12, atol=0))
        if tied:
            ties_other += not same
        else:
            assign_equal += same
    native_ms, plain_ms, outs = [], [], {}
    for route in ("plain", "native", "native", "plain"):
        with plain_route() if route == "plain" else contextlib.nullcontext():
            for _ in range(HOST_REPLAYS):
                ms, outs[route] = replay_tracker(config, inputs)
                (plain_ms if route == "plain" else native_ms).append(ms)
    ids_equal = all(np.array_equal(x[3], y[3]) and np.array_equal(x[0], y[0])
                    for x, y in zip(outs["native"], outs["plain"]))
    out = {"build_s": round(build_s, 3), "iou_pairs": HOST_PAIRS ** 2,
           "iou_bit_equal_to_numpy": iou_equal,
           "lsap_problems": HOST_LSAP, "total_cost_equal_to_scipy": cost_equal,
           "unique_optimum_assignments_equal": assign_equal,
           "tied_problems_with_another_optimum": ties_other,
           "frames": len(inputs),
           "bytetrack_ms_per_frame_native": [round(x, 4) for x in native_ms],
           "bytetrack_ms_per_frame_plain": [round(x, 4) for x in plain_ms],
           "native_ids_equal_plain_on_phase8": ids_equal}
    print(f"(a) host runtime: g++ build {build_s:.2f} s; IoU on {HOST_PAIRS ** 2} "
          f"pairs bit-equal to numpy: {iou_equal}; total cost equal to scipy's "
          f"on {cost_equal} of {HOST_LSAP} problems, the assignment equal on "
          f"{assign_equal} of {HOST_LSAP // 2} with one optimum ({ties_other} "
          f"tied ones solved to another optimum); host ByteTrack over phase 8's "
          f"{len(inputs)} frames, ms per frame native {out['bytetrack_ms_per_frame_native']} "
          f"plain {out['bytetrack_ms_per_frame_plain']}; ids equal {ids_equal}",
          flush=True)
    if not iou_equal or cost_equal != HOST_LSAP or assign_equal != HOST_LSAP // 2:
        raise AssertionError(f"(a): the host runtime disagrees with its plain versions {out}")
    if not inputs or not all(len(o[3]) == len(set(o[3].tolist())) for o in outs["native"]):
        raise AssertionError("(a): no tracker inputs, or duplicate ids")
    return out


def mesh_batches(n_steps, device):
    """`n_steps` batches of 16 square scenes at 640 on `device`."""
    frames, boxes = square_players(seed=31, n=16 * n_steps)
    return [batch_of(frames[16 * i:16 * (i + 1)], boxes[16 * i:16 * (i + 1)], device)
            for i in range(n_steps)]


def mesh_train_config():
    return TrainConfig(imgsz=640, learning_rate=MESH_LR, warmup_steps=1,
                       total_steps=10, compute_dtype="bfloat16")


def mesh_model(device):
    name = "hockey-player-detection"
    model = build_model(MODEL_ZOO[name], load_params(shipped_weights_path(name)))
    return model.to(device, memory_format=torch.channels_last)


def timed_steps(trainer, batches):
    """(each step's metrics as floats, each step's ms by the host clock
    around a synchronised step)."""
    out, ms = [], []
    for b in batches:
        torch.cuda.synchronize()
        t = time.perf_counter()
        m = {k: float(v) for k, v in trainer.step(b).items()}
        ms.append(1e3 * (time.perf_counter() - t))
        out.append(m)
    return out, ms


def flat(tree):
    """A parameter tree's leaves by their '/'-joined paths."""
    return {"/".join(k): v for k, v in flatten_tree(tree).items()}


def tree_diff(fa, fb):
    """Largest difference of two `flat` parameter trees, each leaf relative
    to its largest magnitude (at least 1)."""
    if fa.keys() != fb.keys():
        raise AssertionError("parameter trees differ in their leaves")
    return max(float(np.abs(fa[k] - fb[k]).max()) / max(float(np.abs(fb[k]).max()), 1.0)
               for k in fb)


def mesh_steps(mesh, batches):
    """(b): `MESH_STEPS` steps of `Trainer` and of `shard_train_step` over
    the 1x1 mesh from the shipped YOLOv8x, deterministic cuDNN, then the
    two timed in turns with cuDNN's defaults."""
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    try:
        single = Trainer(MODEL_ZOO["hockey-player-detection"], mesh_train_config(),
                         mesh_model("cuda"))
        want, _ = timed_steps(single, batches)
        sharded = shard_train_step(mesh, MODEL_ZOO["hockey-player-detection"],
                                   mesh_train_config(), mesh_model("cuda"))
        got, _ = timed_steps(sharded, batches)
    finally:
        torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags
    keys = ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm")
    loss_rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for g, w in zip(got, want) for k in keys)
    want_tree = params_to_jax(single.model)
    param_diff = tree_diff(flat(gather_params(sharded)), flat(want_tree))
    bit_equal = got == want and param_diff == 0.0
    ms = {"single": [], "mesh_1x1": []}
    for tag in ("single", "mesh_1x1", "mesh_1x1", "single"):
        _, t = timed_steps(single if tag == "single" else sharded, batches[:2])
        ms[tag] += t
    out = {"model": "YOLOv8x (hockey-player-detection), 640, batch 16, bf16",
           "steps": len(batches), "losses": [round(m["loss"], 5) for m in got],
           "num_fg": [m["num_fg"] for m in got], "bit_equal": bit_equal,
           "loss_max_rel_diff": loss_rel, "param_max_diff": param_diff,
           "step_ms_single": [round(x, 3) for x in ms["single"]],
           "step_ms_mesh_1x1": [round(x, 3) for x in ms["mesh_1x1"]]}
    print(f"(b) 1x1 mesh step against Trainer: {out}", flush=True)
    check_history("(b) mesh", got, keys)
    if not bit_equal and (loss_rel > MESH_LOSS_RTOL or param_diff > MESH_PARAM_TOL):
        raise AssertionError(f"(b): the 1x1 mesh step differs from Trainer's {out}")
    return out, want, want_tree


def multi_card(batches, want, want_tree, frames8, dets8, dp=2, fsdp=1):
    """(c): a dp x fsdp mesh over NCCL, one process per card, held against
    (b)'s single-device steps and phase 4's detections."""
    with tempfile.TemporaryDirectory() as d:
        inp, res = os.path.join(d, "in.npz"), os.path.join(d, "out.npz")
        np.savez(inp, frames=frames8, device="cuda", fsdp=fsdp,
                 **{f"{i}/{k}": v.cpu().numpy() for i, b in enumerate(batches)
                    for k, v in b.items()})
        t = time.perf_counter()
        rc = launch([os.path.abspath(__file__), "--mesh-rank", inp, res], dp * fsdp,
                    "cuda", timeout=900)
        if rc != 0:
            raise AssertionError(f"(c): a rank failed ({rc})")
        with np.load(res, allow_pickle=False) as f:
            got = dict(f)
        secs = time.perf_counter() - t
    keys = ("loss", "box_loss", "cls_loss", "dfl_loss")
    loss_rel = max(abs(got[f"step{i}/{k}"] - w[k]) / max(abs(w[k]), 1e-12)
                   for i, w in enumerate(want) for k in keys)
    param_diff = tree_diff({k[7:]: v for k, v in got.items() if k.startswith("params/")},
                           flat(want_tree))
    det2 = [HostDetections(got["det/boxes"][i][got["det/valid"][i]],
                           got["det/scores"][i][got["det/valid"][i]],
                           got["det/classes"][i][got["det/valid"][i]])
            for i in range(len(frames8))]
    match = min(min(match_fraction(a, b), match_fraction(b, a))
                for a, b in zip(det2, dets8))
    out = {"dp": dp, "fsdp": fsdp, "seconds": round(secs, 1),
           "loss_max_rel_diff": loss_rel,
           "param_max_diff": param_diff, "detect_dp_min_match": match,
           "step_ms": [round(float(x), 3) for x in got["step_ms"]]}
    print(f"(c) dp {dp} x fsdp {fsdp} over NCCL on {dp * fsdp} cards against "
          f"(b): {out}", flush=True)
    if loss_rel > MULTI_LOSS_RTOL or param_diff > MULTI_PARAM_TOL or match < MULTI_MATCH:
        raise AssertionError(f"(c): the mesh differs from one card {out}")
    return out


def mesh_rank(inp: str, res: str) -> int:
    """One rank of (c), started by `launch` with `--mesh-rank IN OUT`:
    (b)'s steps on this rank's rows over the mesh of IN's fsdp, then
    `detect_dp` of the shipped detector on IN's frames; rank 0 writes
    OUT."""
    with np.load(inp, allow_pickle=False) as f:
        data = dict(f)
    device = init_from_env(str(data["device"]))
    mesh = make_mesh(dist.get_world_size(), fsdp=int(data["fsdp"]), device=device)
    batches = [{k: torch.from_numpy(data[f"{i}/{k}"]) for k in
                ("images", "boxes", "classes", "mask")} for i in range(MESH_STEPS)]
    trainer = shard_train_step(mesh, MODEL_ZOO["hockey-player-detection"],
                               mesh_train_config(), mesh_model(device))
    out, ms = timed_steps(trainer, [shard_batch(mesh, b) for b in batches])
    res_d = {f"step{i}/{k}": np.float64(v) for i, m in enumerate(out) for k, v in m.items()}
    res_d["step_ms"] = np.asarray(ms)
    res_d.update({"params/" + k: v for k, v in flat(gather_params(trainer)).items()})
    det = Detector(Config().player_model_name, Config(), frame_hw=FRAME_HW,
                   device=device, dtype=torch.bfloat16)
    got = detect_dp(det.detect_batch, mesh)(data["frames"])
    res_d.update({f"det/{f}": getattr(got, f).cpu().numpy() for f in got._fields})
    if mesh.rank == 0:
        np.savez(res, **res_d)
    dist.barrier()
    dist.destroy_process_group()
    return 0


def mesh_phase(config, det, frames, max_err):
    """Phase 15 (b) and (c); returns (kernel launches of detect_dp,
    max_err, the phase's numbers)."""
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{free_port()}",
                            world_size=1, rank=0)
    try:
        mesh = make_mesh(1, device=torch.device("cuda", torch.cuda.current_device()))
        probe = torch.ones(1, device="cuda")
        dist.all_reduce(probe)  # the NCCL communicator works
        batches = mesh_batches(MESH_STEPS, "cuda")
        train, want, want_tree = mesh_steps(mesh, batches)
        frames8 = frames[:BATCH]
        suppress.launches = 0
        got = detect_dp(det.detect_batch, mesh)(frames8)
        launches = suppress.launches
        ref = det.detect_batch(frames8)
        torch.cuda.synchronize()
        same = all(torch.equal(getattr(got, f), getattr(ref, f)) for f in ref._fields)
        print(f"(b) detect_dp over the 1x1 mesh, YOLOv8x 736x1280 bf16 batch "
              f"{BATCH}: bit-equal to detect_batch {same}; nms_suppress "
              f"launches {launches}; detections {got.valid.sum(1).tolist()}",
              flush=True)
        if not same or launches != 1:
            raise AssertionError(f"(b) detect_dp: equal {same}, {launches} launches")
        max_err = kernel_on_batch("detect_dp", det.core, det.model, frames8,
                                  max_err, site="detect_dp")
    finally:
        dist.destroy_process_group()
    out = {"train_1x1": train, "detect_dp_bit_equal": same,
           "detect_dp_launches": launches}
    if torch.cuda.device_count() >= 2:
        dets8 = [d for d, _, _ in fetch(pack(ref)).rows()]
        torch.cuda.empty_cache()  # rank 0 shares this process's card
        out["multi_card"] = multi_card(batches, want, want_tree, frames8, dets8)
    else:
        print(f"multi-card: {torch.cuda.device_count()} card visible, not run",
              flush=True)
        out["multi_card"] = "not run: 1 card visible"
    return launches, max_err, out


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
    time_kernel(f"dense case, {name} (random boxes)", m, keep0, thr, site="dense")

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
    ce.epilogue.launches = 0
    staging.stats.reset()
    dets, marks = [], []
    t = time.perf_counter()
    for d in vp.detect_frames(iter(frames)):
        dets.append(d)
        if len(dets) % BATCH == 0:
            marks.append(time.perf_counter())
    launches = suppress.launches
    count_epilogue("detect", EPILOGUE_CONVS[config.player_model_name] * N_BATCHES)
    uploads = staging.stats.as_dict()
    batch_ms = [1e3 * (b - a) for a, b in zip([t] + marks[:-1], marks)]
    steady_fps = BATCH * (N_BATCHES - 1) / (marks[-1] - marks[0])
    per_frame = [len(d) for d in dets]
    print(f"ms per batch of {BATCH}: {[round(x, 2) for x in batch_ms]}", flush=True)
    print(f"frames/s after the first batch: {steady_fps:.2f}", flush=True)
    print(f"detections per frame: {per_frame}", flush=True)
    print(f"peak device memory: {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB",
          flush=True)
    print(f"nms_suppress launches over the main path: {launches}", flush=True)
    check_uploads("detect_frames", uploads)
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
    again = fetch(pack(again))
    for i, d in enumerate(dets[-BATCH:]):
        h_again = vp._filter(again.frame(i)[0])
        if not all(np.array_equal(x, y) for x, y in zip(h_again, d)):
            raise AssertionError(f"the halves differ from the main path, frame {i}")
    print("candidates + kernel + finish == detect_frames on the last batch: True",
          flush=True)
    b, k = cand.keep0.shape
    main = time_kernel(f"main-path NMS B={b} K={k}", cand.matrix, cand.keep0,
                       cand.thr, site="main")

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

    phase("4b conv epilogue: bias, SiLU and residual of every YOLOv8x conv in "
          "one kernel, against the plain sequence")
    epilogue_phase(det, frames)

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
    ce.epilogue.launches = 0
    st.syncs = st.rounds = st.fill_steps = 0
    scan_kernel.reset()
    staging.stats.reset()
    rows, outs, marks = [], [], []
    t = time.perf_counter()
    for r in vp_t.track_frames(iter(frames)):
        rows.append(r)
        if len(rows) % BATCH == 1:  # the batch's step has just run
            outs.append(vp_t.last_track_batch)
        if len(rows) % BATCH == 0:
            marks.append(time.perf_counter())
    launches_t = suppress.launches
    count_epilogue("track", EPILOGUE_CONVS[config.player_model_name] * N_BATCHES
                   + EPILOGUE_CONVS["digits"] * len(ocr_calls))
    uploads_t = staging.stats.as_dict()
    check_uploads("track_frames", uploads_t)
    syncs = st.syncs
    tracker_launches_t = scan_kernel.launches
    rounds, fills = scan_kernel.counts(dev).values()
    if syncs or tracker_launches_t != N_BATCHES:
        raise AssertionError(f"the tracker synced {syncs} times and launched "
                             f"its kernel {tracker_launches_t} times over "
                             f"{N_BATCHES} batches: it must be one launch a "
                             "batch with no host sync")
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
        "uploads": uploads_t,
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

    phase("5b tracker_scan kernel vs the plain tracker_scan on the card "
          "(T=128, D=64, batches of 8)")
    tracker_kernel = tracker_kernel_phase(inputs, kwargs, config.max_tracks)

    phase("6 TEAM_CLASSIFICATION: fit_teams, then the fused detect + track + "
          "team step through VideoProcessor.classify_frames")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on: the crop products must be f32")
    launches_c, max_err, det_team, tracker_launches_c = team_phase(
        config, frames, max_err, track_fps)

    phase("7 PUCK_DETECTION: YOLOv8s bf16 on 8 tiles of 640 per 1080p frame, "
          "VideoProcessor.puck_frames")
    launches_p, max_err = puck_phase(config, max_err)

    phase("8 rink + 2D map: the dual step (YOLOv8x 736x1280 + YOLOv8s-pose "
          "512), host ByteTrack and calibrator, VideoProcessor.classify_frames")
    launches_r, max_err, track_inputs = rink_phase(config, max_err)

    phase("9 team cascade: robust, then hybrid (MobileNetV3 f32 on the card), "
          "headless, fit_teams and classify_frames on phase 6's scene")
    launches_k, max_err = cascade_phase(config, frames, det_team, max_err)

    phase(f"10 multi-clip: {MULTICLIP_K} clips in lockstep through "
          f"MultiClipProcessor.run_frames, PLAYER_TRACKING (B = {MULTICLIP_K})")
    launches_m, max_err = multiclip_phase(config, det, max_err)

    phase("11 session: TEAM_CLASSIFICATION, save_run_state after 2 batches, "
          "load_run_state, 2 more")
    launches_s, max_err = session_phase(config, det_team, max_err)

    phase(f"12 validation: evaluate_detector ({VAL_IMAGES} images at "
          f"{VAL_PLAYER_SIZE}, conf 0.001), InTrainingEvaluator, "
          f"InTrainingPoseEvaluator ({VAL_RINK_IMAGES} rink views at "
          f"{VAL_RINK_SIZE}), bf16 and f32")
    launches_v, max_err = validation_phase(config, max_err)

    phase("13 training: (a) a YOLOv8s f32 step, card against CPU; (b) "
          "hockey_tpu_torch.train.loop, YOLOv8x 640 b16 bf16, device-data and "
          "host; (c) a cold YOLOv8n learns; (d) YOLOv8s-pose 512")
    launches_tr, max_err = training_phase(card, max_err)

    phase("14 the JAX CLIs' defaults and the last trainers: (a) train.loop with "
          "no data flag; (b) train.val with no flag; (c) the converters; (d) the "
          "embedder's step; (e) the digit net's step")
    launches_14, max_err = slice10_phase(config, vp, frames, max_err)

    phase("15 the host runtime and multi-device training and detection: (a) "
          "hockey_host.cpp (g++) against its plain versions, host ByteTrack on "
          "phase 8's detections; (b) a 1x1 mesh over NCCL: shard_train_step "
          "(YOLOv8x 640 b16 bf16) against Trainer, detect_dp against "
          "detect_batch; (c) dp 2 on two cards")
    t = time.perf_counter()
    host = host_runtime(config, track_inputs)
    launches_15, max_err, mesh_out = mesh_phase(config, det, frames, max_err)
    print(json.dumps({"slice11": {"host_runtime": host, **mesh_out,
                                  "kernel_at_sites": {"detect_dp": SITES["detect_dp"]},
                                  "seconds": round(time.perf_counter() - t, 1)}}),
          flush=True)

    phase("16 results")
    print(f"total wall time {time.perf_counter() - T0:.1f} s", flush=True)
    epilogue = EPILOGUE["sites"]["detect"]
    print(json.dumps({"kernels": [{
        "name": "nms_suppress",
        "route": "cuda",
        "source": "hockey_tpu_torch/csrc/nms_suppress.cu",
        "replaces": "hockey_tpu/ops/pallas/nms_kernel.py:24",
        "launches": (launches + launches_t + launches_c + launches_p + launches_r
                     + launches_k + launches_m + launches_s + launches_v
                     + launches_tr + launches_14 + launches_15),
        "max_abs_err": max_err,
        **main,
        "library_ms": None,
        "sites": SITES,
    }, {
        "name": "tracker_scan",
        "route": "cuda",
        "source": "hockey_tpu_torch/csrc/tracker_scan.cu",
        "replaces": None,  # no TPU kernel: XLA ops under lax.scan
        # the main paths' runs, each counted from a reset just before it
        "launches": tracker_launches_t + tracker_launches_c,
        "max_abs_err": max(s["max_abs_err"] for s in tracker_kernel.values()),
        **{k: tracker_kernel["main"][k] for k in ("ms", "call_ms", "plain_ms",
                                                  "bound_ms", "bound_by")},
        "library_ms": None,
        "sites": tracker_kernel,
    }, {
        "name": "conv_epilogue",
        "route": "cuda",
        "source": "hockey_tpu_torch/csrc/conv_epilogue.cu",
        "replaces": None,  # no TPU kernel: XLA fuses the epilogue into the conv
        # the main paths of phases 4 to 8, each counted from a reset just
        # before it
        "launches": sum(EPILOGUE["launches"].values()),
        "max_abs_err": max(v["max_abs_err"] for v in EPILOGUE["sites"].values()),
        "ms": sorted(epilogue["ms"])[1],  # device ms a batch of 8 frames
        "bound_ms": epilogue["bound_ms"],
        "bound_by": "bytes",
        "plain_ms": sorted(epilogue["library_ms"])[1],  # the plain version is
        "library_ms": sorted(epilogue["library_ms"])[1],  # PyTorch's three ops
        "launches_by_path": EPILOGUE["launches"],
        "sites": EPILOGUE["sites"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}}),
        flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--mesh-rank"]:
        sys.exit(mesh_rank(*sys.argv[2:]))
    sys.exit(main())
