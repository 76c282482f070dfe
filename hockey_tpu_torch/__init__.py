"""hockey_tpu_torch — the PyTorch/CUDA port of hockey_tpu for NVIDIA Hopper.

It mirrors the module layout of `hockey_tpu/` and keeps its own copies of
everything it needs: nothing here imports JAX or the JAX package. Entry
points (`Detector`, `VideoProcessor`, the CLI) run on CUDA unless the
caller passes `device="cpu"`; they never fall back to the CPU on their own.

Ported so far: PLAYER_DETECTION (letterbox -> YOLOv8 -> DFL decode -> NMS
-> box un-mapping), with the greedy NMS suppression as a hand-written
sm_90a CUDA kernel (`ops/nms_kernel.py`, `csrc/nms_suppress.cu`),
PLAYER_TRACKING (the fused detect + track step with the on-device
ByteTrack of `tracking/device_tracker.py`, or the host ByteTrack),
TEAM_CLASSIFICATION, the default mode (the same step with the team
features of `teams/`, and the segmentation team classifier),
PUCK_DETECTION (`slicing/`) with the jersey-number OCR (`ocr/`), and the
rink keypoints and 2D map (`models/dual.py`, `homography/`, `rinkmap/`).
"""

__version__ = "0.1.0"
