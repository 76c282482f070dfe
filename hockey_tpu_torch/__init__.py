"""hockey_tpu_torch — the PyTorch/CUDA port of hockey_tpu for NVIDIA Hopper.

It mirrors the module layout of `hockey_tpu/` and keeps its own copies of
everything it needs: nothing here imports JAX or the JAX package. Entry
points (`Detector`, `VideoProcessor`, the CLI) run on CUDA unless the
caller passes `device="cpu"`; they never fall back to the CPU on their own.

It runs every mode of the JAX package. PLAYER_DETECTION: letterbox ->
YOLOv8 -> DFL decode -> NMS -> box un-mapping (`models/detector.py`), the
greedy suppression a hand-written sm_90a CUDA kernel (`ops/nms_kernel.py`,
`csrc/nms_suppress.cu`). PLAYER_TRACKING: the same step fused with the
on-device ByteTrack, one launch of the CUDA kernel of
`tracking/scan_kernel.py` (`csrc/tracker_scan.cu`) a batch, or the host
ByteTrack, with the jersey-number OCR (`ocr/`). TEAM_CLASSIFICATION, the
default mode: the fused step with the team features and the cascade of
team classifiers (`teams/`). PUCK_DETECTION: tiled detection and the puck
tracker (`slicing/`). The rink keypoints and 2D map (`models/dual.py`,
`homography/`, `rinkmap/`). Every detect step hands its batch to the host
in one copy (`models/detector.py` `pack`, `fetch`). Around them: staged
uploads (`core/staging.py`), run state and resume (`core/session.py`),
multi-clip lockstep (`multiclip.py`), the CLI's metrics and traces,
held-out validation and training (`train/`), the team embedder's and the
digit net's training, the weight converters (`models/convert.py`), the
C++ host runtime (`tracking/native.py`) and the mesh (`core/mesh.py`,
`parallel/`).
"""

__version__ = "0.1.0"
