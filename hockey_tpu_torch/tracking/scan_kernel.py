"""The device tracker's batch as one CUDA kernel: the wrapper of
`csrc/tracker_scan.cu`.

The kernel replaces no TPU kernel (the JAX package runs `tracker_scan` as
XLA ops under `lax.scan`). It steps all of a batch's frames in one launch
of one block, with no host sync: the plain `tracker_scan` of
tracking/device_tracker.py, its reference, issues some 470 launches a
frame and syncs once per auction round. The source's head says what bounds
it and what its design does about that.

Build: plain `nvcc` with ops/nms_kernel.py's flags and cache rule, plus
`--fmad=false` (no contraction may change a rounding the plain version
makes), into `build/hockey_tpu_torch/`, loaded with ctypes, at first use.

`scan` launches it on CUDA tensors and raises on a device, dtype, shape or
layout it does not take: T (track slots) up to `MAX_TRACKS`, one thread
per slot, and (T, D) whose shared memory (`smem_bytes`) fits in
`MAX_SMEM`. It counts its launches and the frames it stepped; the kernel
adds the auction rounds and fill steps it ran to a small int32 buffer on
the device, which `counts` reads (a host sync: tests and smoke runs only).
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, Optional, Tuple

import torch

from ..ops.assignment import AUCTION_EPS, AUCTION_MAX_ROUNDS
from ..ops.nms_kernel import build_library

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "tracker_scan.cu")
EXTRA_FLAGS = ("--fmad=false",)
MAX_TRACKS = 256  # threads of the block, one per track slot
# the dynamic shared memory a block of an H100 may use: 227 KB (opt-in)
# less the kernel's static 160 bytes, rounded down
MAX_SMEM = 232448 - 256


def _round16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(t: int, d: int) -> int:
    """Dynamic shared memory of a launch at T slots and D detections:
    the (T, D) f32 IoU matrix and the per-slot and per-detection arrays,
    each on a 16-byte boundary in csrc/tracker_scan.cu `carve`'s order
    (about 4TD + 52D + 36T bytes). The launch passes it as `smem`."""
    return (_round16(8 * d) + _round16(4 * t * d) + _round16(16 * t)
            + _round16(16 * d) + 6 * _round16(4 * d) + 4 * _round16(4 * t)
            + _round16(4 * d) + _round16(4 * t))


# (field, dtype, shape given T) of the state, in the kernel's order
_STATE = (("mean", torch.float32, (8,)), ("cov", torch.float32, (8, 8)),
          ("track_id", torch.int32, ()), ("active", torch.bool, ()),
          ("tracked", torch.bool, ()), ("consecutive", torch.int32, ()),
          ("activated", torch.bool, ()), ("missed", torch.int32, ()),
          ("class_id", torch.int32, ()), ("score", torch.float32, ()),
          ("next_id", torch.int32, None))
_INPUTS = (("boxes", torch.float32, (4,)), ("scores", torch.float32, ()),
           ("classes", torch.int32, ()), ("valid", torch.bool, ()))


class _Args(ctypes.Structure):
    """csrc/tracker_scan.cu `ScanArgs`, field for field."""

    _fields_ = ([(f, ctypes.c_void_p) for f, _, _ in _STATE]
                + [(f, ctypes.c_void_p) for f, _, _ in _INPUTS]
                + [(f + "_o", ctypes.c_void_p) for f, _, _ in _STATE]
                + [("det_tid", ctypes.c_void_p), ("counters", ctypes.c_void_p)]
                + [(f, ctypes.c_int) for f in (
                    "B", "T", "D", "smem", "max_time_lost", "min_consecutive",
                    "max_rounds", "stage3", "contain_veto", "dup_kill",
                    "lost_dup_kill")]
                + [(f, ctypes.c_float) for f in (
                    "activation_thresh", "gate1", "gate2", "reacquire_floor",
                    "veto_iomin", "dup_iomin", "lost_dup_iomin", "eps")])


def check_shapes(state, boxes, scores, classes, valid) -> Tuple[int, int, int]:
    """(B, T, D) of a launch; raises on what the kernel does not take."""
    dev = boxes.device
    if boxes.dim() != 3:
        raise ValueError(f"tracker_scan kernel: boxes {tuple(boxes.shape)}, "
                         "not (B, D, 4)")
    b, d = boxes.shape[:2]
    t = state.mean.shape[0]
    named = ([(f, getattr(state, f), dt, None if s is None else (t, *s))
              for f, dt, s in _STATE]
             + [(f, x, dt, (b, d, *s)) for (f, dt, s), x in
                zip(_INPUTS, (boxes, scores, classes, valid))])
    for f, x, dt, shape in named:
        if x.dtype != dt:
            raise TypeError(f"tracker_scan kernel: {f} is {x.dtype}, not {dt}")
        if tuple(x.shape) != (shape or ()):
            raise ValueError(f"tracker_scan kernel: {f} {tuple(x.shape)}, "
                             f"not {shape or ()}")
        if x.device != dev:
            raise ValueError(f"tracker_scan kernel: {f} on {x.device}, "
                             f"boxes on {dev}")
        if not x.is_contiguous():
            raise ValueError(f"tracker_scan kernel: {f} is not contiguous")
    if not 0 < t <= MAX_TRACKS:
        raise ValueError(f"tracker_scan kernel: T={t} track slots; it takes "
                         f"1 to {MAX_TRACKS}, one thread per slot")
    if d < 1 or smem_bytes(t, d) > MAX_SMEM:
        raise ValueError(
            f"tracker_scan kernel: T={t} slots by D={d} detections need "
            f"{smem_bytes(t, d)} bytes of shared memory; a block has "
            f"{MAX_SMEM} (about 4TD + 52D + 36T bytes must fit)")
    return b, t, d


class ScanKernel:
    """Callable wrapper of the `tracker_scan` CUDA kernel.

    `launches` counts kernel launches and `frames` the frames they
    stepped; `counts(device)` reads the auction rounds and fill steps the
    kernel ran on that device."""

    def __init__(self):
        self.launches = 0
        self.frames = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._lib = None
        self._counters: Dict[torch.device, torch.Tensor] = {}

    def load(self):
        """Build (if needed) and load the library; returns the C function."""
        if self._fn is None:
            lib = ctypes.CDLL(build_library(SOURCE, "tracker_scan", EXTRA_FLAGS))
            fn = lib.tracker_scan
            fn.argtypes = [ctypes.POINTER(_Args), ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def _buffer(self, device: torch.device) -> torch.Tensor:
        if device not in self._counters:
            with torch.inference_mode(False):
                self._counters[device] = torch.zeros(2, dtype=torch.int32,
                                                     device=device)
        return self._counters[device]

    def counts(self, device="cuda") -> Dict[str, int]:
        """{"rounds", "fill_steps"} the kernel ran on `device` since the
        last `reset` (a host sync)."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        buf = self._counters.get(device)
        if buf is None:
            return {"rounds": 0, "fill_steps": 0}
        rounds, fills = buf.tolist()
        return {"rounds": rounds, "fill_steps": fills}

    def reset(self):
        self.launches = self.frames = 0
        for buf in self._counters.values():
            buf.zero_()

    def __call__(self, state, boxes, scores, classes, valid, *,
                 activation_thresh: float, match_thresh: float,
                 low_gate: float, max_time_lost: int, min_consecutive: int,
                 lost_reacquire_floor: float, duplicate_kill_iomin: float,
                 lost_dup_kill_iomin: float, init_contain_veto: float):
        """One launch over the B frames: (state fields in TrackState's
        order, det_track_ids (B, D) int32). The state given is not written."""
        b, t, d = check_shapes(state, boxes, scores, classes, valid)
        dev = boxes.device
        out = [torch.empty_like(getattr(state, f)) for f, _, _ in _STATE]
        tids = torch.empty((b, d), dtype=torch.int32, device=dev)
        args = _Args(
            *(getattr(state, f).data_ptr() for f, _, _ in _STATE),
            *(x.data_ptr() for x in (boxes, scores, classes, valid)),
            *(x.data_ptr() for x in out), tids.data_ptr(),
            self._buffer(dev).data_ptr(),
            b, t, d, smem_bytes(t, d), int(max_time_lost), int(min_consecutive),
            AUCTION_MAX_ROUNDS, lost_reacquire_floor > 0.0,
            init_contain_veto > 0.0, duplicate_kill_iomin > 0.0,
            lost_dup_kill_iomin > 0.0,
            activation_thresh, 1.0 - match_thresh, 1.0 - low_gate,
            lost_reacquire_floor, init_contain_veto, duplicate_kill_iomin,
            lost_dup_kill_iomin, AUCTION_EPS)
        self._launch(args, dev)
        self.launches += 1
        self.frames += b
        return tuple(out), tids

    def _launch(self, args: _Args, device: torch.device):
        if device.type != "cuda":
            raise ValueError(f"tracker_scan kernel: tensors on {device}, "
                             "not CUDA (CPU tensors take the plain version)")
        fn = self.load()
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ctypes.byref(args), device.index, stream)
        if rc != 0:
            raise RuntimeError(f"tracker_scan launch failed: cudaError {rc}")


scan = ScanKernel()
