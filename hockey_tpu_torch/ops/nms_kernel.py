"""Greedy NMS suppression: the hand-written CUDA kernel and its plain
PyTorch version.

Replaces the Pallas TPU kernel `_suppress_kernel` via `suppress_pallas`
(hockey_tpu/ops/pallas/nms_kernel.py:24,46), which the JAX detect megastep
vmaps over frames. The CUDA source is `csrc/nms_suppress.cu`: one cluster
of 8 blocks per frame builds a suppression bitmask in the first block's
shared memory from the rows of the valid candidates, then one thread
walks the survivors only, one step per kept candidate. It is bound by
latency and instruction issue, not by its bytes (the kept rows' tails).

Build: plain `nvcc` into a C-ABI shared library under
`build/hockey_tpu_torch/` (named by the source's hash), loaded with ctypes,
at first use. `suppress` launches it on a CUDA tensor, runs
`suppress_reference` on a CPU tensor, and counts its launches.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Optional, Tuple

import torch

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "nms_suppress.cu")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hockey_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")
MAX_K = 1024  # 32 words of 32 bits per mask row


def find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    for cand in (os.path.join(home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def build_library(source: str = SOURCE, prefix: str = "nms",
                  extra_flags: Tuple[str, ...] = ()) -> str:
    """Compile `source` (csrc/nms_suppress.cu by default) once per hash of
    the source and the flags, into `lib<prefix>_<hash>.so`; returns the
    shared library's path."""
    flags = NVCC_FLAGS + tuple(extra_flags)
    with open(source, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(flags).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"lib{prefix}_{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([find_nvcc(), *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def suppress_reference(m: torch.Tensor, keep0: torch.Tensor,
                       thr: float) -> torch.Tensor:
    """Plain PyTorch greedy suppression, step for step
    hockey_tpu/ops/nms.py:_suppress_exact over a batch:
    m (B, K, K) f32, keep0 (B, K) bool -> (B, K) bool."""
    k = keep0.shape[-1]
    later = torch.arange(k, device=m.device)
    keep = keep0.clone()
    for i in range(k):
        mask = (m[:, i] > thr) & (later > i)
        keep = torch.where(keep[:, i:i + 1], keep & ~mask, keep)
    return keep


class SuppressKernel:
    """Callable wrapper of the `nms_suppress` CUDA kernel.

    `launches` counts kernel launches (CPU calls, which run the plain
    version, do not count)."""

    def __init__(self):
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._lib = None

    def load(self):
        """Build (if needed) and load the library; returns the C function."""
        if self._fn is None:
            lib = ctypes.CDLL(build_library())
            fn = lib.nms_suppress
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int, ctypes.c_int, ctypes.c_float,
                           ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, m: torch.Tensor, keep0: torch.Tensor,
                 thr: float) -> torch.Tensor:
        """m (B, K, K) f32 contiguous, keep0 (B, K) bool -> (B, K) bool."""
        if m.dtype != torch.float32 or keep0.dtype != torch.bool:
            raise TypeError(f"need f32 matrix and bool keep0, got "
                            f"{m.dtype} and {keep0.dtype}")
        if m.dim() != 3 or keep0.dim() != 2 or m.shape != (
                keep0.shape[0], keep0.shape[1], keep0.shape[1]):
            raise ValueError(f"shape mismatch: m {tuple(m.shape)}, "
                             f"keep0 {tuple(keep0.shape)}")
        device = m.device
        if device != keep0.device:
            raise ValueError(f"m on {device}, keep0 on {keep0.device}")
        if device.type == "cpu":
            return suppress_reference(m, keep0, thr)
        if device.type != "cuda":
            raise ValueError(f"unsupported device {device}")
        b, k = keep0.shape
        if k > MAX_K:
            raise ValueError(f"K={k} > {MAX_K} candidates per frame")
        if not (m.is_contiguous() and keep0.is_contiguous()):
            raise ValueError("m and keep0 must be contiguous")
        fn = self.load()
        keep = torch.empty_like(keep0)
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(m.data_ptr(), keep0.data_ptr(), keep.data_ptr(), b, k,
                float(thr), device.index, stream)
        if rc != 0:
            raise RuntimeError(f"nms_suppress launch failed: cudaError {rc}")
        self.launches += 1
        return keep


suppress = SuppressKernel()
