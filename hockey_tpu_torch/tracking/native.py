"""The host runtime of the host ByteTrack: ctypes bindings of
csrc/hockey_host.cpp (`iou_matrix`, `solve_lsap`). Port of
hockey_tpu/tracking/native.py with its API and return conventions.

The library is built at first use with the host C++ compiler (`$CXX`,
else `g++`) at native/Makefile's flags, into `build/hockey_tpu_torch/`
under a name keyed by the source, the flags and the compiler. A failed
build or load raises with the compiler's output: there is no fallback.
Both solvers return an optimal assignment, but where costs tie scipy's
picks another one than this solver, and the tracker's ids would then
differ from the JAX package's without anyone seeing it.

`_iou_numpy` and `linear_sum_assignment_reference` (scipy's solver) are
the plain versions the tests hold the library against.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shlex
import subprocess
from typing import Optional, Tuple

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "hockey_host.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "hockey_tpu_torch")
CXX_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

_lib: Optional[ctypes.CDLL] = None


def build_library() -> str:
    """Compile csrc/hockey_host.cpp with the host C++ compiler (`$CXX`
    split as a shell would, else g++) once per (source, flags, compiler);
    returns the shared library's path. Raises RuntimeError with the
    compiler's output when the build fails."""
    cxx = tuple(shlex.split(os.environ.get("CXX") or "g++"))
    with open(SOURCE, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(
        src + " ".join(cxx + CXX_FLAGS).encode()).hexdigest()
    out = os.path.join(BUILD_DIR, f"libhockey_host_{digest[:16]}.so")
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    try:
        proc = subprocess.run([*cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                              capture_output=True, text=True, timeout=300)
    except OSError as e:
        raise RuntimeError(f"cannot run the C++ compiler {' '.join(cxx)!r} "
                           f"(set CXX): {e}") from e
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cxx)} failed ({proc.returncode}) on "
                           f"{SOURCE}:\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent process never loads a partial file
    return out


def load() -> ctypes.CDLL:
    """Build (if needed) and load the library, once per process."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build_library())
        lib.iou_matrix.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32,
            ctypes.POINTER(ctypes.c_float),
        ]
        lib.iou_matrix.restype = None
        lib.solve_lsap.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int32, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib.solve_lsap.restype = ctypes.c_int32
        _lib = lib
    return _lib


def available() -> bool:
    """Whether the library builds and loads here (the entry points raise
    where it does not)."""
    try:
        load()
    except (RuntimeError, OSError):
        return False
    return True


def iou_matrix(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) xyxy -> (N, M) f32 IoU."""
    a = np.ascontiguousarray(a, np.float32).reshape(-1, 4)
    b = np.ascontiguousarray(b, np.float32).reshape(-1, 4)
    n, m = len(a), len(b)
    lib = load()
    if n == 0 or m == 0:
        return np.zeros((n, m), np.float32)
    out = np.empty((n, m), np.float32)
    lib.iou_matrix(
        a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        b.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), m,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    return out


def _iou_numpy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The plain IoU (hockey_tpu native.py `_iou_numpy`); a degenerate pair
    divides by max(union, 1e-7) where the library gives 0."""
    if len(a) == 0 or len(b) == 0:
        return np.zeros((len(a), len(b)), np.float32)
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    aa = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    ab = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return (inter / np.maximum(aa[:, None] + ab[None, :] - inter, 1e-7)).astype(np.float32)


def linear_sum_assignment(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Minimise the sum of assigned costs; scipy's return convention
    (row indices ascending, column indices), int64. An n x m problem with
    n > m is solved transposed, its pairs then ordered by column."""
    cost = np.ascontiguousarray(cost, np.float64)
    n, m = cost.shape
    lib = load()
    if n == 0 or m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    transposed = n > m
    work = np.ascontiguousarray(cost.T) if transposed else cost
    wn, wm = work.shape
    out = np.full(wn, -1, np.int32)
    rc = lib.solve_lsap(
        work.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), wn, wm,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    if rc != 0:
        raise ValueError(f"solve_lsap failed ({rc}) on a {n}x{m} cost matrix"
                         + (" with non-finite entries"
                            if not np.isfinite(cost).all() else ""))
    rows = np.arange(wn)
    if transposed:
        return out.astype(np.int64), rows.astype(np.int64)
    return rows.astype(np.int64), out.astype(np.int64)


def linear_sum_assignment_reference(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """The plain solver: scipy's (an optimum as well, which may be another
    one where costs tie)."""
    from scipy.optimize import linear_sum_assignment as scipy_lsa

    return scipy_lsa(np.asarray(cost, np.float64))
