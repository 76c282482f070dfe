"""The epilogue of an inference convolution: the hand-written CUDA kernel
and its plain PyTorch version.

`y = [residual +] [silu](y [+ bias])` over a conv's output `y` (N, C, H,
W): the folded bias, SiLU and a bottleneck's residual
(models/layers.py `Conv`, `Bottleneck`). Replaces no TPU kernel: the JAX
package leaves the conv and its epilogue to XLA, which fuses them. The
CUDA source is `csrc/conv_epilogue.cu`: one pass in place over `y`,
bit-equal to the plain sequence, bound by its bytes (`bound_bytes` over
the card's memory rate).

It takes bf16, f16 and f32; `y` channels_last-contiguous or
NCHW-contiguous; a `residual` of `y`'s shape, dtype and layout whose rows
(pixels in channels_last, images in NCHW) may be further apart than
`y`'s, as a C2f's `chunk` view is. Anything else raises.

Build: plain `nvcc` with ops/nms_kernel.py's flags and cache rule (no fast
math) into `build/hockey_tpu_torch/`, loaded with ctypes, at first use.
`epilogue` launches it on CUDA tensors, runs `conv_epilogue_reference` on
CPU tensors, raises on any other device, and counts its launches. Each
launch runs inside a profiler op named `conv_epilogue` (function scope,
as PyTorch's own ops are), so that a torch.profiler trace links the
kernel to that op and to the ranges around it, `forward` among them: a
ctypes launch under a `record_function` range alone is linked to none.
"""

from __future__ import annotations

import ctypes
import os
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch._C._profiler import _RecordFunctionFast

from .nms_kernel import build_library

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(_PKG_DIR, "csrc", "conv_epilogue.cu")
DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
VECTOR_BYTES = 16
MAX_LAYOUTS = 4096  # cached layouts, cleared when full


def conv_epilogue_reference(y: torch.Tensor, bias: Optional[torch.Tensor],
                            act: bool, residual: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The plain sequence the kernel replaces, op for op: the bias added
    in place over `y` as a (1, C, 1, 1) broadcast (as PyTorch's cuDNN
    convolution adds it), `F.silu`, then the bottleneck's `residual + y`."""
    if bias is not None:
        y = y.add_(bias.reshape(1, -1, 1, 1))
    if act:
        y = F.silu(y)
    return y if residual is None else residual + y


class Layout(NamedTuple):
    """`y` as `rows` rows of `len` contiguous elements, a channel being a
    run of `run` elements of a row; the residual's rows `pitch` apart;
    `vec` elements a 16-byte vector where every row, run and the pitch
    hold whole vectors, else 1."""

    rows: int
    len: int
    run: int
    pitch: int
    vec: int


def _residual_pitch(r: torch.Tensor, channels_last: bool, row_len: int) -> int:
    """The residual's row pitch in elements; raises where its strides are
    not rows of `y`'s layout."""
    n, c, h, w = r.shape
    if channels_last:  # a row per pixel
        p = next((s // m for s, m, size in ((r.stride(3), 1, w),
                                            (r.stride(2), w, h),
                                            (r.stride(0), h * w, n)) if size > 1),
                 c)
        want = (p * h * w, 1, p * w, p)
    else:  # a row per image
        p = r.stride(0) if n > 1 else row_len
        want = (p, h * w, w, 1)
    if p < row_len or any(s != x for s, x, size in zip(r.stride(), want, r.shape)
                          if size > 1):
        raise ValueError(
            f"conv_epilogue: residual strides {r.stride()} are not rows of the "
            f"output's {'channels_last' if channels_last else 'NCHW'} layout")
    return p


def layout(y: torch.Tensor, residual: Optional[torch.Tensor] = None) -> Layout:
    """The kernel's view of `y` (and `residual`); raises on a layout it
    does not take."""
    n, c, h, w = y.shape
    if y.is_contiguous(memory_format=torch.channels_last):
        rows, row_len, run, cl = n * h * w, c, 1, True
    elif y.is_contiguous():
        rows, row_len, run, cl = n, c * h * w, h * w, False
    else:
        raise ValueError(f"conv_epilogue: output strides {y.stride()} are "
                         "neither channels_last- nor NCHW-contiguous")
    pitch = row_len if residual is None else _residual_pitch(residual, cl, row_len)
    v = VECTOR_BYTES // y.element_size()
    whole = row_len % v == 0 and (run == 1 or run % v == 0) and pitch % v == 0
    return Layout(rows, row_len, run, pitch, v if whole else 1)


def check(y: torch.Tensor, bias: Optional[torch.Tensor],
          residual: Optional[torch.Tensor]) -> Layout:
    """Raises on a dtype, shape, device or layout the kernel does not take;
    returns the layout. Depends on the tensors' metadata alone."""
    if y.dtype not in DTYPES:
        raise TypeError(f"conv_epilogue: {y.dtype}; it takes {list(DTYPES)}")
    if y.dim() != 4:
        raise ValueError(f"conv_epilogue: output {tuple(y.shape)}, not (N, C, H, W)")
    for name, t, shape in (("bias", bias, (y.shape[1],)),
                           ("residual", residual, tuple(y.shape))):
        if t is None:
            continue
        if t.dtype != y.dtype:
            raise TypeError(f"conv_epilogue: {name} is {t.dtype}, output {y.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"conv_epilogue: {name} {tuple(t.shape)}, not {shape}")
        if t.device != y.device:
            raise ValueError(f"conv_epilogue: {name} on {t.device}, output on "
                             f"{y.device}")
    if bias is not None and not bias.is_contiguous():
        raise ValueError("conv_epilogue: bias is not contiguous")
    return layout(y, residual)


def vectorized(y: torch.Tensor, bias: Optional[torch.Tensor],
               residual: Optional[torch.Tensor], lay: Layout) -> bool:
    """Whether the kernel moves 16-byte vectors: the layout holds whole
    vectors and the pointers are aligned."""
    ptrs = y.data_ptr()
    for t in (bias, residual):
        if t is not None:
            ptrs |= t.data_ptr()
    return lay.vec > 1 and ptrs % VECTOR_BYTES == 0


def _metadata(t: Optional[torch.Tensor]):
    return None if t is None else (t.dtype, t.device, t.shape, t.stride())


def bound_bytes(y: torch.Tensor, bias: Optional[torch.Tensor] = None,
                residual: Optional[torch.Tensor] = None) -> int:
    """Bytes the epilogue must move: y read and written, the residual and
    the bias read."""
    return sum(t.numel() * t.element_size() for t in (y, y, residual, bias)
               if t is not None)


class EpilogueKernel:
    """Callable wrapper of the `conv_epilogue` CUDA kernel.

    `launches` counts calls that launched it (CPU calls, which run the
    plain version, do not count)."""

    def __init__(self):
        self.launches = 0
        self._fn: Optional[ctypes._CFuncPtr] = None
        self._lib = None
        # `check`'s layouts by the tensors' metadata: a forward meets the
        # same ~100 shapes every batch, and the checks cost the host more
        # than a small conv's epilogue costs the card
        self._layouts: Dict[tuple, Layout] = {}

    def load(self):
        """Build (if needed) and load the library; returns the C function."""
        if self._fn is None:
            lib = ctypes.CDLL(build_library(SOURCE, "conv_epilogue"))
            fn = lib.conv_epilogue
            fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] + \
                [ctypes.c_int64] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
            self._lib, self._fn = lib, fn
        return self._fn

    def __call__(self, y: torch.Tensor, bias: Optional[torch.Tensor], act: bool,
                 residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """`[residual +] [silu](y [+ bias])`; on CUDA written over `y` and
        returned. Use the returned tensor: on the CPU it may be another."""
        key = (_metadata(y), _metadata(bias), _metadata(residual))
        lay = self._layouts.get(key)
        if lay is None:
            if len(self._layouts) >= MAX_LAYOUTS:
                self._layouts.clear()
            lay = self._layouts[key] = check(y, bias, residual)
        if torch.is_grad_enabled() and (y.requires_grad or (
                bias is not None and bias.requires_grad) or (
                residual is not None and residual.requires_grad)):
            raise RuntimeError("conv_epilogue: a tensor requires grad; the kernel "
                               "records no autograd graph")
        if residual is not None and residual.untyped_storage().data_ptr() == \
                y.untyped_storage().data_ptr():
            raise ValueError("conv_epilogue: the residual shares the output's memory")
        device = y.device
        if device.type == "cpu":
            return conv_epilogue_reference(y, bias, act, residual)
        if device.type != "cuda":
            raise ValueError(f"conv_epilogue: tensors on {device}, not CUDA "
                             "(CPU tensors take the plain version)")
        fn = self.load()
        stream = torch._C._cuda_getCurrentRawStream(device.index)
        with _RecordFunctionFast("conv_epilogue"):
            rc = fn(y.data_ptr(), None if bias is None else bias.data_ptr(),
                    None if residual is None else residual.data_ptr(),
                    DTYPES[y.dtype], lay.rows, lay.len, lay.run, lay.pitch,
                    int(bool(act)), int(vectorized(y, bias, residual, lay)),
                    device.index, stream)
        if rc != 0:
            raise RuntimeError(f"conv_epilogue launch failed: cudaError {rc}")
        self.launches += 1
        return y


epilogue = EpilogueKernel()
