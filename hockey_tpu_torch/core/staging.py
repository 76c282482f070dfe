"""Frame batches staged in page-locked host memory, and the one helper
that uploads a batch to the device.

`stage(frames)` stacks the frames like `np.stack`, but into a tensor from
PyTorch's caching host allocator, page-locked with `pin_memory`, and
returns a numpy view of it. The frames are copied one by one on a pool of
at most `WORKERS` threads made once (numpy drops the GIL while it copies).

Aliasing: the returned array's `.base` is the tensor, and every view of
the array holds the array, so a staged block stays allocated while
anything still holds a frame of it (a team-fit crop, a frame being drawn,
a batch waiting in the prefetch queue). Once the last holder is gone the
block returns to the allocator's cache, which hands it out again only
after every copy recorded on it has finished on the device. So no staged
batch is written while a frame of it or an upload from it is live, and
in the steady state no new page-locked block is allocated.

`upload(frames, device)` is the detect steps' only copy of a frame batch
to the device, inside an `upload` range: a staged batch on its way to a
CUDA device is copied from its pinned tensor with `non_blocking=True`
(the host does not wait for the copy, and the allocator records the
copy's event on the block); any other input (a plain array, a view of a
staged batch, a tensor, any copy to the CPU) takes the blocking
`torch.as_tensor(frames).to(device)`. `stats` counts both.
"""

from __future__ import annotations

import os
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np
import torch

from ..utils.profiling import annotate

# threads that copy a batch's frames into its staging block
WORKERS = min(4, os.cpu_count() or 1)


class UploadStats:
    """Counters of `upload`: batches copied from a staged pinned block
    without a host wait, and batches copied with the blocking pageable
    copy. Callers set them to 0 and read them around the work they
    measure."""

    def __init__(self):
        self.pinned_uploads = 0
        self.pageable_uploads = 0

    def reset(self) -> None:
        self.pinned_uploads = self.pageable_uploads = 0

    def as_dict(self):
        return {"pinned_uploads": self.pinned_uploads,
                "pageable_uploads": self.pageable_uploads}


stats = UploadStats()

_pool: Optional[ThreadPoolExecutor] = None
_pool_lock = threading.Lock()


def _copy_pool() -> ThreadPoolExecutor:
    global _pool
    with _pool_lock:
        if _pool is None:
            _pool = ThreadPoolExecutor(max_workers=WORKERS,
                                       thread_name_prefix="stage")
        return _pool


def stage(frames: Sequence[np.ndarray], pin_memory: bool = True) -> np.ndarray:
    """`np.stack(frames)`, bit for bit, written into a block of the
    caching host allocator (page-locked with `pin_memory`): a staged
    batch. Frames that are not all uint8 arrays of one shape are stacked
    by `np.stack` itself."""
    first = frames[0]
    if not all(isinstance(f, np.ndarray) and f.dtype == np.uint8
               and f.shape == first.shape for f in frames):
        return np.stack(frames)
    block = torch.empty((len(frames),) + first.shape, dtype=torch.uint8,
                        pin_memory=pin_memory)
    out = block.numpy()
    if len(frames) == 1 or WORKERS == 1:
        for dst, f in zip(out, frames):
            np.copyto(dst, f)
    else:
        for _ in _copy_pool().map(np.copyto, out, frames):
            pass
    return out


def staged_block(frames) -> Optional[torch.Tensor]:
    """The page-locked tensor that `frames` views whole, if `frames` is
    a staged batch; else None."""
    if not isinstance(frames, np.ndarray):
        return None
    block = frames.base
    if not (torch.is_tensor(block) and tuple(block.shape) == frames.shape
            and block.data_ptr() == frames.ctypes.data):
        return None
    return block if block.is_pinned() else None


def upload(frames, device: torch.device) -> torch.Tensor:
    """A frame batch (numpy or tensor) on `device`, in an `upload` range:
    a staged batch bound for CUDA without a host wait, anything else by
    the blocking copy."""
    with annotate("upload"):
        block = staged_block(frames) if device.type == "cuda" else None
        if block is not None:
            stats.pinned_uploads += 1
            return block.to(device, non_blocking=True)
        stats.pageable_uploads += 1
        return torch.as_tensor(frames).to(device)
