"""Device tracing hooks: port of hockey_tpu/utils/profiling.py on
`torch.profiler` (the JAX package's `jax.profiler` trace).

`device_trace(log_dir)` records the host and, on CUDA, the device activity
of a block and writes it to `log_dir/trace.json` in the Chrome trace
format (chrome://tracing, Perfetto); it does nothing when `log_dir` is
None. `annotate(name)` names a range in that trace, or in any other
`torch.profiler` profile: every range of the port goes through it.
"""

from __future__ import annotations

import contextlib
import os
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]) -> Iterator[None]:
    if not log_dir:
        yield
        return
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


_OFF = contextlib.nullcontext()


def annotate(name: str):
    """A named range in the trace of a `torch.profiler` profile active on
    the calling thread (`device_trace`, the benchmark's traced window);
    with none active, a shared no-op context. `record_function` costs
    about 12 us per range even with no profiler running; the check costs
    under 1 us."""
    if torch.autograd._profiler_enabled():
        return record_function(name)
    return _OFF
