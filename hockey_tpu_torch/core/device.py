"""Device selection for the port's entry points, and the memo of the
detect step's constant tensors.

Entry points take `device="cuda"` by default and run there. A caller who
wants the CPU asks for it; there is no silent fallback.
"""

from __future__ import annotations

from typing import Callable, Dict, Tuple

import numpy as np
import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (use 'cuda' or 'cpu')")
    return dev


def compute_dtype(device: torch.device, dtype=None) -> torch.dtype:
    """The served models' compute type: `dtype` if given, else bf16 on
    CUDA and f32 on the CPU."""
    return dtype or (torch.bfloat16 if device.type == "cuda" else torch.float32)


# (key, device, dtype) -> the constant tensor built for it; see
# `device_constant`
CONSTANTS: Dict[Tuple, torch.Tensor] = {}


def device_constant(key: Tuple, build: Callable[[], np.ndarray], device,
                    dtype: torch.dtype) -> torch.Tensor:
    """`build()` as a `dtype` tensor on `device`, built and copied there on
    the first call for (key, device, dtype) and returned again after.
    `key` names the constant and every shape it depends on (interpolation
    matrices, anchor grids), so a detect step's only copy to the device
    per batch is its frames."""
    k = (key, torch.device(device), dtype)
    t = CONSTANTS.get(k)
    if t is None:
        with torch.inference_mode(False), torch.no_grad():
            t = torch.from_numpy(np.ascontiguousarray(build())).to(device, dtype)
        CONSTANTS[k] = t
    return t
