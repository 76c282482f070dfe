"""optax's AdamW with a warmup-cosine schedule, written out in PyTorch.

The team embedder (teams/embed_train.py) and the jersey-digit net
(ocr/digits.py) train with `optax.adamw(optax.warmup_cosine_decay_schedule(
0, lr, warmup, steps, end), weight_decay=wd)` in the JAX package. This is
that chain on a list of f32 tensors, in optax's order and not in
`torch.optim.AdamW`'s:

- the schedule is evaluated at the count before the update, so the first
  step's rate is 0 (`warmup_cosine`, in f32 as optax computes it);
- Adam's moments (b1 0.9, b2 0.999, eps 1e-8) with optax's bias
  correction, then `+ wd * p` on every leaf (BN scale and bias, and the
  running statistics the JAX tree holds, included), then `* -lr`.
"""

from __future__ import annotations

import contextlib
from typing import Callable, Iterator, List, Sequence

import numpy as np
import torch


@contextlib.contextmanager
def exact_f32() -> Iterator[None]:
    """cuDNN convolutions and CUDA matmuls in full f32 (no TF32) for the
    forward and the backward inside it, as the JAX package computes f32
    at `Precision.HIGHEST`. A module's own flags cover its forward only:
    autograd runs the backward convolutions after the module returns."""
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    saved = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            yield
    finally:
        matmul.allow_tf32 = saved


def warmup_cosine(init: float, peak: float, warmup: int, decay_steps: int,
                  end: float) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(init, peak, warmup, decay_steps,
    end): count -> the rate in f32, a linear ramp from `init` to `peak`
    over `warmup` counts, then a cosine from `peak` to `end` over the rest
    of `decay_steps`. As optax, it refuses `decay_steps <= warmup`."""
    span = decay_steps - warmup
    if span <= 0:
        raise ValueError(f"the cosine needs decay_steps ({decay_steps}) "
                         f"above warmup ({warmup})")
    f32 = np.float32
    alpha = 0.0 if peak == 0.0 else end / peak

    def schedule(count: int) -> float:
        if count < warmup:
            frac = f32(1) - f32(max(count, 0)) / f32(warmup)
            return float(f32(init - peak) * frac + f32(peak))
        c = f32(min(count - warmup, span))
        cosine = f32(0.5) * (f32(1) + np.cos(f32(np.pi) * c / f32(span)))
        return float(f32(peak) * (f32(1 - alpha) * cosine + f32(alpha)))

    return schedule


class AdamW:
    """optax.adamw(schedule, b1, b2, eps, weight_decay) over `leaves`
    (f32 tensors, updated in place). `step(grads)` applies one update;
    a leaf without a gradient passes zeros, as a leaf the loss does not
    reach has in JAX."""

    def __init__(self, leaves: Sequence[torch.Tensor],
                 schedule: Callable[[int], float], weight_decay: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.leaves: List[torch.Tensor] = list(leaves)
        self.schedule, self.wd = schedule, weight_decay
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(t) for t in self.leaves]
        self.nu = [torch.zeros_like(t) for t in self.leaves]
        self.count = 0  # updates applied: Adam's and the schedule's count

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> float:
        """One update; returns the learning rate it used."""
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(self.leaves, grads)]
        lr = self.schedule(self.count)
        self.count += 1
        f32 = np.float32
        self.mu = torch._foreach_add(torch._foreach_mul(grads, 1 - self.b1),
                                     torch._foreach_mul(self.mu, self.b1))
        sq = torch._foreach_mul(grads, grads)
        self.nu = torch._foreach_add(torch._foreach_mul(sq, 1 - self.b2),
                                     torch._foreach_mul(self.nu, self.b2))
        bc1 = float(f32(1) - f32(self.b1) ** f32(self.count))
        bc2 = float(f32(1) - f32(self.b2) ** f32(self.count))
        den = torch._foreach_sqrt(torch._foreach_div(self.nu, bc2))
        torch._foreach_add_(den, self.eps)
        upd = torch._foreach_div(torch._foreach_div(self.mu, bc1), den)
        upd = torch._foreach_add(upd, torch._foreach_mul(self.leaves, self.wd))
        torch._foreach_add_(self.leaves, torch._foreach_mul(upd, -lr))
        return lr
