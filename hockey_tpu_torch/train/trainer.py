"""The detector's train step: port of hockey_tpu/train/trainer.py.

One step is the forward with batch-statistics BN (models/layers.py), the
TAL-assigned v8 loss (train/losses.py), the gradients, optax's chain of
the JAX package written out (global-norm clip 10, weight decay 5e-4 on
the conv kernels `w` alone, SGD with Nesterov momentum 0.937 at a
warmup-cosine learning rate), then the BN running-stat update. Masters,
gradients, optimizer state and the loss are f32; the forward runs in
`TrainConfig.compute_dtype`.

A non-finite loss or gradient norm discards the step: parameters,
momentum, the schedule's count and the BN statistics stay as they were
(a bf16 overflow must not poison the weights). Deciding that reads two
numbers back from the device once per step.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from typing import Dict, Iterable

import numpy as np
import torch

from ..models.layers import Conv, trainable
from ..models.yolov8 import YoloConfig, forward_raw
from ..utils.profiling import annotate
from .losses import detection_loss

BN_MOMENTUM = 0.03  # ultralytics BatchNorm2d momentum


@dataclasses.dataclass
class TrainConfig:
    imgsz: int = 640               # notebook training resolution
    learning_rate: float = 0.01
    final_lr_frac: float = 0.01    # cosine to lr * frac (ultralytics lrf)
    warmup_steps: int = 100
    total_steps: int = 10_000
    weight_decay: float = 5e-4
    momentum: float = 0.937        # ultralytics SGD momentum
    grad_clip: float = 10.0
    compute_dtype: str = "bfloat16"  # forward/backward; masters stay f32


def learning_rate(tc: TrainConfig, count: int) -> float:
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, total, lr * frac)
    at `count`, in f32 as optax computes it. optax evaluates it at the
    count before the update, so the first step runs at 0."""
    f32 = np.float32
    warmup = max(1, min(tc.warmup_steps, tc.total_steps // 2))
    peak = f32(tc.learning_rate)
    if count < warmup:
        frac = f32(1) - f32(count) / f32(warmup)
        return float(f32(0.0 - tc.learning_rate) * frac + peak)
    decay = tc.total_steps - warmup
    alpha = f32(tc.final_lr_frac if tc.learning_rate else 0.0)
    c = f32(min(count - warmup, decay))
    cosine = f32(0.5) * (f32(1) + np.cos(f32(math.pi) * c / f32(decay)))
    return float(peak * ((f32(1) - alpha) * cosine + alpha))


def bn_convs(model: torch.nn.Module) -> Dict[str, Conv]:
    """The model's convs with a BN, by their JAX path."""
    return {m.path: m for m in model.modules()
            if isinstance(m, Conv) and m.bn is not None}


def update_bn_stats(model: torch.nn.Module, stats: Iterable,
                    momentum: float = BN_MOMENTUM) -> None:
    """Move each BN's running mean and var toward `stats` ((path, mean,
    var) triples) in place: new = (1 - momentum) * old + momentum * batch."""
    convs = bn_convs(model)
    olds, news = [], []
    for path, mean, var in stats:
        bn = convs[path].bn
        olds += [bn.mean, bn.var]
        news += [mean, var]
    if olds:
        with torch.no_grad():
            torch._foreach_mul_(olds, 1 - momentum)
            torch._foreach_add_(olds, torch._foreach_mul(news, momentum))


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (optax.global_norm)."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Trainer:
    """A YOLOv8 `model` (f32 on the training device; turned into the
    training form in place), its SGD state and optionally an EMA of it.
    `step(batch)` is hockey_tpu `make_train_step`'s step."""

    def __init__(self, cfg: YoloConfig, tc: TrainConfig, model: torch.nn.Module,
                 ema_decay: float = 0.0):
        self.cfg, self.tc = cfg, tc
        self.model = trainable(model)
        self.dtype = getattr(torch, tc.compute_dtype)
        self.named = list(model.named_parameters())
        self.params = [p for _, p in self.named]
        masters = self._masters(self.named)
        self.masters = [m for _, m in masters]
        # weight decay on conv kernels only, never BN parameters or biases
        self.opt = torch.optim.SGD(
            [{"params": [m for n, m in masters if n.split(".")[-1] == "w"],
              "weight_decay": tc.weight_decay},
             {"params": [m for n, m in masters if n.split(".")[-1] != "w"],
              "weight_decay": 0.0}],
            lr=0.0, momentum=tc.momentum, nesterov=True, dampening=0.0)
        self.count = 0  # updates applied: the schedule's count
        self.ema = EMA(model, ema_decay) if ema_decay else None

    # the steps of `step` that a sharded trainer (parallel/sharding.py)
    # replaces; here, one device
    def _masters(self, named):
        """(name, tensor the optimizer updates) of each parameter."""
        return named

    def _stats(self) -> list:
        """The train forward's BN statistics list."""
        return []

    def _global_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The global batch's sum of a loss normaliser."""
        return t

    def _grads(self):
        """The optimizer's gradients."""
        return [p.grad for p in self.params]

    def _norm(self, grads) -> torch.Tensor:
        return global_norm(grads)

    def _decide(self, metrics, gn):
        """(update?, norm under the clip?, norm, metrics) of the step."""
        ok, small = torch.stack([
            torch.isfinite(metrics["loss"]) & torch.isfinite(gn),
            gn < self.tc.grad_clip]).tolist()
        return ok, small, gn, metrics

    def _updated(self) -> None:
        """After the optimizer's update."""

    def step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One train step on a batch on the model's device: 'images'
        (B, S, S, 3) f32 in [0, 1], 'boxes', 'classes', 'mask' (and
        'keypoints'). Returns the loss's metrics with 'grad_norm' and
        'skipped' (1.0 when the update was discarded)."""
        stats = self._stats()
        with annotate("train_forward"):
            raw = forward_raw(self.model, batch["images"].to(self.dtype), stats)
        with annotate("train_loss"):
            loss, metrics = detection_loss(raw, batch, self.cfg, self.tc.imgsz,
                                           global_sum=self._global_sum)
        with annotate("train_backward"):
            for p in self.params:
                p.grad = None
            loss.backward()
        with annotate("train_update"):
            for p in self.params:  # a head the loss does not reach: zero grads
                if p.grad is None:
                    p.grad = torch.zeros_like(p)
            grads = self._grads()
            ok, small, gn, metrics = self._decide(metrics, self._norm(grads))
            if ok:
                with torch.no_grad():
                    if not small:  # optax: g / norm * clip
                        torch._foreach_div_(grads, gn)
                        torch._foreach_mul_(grads, self.tc.grad_clip)
                for g in self.opt.param_groups:
                    g["lr"] = learning_rate(self.tc, self.count)
                self.opt.step()
                self._updated()
                update_bn_stats(self.model, stats)
                self.count += 1
        if self.ema is not None:
            with annotate("train_ema"):
                self.ema.update(self.model)
        out = {k: v.detach() for k, v in metrics.items()}
        out["grad_norm"] = gn.detach()
        out["skipped"] = torch.tensor(0.0 if ok else 1.0)
        return out

    def momentum(self) -> Dict[str, torch.Tensor]:
        """The SGD momentum of each parameter by name (empty before the
        first update)."""
        return {n: self.opt.state[p]["momentum_buffer"]
                for n, p in self.model.named_parameters()
                if "momentum_buffer" in self.opt.state.get(p, {})}


class EMA:
    """An exponential moving average of a model's parameters and BN
    running statistics (hockey_tpu trainer.py:173-190): after step t,
    ema = d * ema + (1 - d) * current with d = decay * (1 - exp(-t / 2000)).
    `model` is the averaged copy, which checkpoints and evaluation use."""

    def __init__(self, model: torch.nn.Module, decay: float):
        self.decay = decay
        self.model = copy.deepcopy(model).requires_grad_(False)
        self.count = 0

    def update(self, model: torch.nn.Module) -> None:
        self.count += 1
        f32 = np.float32
        d = f32(self.decay) * (f32(1) - np.exp(-f32(self.count) / f32(2000)))
        ema = list(self.model.state_dict().values())
        cur = list(model.state_dict().values())
        with torch.no_grad():
            torch._foreach_mul_(ema, float(d))
            torch._foreach_add_(ema, torch._foreach_mul(cur, float(f32(1) - d)))


def make_bn_stats_fn(compute_dtype: str = "bfloat16"):
    """A function (model, images) -> {bn path: (batch mean, batch var)}:
    a forward without gradients in `compute_dtype` on a (B, S, S, 3)
    batch (numpy or tensor) moved to the model's device."""
    dtype = getattr(torch, compute_dtype)

    def stats_fn(model, imgs):
        dev = model.backbone["stem"].w.device
        stats = []
        with torch.no_grad():
            forward_raw(model, torch.as_tensor(imgs).to(dev, dtype), stats)
        return {p: (m, v) for p, m, v in stats}

    return stats_fn


def precise_bn(model: torch.nn.Module, stats_fn, batches) -> torch.nn.Module:
    """Precise-BN: a copy of `model` whose BN running statistics are the
    batch statistics averaged (in f64) over `batches` of clean images,
    the variance as E[var + mean^2] - E[mean]^2 (hockey_tpu
    trainer.py:208-238). Running stats EMA'd under heavy augmentation
    lag the weights and can leave a good model dead in eval mode. `model`
    is left unchanged; with no batches it is returned as it is."""
    acc_m: Dict = {}
    acc_s: Dict = {}
    n = 0
    for imgs in batches:
        for p, (m, v) in stats_fn(model, imgs).items():
            m, v = m.double(), v.double()
            acc_m[p] = acc_m.get(p, 0.0) + m
            acc_s[p] = acc_s.get(p, 0.0) + v + m ** 2
        n += 1
    if not n:
        return model
    out = copy.deepcopy(model)
    convs = bn_convs(out)
    with torch.no_grad():
        for p in acc_m:
            mu = acc_m[p] / n
            var = torch.clamp(acc_s[p] / n - mu ** 2, min=0.0)
            convs[p].bn.mean.copy_(mu.float())
            convs[p].bn.var.copy_(var.float())
    return out


def make_eval_step(cfg: YoloConfig, tc: TrainConfig):
    """Loss-only step with the running BN statistics (no update, no
    gradients): eval_step(model, batch) -> metrics."""

    def eval_step(model, batch):
        dtype = model.backbone["stem"].w.dtype
        with torch.no_grad():
            raw = forward_raw(model, batch["images"].to(dtype))
            _, metrics = detection_loss(raw, batch, cfg, tc.imgsz)
        return metrics

    return eval_step


def batch_to(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    """A batch of numpy arrays or tensors as tensors on `device`."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True)
            for k, v in batch.items()}

