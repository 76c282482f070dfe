"""YOLOv8 building blocks as `nn.Module`s, for inference and training.

Port of hockey_tpu/models/layers.py. Parameter names mirror the JAX
package's parameter tree (`w`, `b`, `bn.{scale,bias,mean,var}`, a C2f's
`m.<i>`), so a JAX tree loads by name through `params_from_jax`
(models/yolov8.py). Kernels are OIHW here (the JAX package keeps HWIO);
the model runs NCHW-shaped tensors in channels_last memory, which is the
JAX package's NHWC byte order.

A module is built in the inference form, every tensor a buffer, as the
serving paths load and fold it. `trainable` turns it into the training
form in place: `w`, `b`, `bn.scale` and `bn.bias` become parameters, the
BN running `mean` and `var` stay buffers. A forward given a `stats` list
is a training forward: each BN normalises by its batch statistics
(`batch_var_mean`) and appends `(path, mean, var)` to the list, `path`
being the JAX package's name of the conv (`backbone/c2f1/m0/cv1`,
`StatsCollector`), and the train step applies the running-stat update
(train/trainer.py). Without
it, BN uses the running statistics. `fuse_conv_bn` folds either form
into an inference conv.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.conv_epilogue import epilogue as conv_epilogue

BN_EPS = 1e-3  # ultralytics BatchNorm2d eps (hockey_tpu layers.py:111)


def make_divisible(x: float, divisor: int = 8) -> int:
    return max(divisor, int(np.ceil(x / divisor) * divisor)) if x > 0 else 0


class BatchNorm(nn.Module):
    """One conv's BatchNorm: the affine `scale` and `bias` and the running
    statistics."""

    def __init__(self, c: int):
        super().__init__()
        self.register_buffer("scale", torch.ones(c))
        self.register_buffer("bias", torch.zeros(c))
        self.register_buffer("mean", torch.zeros(c))
        self.register_buffer("var", torch.ones(c))

    def folded(self):
        """(scale', bias') with y_bn = y * scale' + bias'."""
        scale = self.scale * torch.rsqrt(self.var + BN_EPS)
        return scale, self.bias - self.mean * scale


def batch_var_mean(y: torch.Tensor, stats: list):
    """(biased variance, mean) per channel of an NCHW batch: this batch's,
    or the global batch's where `stats` has a `var_mean` (a dp-sharded
    batch, parallel/sharding.py `SyncStats`)."""
    sync = getattr(stats, "var_mean", None)
    if sync is not None:
        return sync(y)
    return torch.var_mean(y, dim=(0, 2, 3), unbiased=False)


def on_card_inference(x: torch.Tensor, *tensors: Optional[torch.Tensor]) -> bool:
    """Whether a conv's epilogue takes the CUDA kernel (ops/conv_epilogue.py):
    its input is on the card and no autograd graph is wanted (grad off, or
    nothing requires it). The CPU keeps PyTorch's conv with its bias inside,
    and training keeps the plain ops, which record the graph."""
    return x.is_cuda and not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in (x, *tensors)))


class Conv(nn.Module):
    """Conv -> BN -> SiLU with symmetric k//2 padding
    (hockey_tpu layers.py:94-139 `_conv2d` + `conv_apply`). The kernel and
    bias are cast to the input's dtype, so f32 masters run a bf16 forward;
    BN statistics are f32. `path` is the conv's name in the JAX tree,
    set by the model that holds it. The inference form on the card
    (`on_card_inference`) runs the conv without its bias and then the
    bias, SiLU and residual as one CUDA kernel, bit-equal to the plain
    ops that every other forward runs."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 bn: bool = True, bias: bool = False, act: bool = True):
        super().__init__()
        self.stride, self.pad, self.act = stride, k // 2, act
        self.register_buffer("w", torch.zeros(cout, cin, k, k))
        self.bn = BatchNorm(cout) if bn else None
        self.register_buffer("b", torch.zeros(cout) if bias else None)
        self.path = "conv"

    def forward(self, x: torch.Tensor, stats: Optional[list] = None,
                residual: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The conv's output, plus `residual` (a bottleneck's input) where
        given."""
        b = None if self.b is None else self.b.to(x.dtype)
        if self.bn is None and stats is None and on_card_inference(x, self.w, b, residual):
            y = F.conv2d(x, self.w.to(x.dtype), None, self.stride, self.pad)
            return conv_epilogue(y, b, self.act, residual)
        y = F.conv2d(x, self.w.to(x.dtype), b, self.stride, self.pad)
        if self.bn is not None:
            if stats is None:
                scale, bias = self.bn.folded()
            else:  # batch statistics, biased variance, in f32
                var, mean = batch_var_mean(y.float(), stats)
                stats.append((self.path, mean.detach(), var.detach()))
                scale = self.bn.scale * torch.rsqrt(var + BN_EPS)
                bias = self.bn.bias - mean * scale
            y = (y * scale.to(y.dtype)[:, None, None]
                 + bias.to(y.dtype)[:, None, None])
        y = F.silu(y) if self.act else y
        return y if residual is None else residual + y


def trainable(model: nn.Module, kinds=(Conv,)) -> nn.Module:
    """The training form, in place: every conv's (a module of `kinds`,
    holding `w`, `b` and `bn`) `w`, `b` and BN `scale` and `bias` become
    parameters (the running statistics stay buffers). Returns `model`."""
    for m in model.modules():
        if isinstance(m, kinds):
            for owner, name in ((m, "w"), (m, "b"), (m.bn, "scale"), (m.bn, "bias")):
                t = None if owner is None else getattr(owner, name)
                if t is not None and not isinstance(t, nn.Parameter):
                    delattr(owner, name)
                    owner.register_parameter(name, nn.Parameter(t))
    return model


def fuse_conv_bn(conv: Conv) -> Conv:
    """Fold the BN into the kernel and bias in place: y = conv(x, w') + b'
    (hockey_tpu layers.py:fuse_conv_bn). The folded `w` and `b` are
    buffers, whichever form the conv was in."""
    with torch.no_grad():
        w = conv.w.detach()
        b = None if conv.b is None else conv.b.detach()
        if conv.bn is not None:
            scale, bias = conv.bn.folded()
            w = w * scale[:, None, None, None]
            b = bias if b is None else b * scale + bias
    del conv.w, conv.b
    conv.register_buffer("w", w)
    conv.register_buffer("b", b)
    conv.bn = None
    return conv


def fuse_model(model: nn.Module) -> nn.Module:
    """Fold every Conv's BN in place; returns `model`, all of whose
    convs then hold buffers."""
    for m in model.modules():
        if isinstance(m, Conv):
            fuse_conv_bn(m)
    return model


def fuse_for_inference(model: nn.Module, dtype=torch.bfloat16) -> nn.Module:
    """Fold BN, then cast every weight to the compute dtype once, so no
    forward pass re-reads f32 masters (hockey_tpu layers.py:164-176)."""
    return fuse_model(model).to(dtype)


class Bottleneck(nn.Module):
    """Two 3x3 convs with an optional residual (`add` is structural)."""

    def __init__(self, cin: int, cout: int, add: bool, e: float = 1.0):
        super().__init__()
        ch = int(cout * e)
        self.cv1 = Conv(cin, ch, 3)
        self.cv2 = Conv(ch, cout, 3)
        self.add = add

    def forward(self, x, stats=None):
        return self.cv2(self.cv1(x, stats), stats, x if self.add else None)


class C2f(nn.Module):
    """Split-transform-concat block (YOLOv8's CSP variant)."""

    def __init__(self, cin: int, cout: int, n: int, shortcut: bool):
        super().__init__()
        ch = cout // 2
        self.cv1 = Conv(cin, 2 * ch, 1)
        self.cv2 = Conv((2 + n) * ch, cout, 1)
        self.m = nn.ModuleList(Bottleneck(ch, ch, shortcut) for _ in range(n))

    def forward(self, x, stats=None):
        ys = list(self.cv1(x, stats).chunk(2, dim=1))
        for m in self.m:
            ys.append(m(ys[-1], stats))
        return self.cv2(torch.cat(ys, dim=1), stats)


class SPPF(nn.Module):
    """Spatial pyramid pooling, fast: three chained 5x5 max-pools with
    -inf padding (hockey_tpu layers.py:234-240; max_pool2d pads with -inf)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        ch = cin // 2
        self.cv1 = Conv(cin, ch, 1)
        self.cv2 = Conv(ch * 4, cout, 1)

    def forward(self, x, stats=None):
        y = self.cv1(x, stats)
        y1 = F.max_pool2d(y, 5, 1, 2)
        y2 = F.max_pool2d(y1, 5, 1, 2)
        y3 = F.max_pool2d(y2, 5, 1, 2)
        return self.cv2(torch.cat([y, y1, y2, y3], dim=1), stats)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """Nearest-neighbour 2x upsample of an NCHW tensor."""
    return F.interpolate(x, scale_factor=2, mode="nearest")

