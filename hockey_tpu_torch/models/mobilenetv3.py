"""MobileNetV3-Small feature extractor: port of
hockey_tpu/models/mobilenetv3.py (`embed`, `preprocess_bgr`,
`load_default_params`, `init_params`).

The hybrid and robust team classifiers embed jersey crops with it: eleven
inverted residual blocks (depthwise convs as grouped `conv2d`,
squeeze-excite, hard-swish), a 1x1 head to 576 channels and global
average pooling (the reference's torchvision mobilenet_v3_small without
its classifier, team_hybrid.py:24-28).

Weights: the JAX package's shipped contrastive-trained checkpoint
(`hockey_tpu/data/weights/team_embed.msgpack`), read in place by the
port's own decoder (models/checkpoint.py); BN is folded into the kernels
at load. It runs in f32 with TF32 off, as the JAX `embed` runs f32 convs
at `Precision.HIGHEST`. `init_params` draws a random tree from a
`torch.Generator`; its values do not equal the JAX package's
`jax.random` draws, and the shipped weights are the default.

The training form (teams/embed_train.py): `build_trainable` keeps BN
unfolded and makes the kernels, biases and BN affine parameters
(`models/layers.py trainable`), so the serving path above is untouched.
A forward given a `stats` list normalises each BN by its batch
statistics (biased variance over N, H and W, in f32, eps 1e-3) and
appends `(mean, var)` in call order, as the JAX `_conv_bn(stats=...)`
does; `calibrate_bn` sets the running statistics from such forwards, and
`convert_torchvision` maps a torchvision `mobilenet_v3_small` state dict.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from .checkpoint import load_params, shipped_weights_path
from .layers import BatchNorm, make_divisible, trainable
from .yolov8 import params_from_jax

# (kernel, expanded, out, use_se, use_hswish, stride): torchvision
# mobilenet_v3_small's inverted-residual settings (hockey_tpu
# mobilenetv3.py:28-40)
BLOCKS = (
    (3, 16, 16, True, False, 2),
    (3, 72, 24, False, False, 2),
    (3, 88, 24, False, False, 1),
    (5, 96, 40, True, True, 2),
    (5, 240, 40, True, True, 1),
    (5, 240, 40, True, True, 1),
    (5, 120, 48, True, True, 1),
    (5, 144, 48, True, True, 1),
    (5, 288, 96, True, True, 2),
    (5, 576, 96, True, True, 1),
    (5, 576, 96, True, True, 1),
)
FEATURE_DIM = 576
BN_EPS = 1e-3  # hockey_tpu mobilenetv3.py `_conv_bn`

IMAGENET_MEAN = np.asarray([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.asarray([0.229, 0.224, 0.225], np.float32)


def hswish(x: torch.Tensor) -> torch.Tensor:
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x: torch.Tensor) -> torch.Tensor:
    return F.relu6(x + 3.0) / 6.0


class ConvBN(nn.Module):
    """Conv with symmetric k//2 padding, then its BN (or a bias), as
    hockey_tpu mobilenetv3.py `_conv_bn` in inference. `fold` moves the BN
    into the kernel and a bias."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1,
                 groups: int = 1, bn: bool = True, bias: bool = False):
        super().__init__()
        self.stride, self.pad, self.groups = stride, k // 2, groups
        self.register_buffer("w", torch.zeros(cout, cin // groups, k, k))
        self.bn = BatchNorm(cout) if bn else None
        self.register_buffer("b", torch.zeros(cout) if bias else None)

    def fold(self) -> None:
        if self.bn is None:
            return
        scale = self.bn.scale * torch.rsqrt(self.bn.var + BN_EPS)
        self.w = self.w * scale[:, None, None, None]
        self.b = self.bn.bias - self.bn.mean * scale
        self.bn = None

    def forward(self, x: torch.Tensor, stats: Optional[list] = None) -> torch.Tensor:
        y = F.conv2d(x, self.w, self.b, self.stride, self.pad, 1, self.groups)
        if self.bn is not None:
            if stats is None:
                mean, var = self.bn.mean, self.bn.var
            else:  # batch statistics, biased variance, in f32
                var, mean = torch.var_mean(y.float(), dim=(0, 2, 3), unbiased=False)
                stats.append((mean.detach(), var.detach()))
            scale = self.bn.scale * torch.rsqrt(var + BN_EPS)
            y = (y * scale[:, None, None]
                 + (self.bn.bias - mean * scale)[:, None, None])
        return y


class SqueezeExcite(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        sq = make_divisible(c // 4, 8)
        self.fc1 = ConvBN(c, sq, bn=False, bias=True)
        self.fc2 = ConvBN(sq, c, bn=False, bias=True)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        s = y.mean(dim=(2, 3), keepdim=True)
        return y * hsigmoid(self.fc2(F.relu(self.fc1(s))))


class Block(nn.Module):
    """Inverted residual: 1x1 expand (where the width changes), k x k
    depthwise, squeeze-excite, 1x1 project, and the residual at stride 1
    with equal widths."""

    def __init__(self, cin: int, k: int, exp: int, out: int, se: bool,
                 hs: bool, stride: int):
        super().__init__()
        self.act = hswish if hs else F.relu
        self.expand = ConvBN(cin, exp) if exp != cin else None
        self.dw = ConvBN(exp, exp, k, stride, groups=exp)
        self.se = SqueezeExcite(exp) if se else None
        self.project = ConvBN(exp, out)
        self.residual = stride == 1 and cin == out

    def forward(self, x: torch.Tensor, stats: Optional[list] = None) -> torch.Tensor:
        y = x
        if self.expand is not None:
            y = self.act(self.expand(y, stats))
        y = self.act(self.dw(y, stats))
        if self.se is not None:
            y = self.se(y)
        y = self.project(y, stats)
        return y + x if self.residual else y


class MobileNetV3(nn.Module):
    """(B, H, W, 3) ImageNet-normalised RGB f32 -> (B, 576) embeddings
    (hockey_tpu mobilenetv3.py `embed`). With `stats` a list, BN runs on
    batch statistics and records them (the training forward)."""

    def __init__(self):
        super().__init__()
        self.stem = ConvBN(3, 16, 3, 2)
        blocks, cin = [], 16
        for k, exp, out, se, hs, stride in BLOCKS:
            blocks.append(Block(cin, k, exp, out, se, hs, stride))
            cin = out
        self.blocks = nn.ModuleList(blocks)
        self.head = ConvBN(cin, FEATURE_DIM)

    def fold(self) -> "MobileNetV3":
        for m in self.modules():
            if isinstance(m, ConvBN):
                m.fold()
        return self

    def forward(self, x: torch.Tensor, stats: Optional[list] = None) -> torch.Tensor:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            y = hswish(self.stem(x.permute(0, 3, 1, 2).contiguous(), stats))
            for b in self.blocks:
                y = b(y, stats)
            return hswish(self.head(y, stats)).mean(dim=(2, 3))

    def bn_nodes(self) -> List[BatchNorm]:
        """The BNs in the order a forward records their statistics."""
        return [m.bn for m in self.modules()
                if isinstance(m, ConvBN) and m.bn is not None]


def init_params(generator: torch.Generator) -> Dict:
    """A random JAX-layout tree (He-normal HWIO kernels, identity BN, zero
    biases, as hockey_tpu layers.py `conv_init`), drawn from `generator`.
    Not the JAX package's `jax.random` values."""

    def normal(shape, fan_in):
        return (torch.randn(shape, generator=generator)
                * np.sqrt(2.0 / fan_in)).numpy()

    def bn(c):
        return {"scale": np.ones(c, np.float32), "bias": np.zeros(c, np.float32),
                "mean": np.zeros(c, np.float32), "var": np.ones(c, np.float32)}

    def conv(cin, cout, k=1, with_bn=True, bias=False):
        p = {"w": normal((k, k, cin, cout), cin * k * k)}
        if with_bn:
            p["bn"] = bn(cout)
        if bias:
            p["b"] = np.zeros(cout, np.float32)
        return p

    params: Dict = {"stem": conv(3, 16, 3)}
    blocks, cin = [], 16
    for k, exp, out, se, _, _ in BLOCKS:
        b: Dict = {}
        if exp != cin:
            b["expand"] = conv(cin, exp)
        b["dw"] = {"w": normal((k, k, 1, exp), k * k), "bn": bn(exp)}
        if se:
            sq = make_divisible(exp // 4, 8)
            b["se"] = {"fc1": conv(exp, sq, with_bn=False, bias=True),
                       "fc2": conv(sq, exp, with_bn=False, bias=True)}
        b["project"] = conv(exp, out)
        blocks.append(b)
        cin = out
    params["blocks"] = blocks
    params["head"] = conv(cin, FEATURE_DIM)
    return params


def load_default_params() -> Optional[Dict]:
    """The shipped checkpoint's tree, or None where it is absent."""
    path = shipped_weights_path("team_embed")
    return None if path is None else load_params(path)


def build_embedder(params: Dict, device) -> MobileNetV3:
    """The net in eval mode on `device` from a JAX-layout tree of numpy
    arrays (`params_from_jax` carries it across), BN folded, f32."""
    net = MobileNetV3().eval()
    net.load_state_dict(params_from_jax(params), strict=True)
    return net.fold().to(device)


def preprocess_bgr(crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR on [0, 255] -> ImageNet-normalised RGB f32
    (the torchvision transform of team_hybrid.py:31-36)."""
    rgb = crops.flip(-1).float() / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=crops.device)
    std = torch.as_tensor(IMAGENET_STD, device=crops.device)
    return (rgb - mean) / std


def embed(net: MobileNetV3, crops: torch.Tensor) -> torch.Tensor:
    """(N, h, w, 3) BGR crops on the net's device -> (N, 576) f32."""
    with torch.inference_mode():
        return net(preprocess_bgr(crops))


# ---------------------------------------------------------------------------
# The training form (hockey_tpu mobilenetv3.py:87-113, 152-176, 203-246)

def build_trainable(params: Dict, device) -> MobileNetV3:
    """The net from a JAX-layout tree on `device`, f32, BN unfolded, in
    the training form: kernels, biases and BN `scale` and `bias` are
    parameters, the running statistics buffers."""
    net = MobileNetV3()
    net.load_state_dict(params_from_jax(params), strict=True)
    return trainable(net, (ConvBN,)).to(device)


def calibrate_bn(net: MobileNetV3, batches: Iterable) -> MobileNetV3:
    """Set the running statistics from batch-statistics forwards over
    `batches` (preprocessed (B, H, W, 3) arrays or tensors), in place:
    each BN's mean and var are the averages, in f64, of the batches' means
    and variances (not pooled over all images), as the JAX
    `calibrate_bn` computes them. Needed after batch-statistics training,
    which tracks no running statistics."""
    dev = next(net.parameters()).device
    sums, n = None, 0
    with torch.no_grad():
        for x in batches:
            stats: List = []
            x = x if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float32))
            net(x.to(dev), stats=stats)
            vals = [(m.cpu().double(), v.cpu().double()) for m, v in stats]
            sums = vals if sums is None else [
                (sm + m, sv + v) for (sm, sv), (m, v) in zip(sums, vals)]
            n += 1
        for bn, (m, v) in zip(net.bn_nodes(), sums):
            bn.mean.copy_((m / n).float())
            bn.var.copy_((v / n).float())
    return net


def convert_torchvision(sd) -> Dict:
    """A torchvision `mobilenet_v3_small` state dict (tensors or numpy
    arrays) -> the JAX-layout tree of f32 numpy arrays. torchvision's
    `features.0` is the stem, `features.1`-`features.11` the blocks and
    `features.12` the head conv; its classifier is dropped."""

    def a(t):
        if hasattr(t, "detach"):
            t = t.detach().cpu().float().numpy()
        return np.asarray(t, np.float32)

    def cw(t):  # OIHW -> HWIO (depthwise: (exp, 1, k, k) -> (k, k, 1, exp))
        return np.ascontiguousarray(np.transpose(a(t), (2, 3, 1, 0)))

    def bn(prefix):
        return {"scale": a(sd[f"{prefix}.weight"]), "bias": a(sd[f"{prefix}.bias"]),
                "mean": a(sd[f"{prefix}.running_mean"]),
                "var": a(sd[f"{prefix}.running_var"])}

    def conv_bn(prefix):
        return {"w": cw(sd[f"{prefix}.0.weight"]), "bn": bn(f"{prefix}.1")}

    params: Dict = {"stem": conv_bn("features.0")}
    blocks, cin = [], 16
    for i, (k, exp, out, se, _, _) in enumerate(BLOCKS, start=1):
        base, j, b = f"features.{i}.block", 0, {}
        if exp != cin:
            b["expand"] = conv_bn(f"{base}.{j}")
            j += 1
        b["dw"] = conv_bn(f"{base}.{j}")
        j += 1
        if se:
            b["se"] = {fc: {"w": cw(sd[f"{base}.{j}.{fc}.weight"]),
                            "b": a(sd[f"{base}.{j}.{fc}.bias"])}
                       for fc in ("fc1", "fc2")}
            j += 1
        b["project"] = conv_bn(f"{base}.{j}")
        blocks.append(b)
        cin = out
    params["blocks"] = blocks
    params["head"] = conv_bn("features.12")
    return params
