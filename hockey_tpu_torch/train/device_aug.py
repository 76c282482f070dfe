"""Device-resident training data: port of hockey_tpu/train/device_aug.py.

The pre-rendered pool is staged in device memory once (`stage_pool`,
uint8), and each step's augmentations run there: mosaic-4 as one gather,
horizontal flip, HSV gain jitter and mixup with the targets' union
compacted, all vectorised over the batch. Per step the host sends
nothing; the draws come from a `torch.Generator` on the device.

Each augmentation is split into a sampler, which draws every random value
of a batch (`sample_draws`, `sample_pose_draws`), and a pure transform of
those draws (`augment_batch`, `pose_batch`), so the transform can be held
against the JAX functions on JAX's own draws. The distributions are the
JAX package's: indices uniform over the pool, the mosaic centre uniform
in [0.35, 0.65) of the side, crop offsets and the selection uniforms in
[0, 1), HSV gains uniform in [-1, 1), and the mixup weight Beta(32, 32)
(drawn as G1 / (G1 + G2) with each Gamma(32, 1) the sum of 32 unit
exponentials, since torch's Beta sampler takes no generator).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..utils.profiling import annotate

MAX_GT = 64
H_GAIN, S_GAIN, V_GAIN = 0.015, 0.7, 0.4


def stage_pool(dataset, indices=None, device="cuda") -> Dict[str, torch.Tensor]:
    """A dataset's items in device memory: 'images' (N, S, S, 3) uint8,
    'boxes' (N, M, 4), 'classes' (N, M), 'mask' (N, M), and a pose
    dataset's 'keypoints'. One-time cost; a 2000-scene 640 px pool is
    ~2.4 GB."""
    idx = list(indices) if indices is not None else range(len(dataset))
    items = [dataset.load(int(i)) for i in idx]
    out = {"images": np.stack([(it["images"] * 255.0).astype(np.uint8)
                               for it in items])}
    for k in ("boxes", "classes", "mask", "keypoints"):
        if k in items[0]:
            out[k] = np.stack([it[k] for it in items])
    return {k: torch.from_numpy(v).to(device) for k, v in out.items()}


# ---------------------------------------------------------------------------
# HSV jitter (ultralytics hsv_h/s/v gains) on f32 images in [0, 1]; the
# channel the JAX functions call r is channel 0

def _rgb_to_hsv(x):
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    mx = torch.amax(x, dim=-1)
    mn = torch.amin(x, dim=-1)
    d = mx - mn
    safe = torch.where(d > 0, d, 1.0)
    h = torch.where(mx == r, torch.remainder((g - b) / safe, 6.0),
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(d > 0, h / 6.0, 0.0)
    s = torch.where(mx > 0, d / torch.where(mx > 0, mx, 1.0), 0.0)
    return h, s, mx


def _hsv_to_rgb(h, s, v):
    h6 = h * 6.0
    i = torch.floor(h6)
    f = h6 - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = torch.remainder(i.to(torch.int32), 6).long()
    table = torch.stack([v, q, p, t], dim=-1)          # index 0..3
    pick = torch.as_tensor([[0, 3, 2], [1, 0, 2], [2, 0, 3], [2, 1, 0],
                            [3, 2, 0], [0, 2, 1]], device=h.device)
    return torch.take_along_dim(table, pick[i], dim=-1)


def hsv_jitter(img: torch.Tensor, gains: torch.Tensor) -> torch.Tensor:
    """img (B, S, S, 3) f32 in [0, 1], gains (B, 3) uniform in [-1, 1):
    multiplicative HSV gains 1 + gain * (0.015, 0.7, 0.4)."""
    g = gains * torch.as_tensor([H_GAIN, S_GAIN, V_GAIN], device=gains.device) + 1.0
    g = g[:, None, None, :]
    h, s, v = _rgb_to_hsv(img)
    return _hsv_to_rgb(torch.remainder(h * g[..., 0], 1.0),
                       torch.clamp(s * g[..., 1], 0, 1),
                       torch.clamp(v * g[..., 2], 0, 1))


# ---------------------------------------------------------------------------
# the draws

def _beta32(gen: torch.Generator, n: int, device) -> torch.Tensor:
    """n draws of Beta(32, 32) from `gen`."""
    u = torch.rand((2, n, 32), generator=gen, device=device, dtype=torch.float64)
    g = -torch.log1p(-u).sum(-1)                        # Gamma(32, 1) each
    return (g[0] / (g[0] + g[1])).float()


def sample_draws(gen: torch.Generator, pool_size: int, batch: int,
                 mixup: bool) -> Dict[str, torch.Tensor]:
    """Every random value of one augmented batch, drawn from `gen` on its
    device: for each of the batch's items (and as many mixup partners
    after them when `mixup`), 'mos_idx' (N, 4) pool rows, 'centre' (N, 2)
    uniform in [0.35, 0.65), 'offset' (N, 4, 2) in [0, 1), 'plain_idx'
    (N,), 'sel', 'flip' (N,) in [0, 1), 'gains' (N, 3) in [-1, 1); and
    per item 'lam' (B,) Beta(32, 32) and 'mix' (B,) in [0, 1)."""
    dev = gen.device
    n = 2 * batch if mixup else batch

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=dev)

    return {
        "mos_idx": torch.randint(0, pool_size, (n, 4), generator=gen, device=dev),
        "centre": 0.35 + 0.3 * uniform(n, 2),
        "offset": uniform(n, 4, 2),
        "plain_idx": torch.randint(0, pool_size, (n,), generator=gen, device=dev),
        "sel": uniform(n),
        "flip": uniform(n),
        "gains": 2.0 * uniform(n, 3) - 1.0,
        "lam": _beta32(gen, batch, dev),
        "mix": uniform(batch),
    }


def sample_pose_draws(gen: torch.Generator, pool_size: int, batch: int
                      ) -> Dict[str, torch.Tensor]:
    """A pose batch's draws: 'idx' (B,) pool rows, 'gains' (B, 3)."""
    dev = gen.device
    return {"idx": torch.randint(0, pool_size, (batch,), generator=gen, device=dev),
            "gains": 2.0 * torch.rand((batch, 3), generator=gen, device=dev) - 1.0}


# ---------------------------------------------------------------------------
# the transforms

def _mosaic(pool, idx, centre, offset, s: int, max_gt: int):
    """Mosaic-4 of each item as one gather (hockey_tpu device_aug.py:
    _mosaic_one), vectorised over the N items: idx (N, 4), centre (N, 2)
    in [0.35, 0.65), offset (N, 4, 2) in [0, 1)."""
    n = idx.shape[0]
    c = centre * s
    cx, cy = c[:, 0], c[:, 1]
    zero = torch.zeros_like(cx)
    ox = torch.stack([zero, cx, zero, cx], 1)           # (N, 4) quadrant origin
    oy = torch.stack([zero, zero, cy, cy], 1)
    qw = torch.stack([cx, s - cx, cx, s - cx], 1)       # quadrant size
    qh = torch.stack([cy, cy, s - cy, s - cy], 1)
    sx = offset[..., 0] * (s - qw)                      # source window offset
    sy = offset[..., 1] * (s - qh)

    grid = torch.arange(s, device=idx.device, dtype=torch.float32)
    yy, xx = grid[None, :, None], grid[None, None, :]
    qid = (2 * (yy >= cy[:, None, None]).long()
           + (xx >= cx[:, None, None]).long())           # (N, S, S)
    q = lambda t: torch.gather(t, 1, qid.reshape(n, -1)).reshape(n, s, s)  # noqa: E731
    ry = torch.clamp(yy - q(oy) + q(sy), 0, s - 1).long()
    rx = torch.clamp(xx - q(ox) + q(sx), 0, s - 1).long()
    rows = torch.gather(idx, 1, qid.reshape(n, -1)).reshape(n, s, s)
    flat = pool["images"].reshape(-1, 3)
    canvas = flat[(rows * s + ry) * s + rx]             # (N, S, S, 3) uint8

    # boxes: shift by the source offset, clip to the quadrant, re-origin
    b = pool["boxes"][idx]                              # (N, 4, M, 4)
    off = torch.stack([sx, sy, sx, sy], -1)[:, :, None, :]
    org = torch.stack([ox, oy, ox, oy], -1)[:, :, None, :]
    lim = torch.stack([qw, qh, qw, qh], -1)[:, :, None, :]
    b = torch.minimum(torch.clamp(b - off, min=0.0), lim) + org
    keep = (pool["mask"][idx] & ((b[..., 2] - b[..., 0]) > 2)
            & ((b[..., 3] - b[..., 1]) > 2))
    m = b.shape[2]
    b, cls, keep = (b.reshape(n, 4 * m, 4), pool["classes"][idx].reshape(n, 4 * m),
                    keep.reshape(n, 4 * m))
    return (canvas,) + _compact(b, cls, keep, max_gt)


def _compact(boxes, classes, mask, max_gt: int):
    """Valid rows first (stable), truncated to `max_gt`."""
    order = torch.argsort((~mask).to(torch.uint8), dim=1, stable=True)[:, :max_gt]
    return (torch.gather(boxes, 1, order[..., None].expand(-1, -1, 4)),
            torch.gather(classes, 1, order), torch.gather(mask, 1, order))


def augment_batch(pool: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
                  s: int, batch: int, max_gt: int = MAX_GT,
                  mosaic_prob: float = 1.0, mixup_prob: float = 0.15,
                  flip_prob: float = 0.5, hsv: bool = True) -> Dict[str, torch.Tensor]:
    """One augmented batch from `pool` and `draws` (`sample_draws`), as
    hockey_tpu device_aug.py `make_device_batch_fn` makes it from the same
    values: each item is the mosaic where sel < mosaic_prob, else one
    pool image; flipped where flip < flip_prob; HSV-jittered; then, where
    mix < mixup_prob, blended with its partner (lam * item + (1 - lam) *
    partner) and the partner's targets filling the item's free rows.
    Returns 'images' (B, S, S, 3) f32 in [0, 1], 'boxes', 'classes',
    'mask' padded to `max_gt`."""
    mos = _mosaic(pool, draws["mos_idx"], draws["centre"], draws["offset"], s, max_gt)
    pi = draws["plain_idx"]
    plain = (pool["images"][pi], pool["boxes"][pi][:, :max_gt],
             pool["classes"][pi][:, :max_gt], pool["mask"][pi][:, :max_gt])
    use = draws["sel"] < mosaic_prob
    img, b, cls, m = (torch.where(use.reshape((-1,) + (1,) * (a.dim() - 1)), a, o)
                      for a, o in zip(mos, plain))
    img = img.float() / 255.0
    flip = draws["flip"] < flip_prob
    img = torch.where(flip[:, None, None, None], img.flip(2), img)
    bf = torch.stack([s - b[..., 2], b[..., 1], s - b[..., 0], b[..., 3]], -1)
    b = torch.where(flip[:, None, None], bf, b)
    if hsv:
        img = hsv_jitter(img, draws["gains"])
    if mixup_prob > 0:
        img, img2 = img[:batch], img[batch:]
        b, b2, cls, cls2, m, m2 = b[:batch], b[batch:], cls[:batch], cls[batch:], \
            m[:batch], m[batch:]
        lam = draws["lam"][:, None, None, None]
        do = draws["mix"] < mixup_prob
        img = torch.where(do[:, None, None, None], lam * img + (1 - lam) * img2, img)
        b, cls, m = _compact(torch.cat([b, b2], 1), torch.cat([cls, cls2], 1),
                             torch.cat([m, m2 & do[:, None]], 1), max_gt)
    return {"images": img, "boxes": b, "classes": cls, "mask": m}


def pose_batch(pool: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor],
               hsv: bool = True) -> Dict[str, torch.Tensor]:
    """A pose batch (hockey_tpu device_aug.py `make_pose_batch_fn`): pool
    rows `draws['idx']`, HSV-jittered by `draws['gains']`; no flip or
    mosaic (a flip would need a left-right landmark table)."""
    idx = draws["idx"]
    imgs = pool["images"][idx].float() / 255.0
    if hsv:
        imgs = hsv_jitter(imgs, draws["gains"])
    return {"images": imgs, "boxes": pool["boxes"][idx],
            "classes": pool["classes"][idx], "mask": pool["mask"][idx],
            "keypoints": pool["keypoints"][idx]}


def make_device_batch_fn(s: int, batch: int, max_gt: int = MAX_GT,
                         mosaic_prob: float = 1.0, mixup_prob: float = 0.15,
                         flip_prob: float = 0.5, hsv: bool = True):
    """batch_fn(pool, gen) -> an augmented batch on the pool's device."""

    def batch_fn(pool, gen):
        with annotate("augment"):
            draws = sample_draws(gen, pool["images"].shape[0], batch, mixup_prob > 0)
            return augment_batch(pool, draws, s, batch, max_gt, mosaic_prob,
                                 mixup_prob, flip_prob, hsv)

    return batch_fn


def make_pose_batch_fn(batch: int, hsv: bool = True):
    """batch_fn(pool, gen) -> a pose batch on the pool's device."""

    def batch_fn(pool, gen):
        with annotate("augment"):
            return pose_batch(pool, sample_pose_draws(
                gen, pool["images"].shape[0], batch), hsv)

    return batch_fn
