"""The jersey-number recognizer: port of hockey_tpu/ocr/digits.py
(`forward` as `DigitNet`, `normalize_crop`, `predict`,
`load_default_params`, and the training half).

A small convnet over 48x48 contrast-normalised gray torso crops with two
heads: the tens digit (0-9, or 10 for "single digit") and the ones digit.
The shipped checkpoint (`hockey_tpu/data/weights/jersey_digits.msgpack`)
is read in place. The net runs in f32 with TF32 off, as the JAX package
runs it at `Precision.HIGHEST`.

`normalize_crop` needs no OpenCV: the gray conversion and the 48x48
bilinear resize (`ops/gray.py`) follow OpenCV's fixed-point arithmetic for
uint8, so the crop equals the JAX package's `cv2` chain bit for bit. (The team crops'
f32 resize, `teams/base.resize_crop`, is within 1 of `cv2.resize` per
pixel; after the percentile stretch that moved 2 of 200 rendered crops
to another number.)

Training: `render_number_crop` (a flat jersey panel) and
`render_scene_number_crop` (a torso cut from generator A's player sprite,
train/scenes.py `_draw_player`) draw synthetic crops with cv2, imported
inside them; `make_batch` mixes them half and half. `DigitTrainer` is
the JAX `train`'s step on the card or the CPU: the net in the training
form (`models/layers.py trainable`), the cross-entropy of both heads,
and optax's AdamW chain written out (train/optim.py: warmup 100, cosine
to lr * 0.01, weight decay 1e-4). `train` feeds it from three producer
threads (rngs seeded `seed * 1000003 + tid`) and keeps the weights with
the best held-out exact match (`eval_exact_match`); thread interleaving
makes its batch order nondeterministic, as in the JAX package.

    python -m hockey_tpu_torch.ocr.digits [--steps 3000] [--out F]

writes `checkpoints/jersey_digits.msgpack` by default, never into the
JAX package's shipped weights.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from ..models.checkpoint import load_params, shipped_weights_path
from ..models.layers import Conv, trainable
from ..models.yolov8 import params_from_jax, params_to_jax
from ..ops.gray import gray_resize

CROP = 48
TENS_NONE = 10  # tens-head class meaning "single digit"
# (name, in, out, kernel, stride) of hockey_tpu digits.py:34-61
LAYERS = (("c0", 1, 16, 3, 1), ("c1", 16, 32, 3, 2), ("c2", 32, 64, 3, 2),
          ("c3", 64, 128, 3, 2), ("c4", 128, 192, 3, 2))
HEADS = (("tens", 11), ("ones", 10))
DEFAULT_OUT = os.path.join("checkpoints", "jersey_digits.msgpack")
WARMUP, END_FRAC, WEIGHT_DECAY = 100, 0.01, 1e-4


class DigitNet(nn.Module):
    """(N, 48, 48, 1) f32 -> (tens logits (N, 11), ones logits (N, 10)):
    five 3x3 convs with bias and SiLU, global average pooling, two 1x1
    heads without activation (hockey_tpu digits.py:48-61)."""

    def __init__(self):
        super().__init__()
        for name, cin, cout, k, stride in LAYERS:
            setattr(self, name, Conv(cin, cout, k, stride, bn=False, bias=True))
        self.tens = Conv(192, 11, 1, bn=False, bias=True, act=False)
        self.ones = Conv(192, 10, 1, bn=False, bias=True, act=False)

    @classmethod
    def from_params(cls, params: Dict) -> "DigitNet":
        """The net in eval mode from the JAX-layout tree {c0..c4, tens,
        ones: {w HWIO, b}}."""
        net = cls().eval()
        net.load_state_dict(params_from_jax(params), strict=True)
        return net

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cudnn = torch.backends.cudnn
        with cudnn.flags(enabled=cudnn.enabled, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic, allow_tf32=False):
            h = x.permute(0, 3, 1, 2)
            for name, *_ in LAYERS:
                h = getattr(self, name)(h)
            h = h.mean(dim=(2, 3), keepdim=True)
            return self.tens(h)[:, :, 0, 0], self.ones(h)[:, :, 0, 0]


def load_default_params() -> Optional[Dict]:
    """The shipped checkpoint's tree, or None where it is absent."""
    path = shipped_weights_path("jersey_digits")
    return None if path is None else load_params(path)


def normalize_crop(crop_bgr: np.ndarray) -> np.ndarray:
    """Torso crop (h, w, 3) uint8 BGR -> (48, 48, 1) f32 contrast-normalised
    gray: 5th and 95th percentiles stretched to [0, 1]
    (hockey_tpu digits.py:64-72)."""
    g = gray_resize(crop_bgr, (CROP, CROP)).astype(np.float32)
    lo, hi = np.percentile(g, 5), np.percentile(g, 95)
    g = np.clip((g - lo) / max(hi - lo, 1.0), 0.0, 1.0)
    return g[..., None].astype(np.float32)


def predict(net: DigitNet, crops: np.ndarray) -> Tuple[List[str], np.ndarray]:
    """(N, 48, 48, 1) crops -> each crop's number string and confidence
    P(tens) * P(ones): one forward on the net's device, the softmax on the
    host in f32 (hockey_tpu digits.py:75-94; no padding to a bucket, since
    eager PyTorch has no compiled shapes to keep)."""
    dev = next(net.buffers()).device
    with torch.inference_mode():
        tens_l, ones_l = net(torch.as_tensor(np.asarray(crops, np.float32)).to(dev))
    pt = torch.softmax(tens_l.float().cpu(), dim=-1).numpy()
    po = torch.softmax(ones_l.float().cpu(), dim=-1).numpy()
    t, o = pt.argmax(-1), po.argmax(-1)
    conf = pt.max(-1) * po.max(-1)
    out = [str(oi) if ti == TENS_NONE else f"{ti}{oi}" for ti, oi in zip(t, o)]
    return out, conf


# ---------------------------------------------------------------------------
# Training (hockey_tpu digits.py:35-46, 104-338)

def init_digit_params(generator: torch.Generator) -> Dict:
    """A random JAX-layout tree (He-normal HWIO kernels, zero biases, as
    hockey_tpu layers.py `conv_init`), drawn from `generator`; not the
    JAX package's `jax.random` values."""
    def conv(cin, cout, k):
        w = torch.randn((k, k, cin, cout), generator=generator) * np.sqrt(2.0 / (cin * k * k))
        return {"w": w.numpy(), "b": np.zeros(cout, np.float32)}

    tree = {name: conv(cin, cout, k) for name, cin, cout, k, _ in LAYERS}
    for name, n in HEADS:
        tree[name] = conv(192, n, 1)
    return tree


def render_number_crop(rng: np.random.Generator,
                       number: Optional[int] = None
                       ) -> Tuple[np.ndarray, int, int]:
    """One synthetic torso crop. Returns (BGR crop, tens label, ones)."""
    import cv2

    if number is None:
        # single digits get equal airtime (9/99 of uniform draws, but half
        # of real jerseys)
        if rng.uniform() < 0.45:
            number = int(rng.integers(1, 10))
        else:
            number = int(rng.integers(10, 100))
    s = int(rng.integers(24, 110))
    sw = max(int(s * rng.uniform(0.35, 1.25)), 12)  # crops aren't square
    jersey = tuple(int(v) for v in rng.uniform(0, 255, 3)) \
        if rng.uniform() < 0.75 else (int(rng.uniform(200, 255)),) * 3
    # the jersey on an ice-like background: torso crops include the
    # jersey's boundary
    ice = (int(rng.uniform(170, 245)),) * 3
    img = np.full((s, sw, 3), ice, np.uint8)
    jx1 = int(rng.uniform(0.0, 0.18) * sw)
    jx2 = sw - int(rng.uniform(0.0, 0.18) * sw)
    jy1 = int(rng.uniform(0.0, 0.15) * s)
    jy2 = s - int(rng.uniform(0.0, 0.2) * s)
    cv2.rectangle(img, (jx1, jy1), (jx2, jy2), jersey, -1)
    # fabric noise and folds
    img = np.clip(img.astype(np.int16)
                  + rng.normal(0, rng.uniform(2, 9), img.shape), 0,
                  255).astype(np.uint8)
    if rng.uniform() < 0.4:  # shoulder stripe clutter
        y = int(rng.uniform(0.05, 0.3) * s)
        cv2.line(img, (jx1, y), (jx2, y),
                 tuple(int(v) for v in rng.uniform(0, 255, 3)),
                 max(1, s // 20))
    digit_col = (250, 250, 250) if sum(jersey) < 380 else (15, 15, 15)
    if rng.uniform() < 0.15:  # outlined style
        digit_col = tuple(int(v) for v in rng.uniform(0, 255, 3))
    text = str(number)
    font = [cv2.FONT_HERSHEY_SIMPLEX, cv2.FONT_HERSHEY_DUPLEX,
            cv2.FONT_HERSHEY_TRIPLEX][int(rng.integers(0, 3))]
    scale = min(s, sw * (1.9 if len(text) == 2 else 1.1)) / 55.0 \
        * rng.uniform(0.6, 1.1)
    # stroke weight varies independently of glyph size
    th = max(1, int(scale * 2) + int(rng.integers(-1, 2)))
    (tw, thh), _ = cv2.getTextSize(text, font, scale, th)
    # the digits anywhere plausibly inside the jersey
    ox = int(rng.uniform(jx1, max(jx2 - tw, jx1 + 1)))
    oy = int(rng.uniform(jy1 + thh, max(jy2 - 2, jy1 + thh + 1)))
    cv2.putText(img, text, (ox, oy), font, scale, digit_col, th)
    # small rotation and lean
    ang = rng.uniform(-12, 12)
    m = cv2.getRotationMatrix2D((sw / 2, s / 2), ang, rng.uniform(0.9, 1.1))
    img = cv2.warpAffine(img, m, (sw, s), borderMode=cv2.BORDER_REFLECT)
    if rng.uniform() < 0.5:
        img = cv2.blur(img, (int(rng.integers(1, 4)),) * 2)
    gain = rng.uniform(0.6, 1.25)
    img = np.clip(img.astype(np.float32) * gain
                  + rng.uniform(-20, 20), 0, 255).astype(np.uint8)
    tens = number // 10 if number >= 10 else TENS_NONE
    return img, tens, number % 10


def render_scene_number_crop(rng: np.random.Generator
                             ) -> Tuple[np.ndarray, int, int]:
    """A torso crop cut from a rendered player sprite (arms and head
    edges, lean, the pants boundary), as the jersey reader sees it."""
    import cv2

    from ..train.scenes import _draw_player

    number = (int(rng.integers(1, 10)) if rng.uniform() < 0.45
              else int(rng.integers(10, 100)))
    hpx = float(rng.uniform(46, 150))
    h = int(hpx * 1.25)
    w = int(hpx * rng.uniform(0.7, 1.1))
    ice = (int(rng.uniform(170, 245)),) * 3
    img = np.full((h, w, 3), ice, np.uint8)
    img = np.clip(img.astype(np.int16)
                  + rng.normal(0, 3, img.shape), 0, 255).astype(np.uint8)
    jersey = tuple(int(v) for v in rng.uniform(0, 255, 3)) \
        if rng.uniform() < 0.75 else (int(rng.uniform(200, 255)),) * 3
    pants = tuple(int(v) for v in rng.uniform(10, 90, 3))
    foot = (w / 2 + rng.uniform(-0.08, 0.08) * w, h * 0.99)
    box = _draw_player(img, foot, hpx, jersey, pants, rng, number=number)
    x1, y1 = max(int(box[0]), 0), max(int(box[1]), 0)
    x2, y2 = min(int(box[2]), w), min(int(box[3]), h)
    bh = y2 - y1
    crop = img[y1 + int(bh * 0.2): y1 + int(bh * 0.6), x1:x2]
    if crop.size == 0:
        crop = img
    if rng.uniform() < 0.4:
        crop = cv2.blur(crop, (int(rng.integers(1, 3)),) * 2)
    gain = rng.uniform(0.7, 1.2)
    crop = np.clip(crop.astype(np.float32) * gain
                   + rng.uniform(-18, 15), 0, 255).astype(np.uint8)
    tens = number // 10 if number >= 10 else TENS_NONE
    return crop, tens, number % 10


def make_batch(rng: np.random.Generator, batch: int,
               scene_frac: float = 0.5
               ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(crops (batch, 48, 48, 1) f32, tens labels, ones labels)."""
    xs, ts, os_ = [], [], []
    for _ in range(batch):
        if rng.uniform() < scene_frac:
            img, t, o = render_scene_number_crop(rng)
        else:
            img, t, o = render_number_crop(rng)
        xs.append(normalize_crop(img))
        ts.append(t)
        os_.append(o)
    return (np.stack(xs), np.asarray(ts, np.int32),
            np.asarray(os_, np.int32))


def logits(net: DigitNet, x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Both heads' logits of a crop batch on the net's device, on the host."""
    dev = next(net.parameters(), None)
    dev = (dev if dev is not None else next(net.buffers())).device
    with torch.no_grad():
        tl, ol = net(torch.as_tensor(np.asarray(x, np.float32)).to(dev))
    return tl.float().cpu().numpy(), ol.float().cpu().numpy()


def eval_exact_match(net: DigitNet, seed: int = 424242, n: int = 2000,
                     batch: int = 250) -> float:
    """Crop-level exact-match accuracy (both digits right) on a held-out
    seeded set."""
    rng = np.random.default_rng(seed)
    correct = total = 0
    for _ in range(n // batch):
        x, t, o = make_batch(rng, batch)
        tl, ol = logits(net, x)
        correct += int(((tl.argmax(-1) == t) & (ol.argmax(-1) == o)).sum())
        total += batch
    return correct / max(total, 1)


def digit_loss(net: DigitNet, x: torch.Tensor, t: torch.Tensor, o: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the two heads' mean cross-entropies summed, exact-match accuracy)."""
    tl, ol = net(x)
    loss = F.cross_entropy(tl, t) + F.cross_entropy(ol, o)
    acc = ((tl.argmax(-1) == t) & (ol.argmax(-1) == o)).float().mean()
    return loss, acc


class DigitTrainer:
    """The digit net from a JAX-layout tree, in the training form on
    `device` (f32), with AdamW over every leaf. `step(x, t, o)` is one
    update on a `make_batch` batch."""

    def __init__(self, params: Dict, steps: int, lr: float = 1e-3, device="cuda"):
        from ..train.optim import AdamW, warmup_cosine

        self.device = torch.device(device)
        net = DigitNet()
        net.load_state_dict(params_from_jax(params), strict=True)
        self.net = trainable(net).to(self.device)
        self.names, self.leaves = map(list, zip(*self.net.named_parameters()))
        self.opt = AdamW(self.leaves,
                         warmup_cosine(0.0, lr, WARMUP, steps, lr * END_FRAC),
                         WEIGHT_DECAY)

    def grads(self, x, t, o):
        """(loss, accuracy, each leaf's gradient) at the current weights."""
        for p in self.leaves:
            p.grad = None
        from ..train.optim import exact_f32

        as_t = lambda a, dt: torch.as_tensor(np.asarray(a)).to(self.device, dt)  # noqa: E731
        with exact_f32():  # the backward too
            loss, acc = digit_loss(self.net, as_t(x, torch.float32),
                                   as_t(t, torch.int64), as_t(o, torch.int64))
            loss.backward()
        return loss.detach(), acc.detach(), [p.grad for p in self.leaves]

    def step(self, x, t, o) -> Tuple[float, float]:
        loss, acc, grads = self.grads(x, t, o)
        self.opt.step(grads)
        return float(loss), float(acc)

    def params(self) -> Dict:
        return params_to_jax(self.net)


def train(steps: int = 3000, batch: int = 128, lr: float = 1e-3,
          seed: int = 0, out: Optional[str] = None,
          log_every: int = 200, eval_every: int = 0,
          init: Optional[str] = None, device="cuda") -> Dict:
    """Train the recognizer on synthetic crops; returns the tree with the
    best held-out exact match (the last one when `eval_every` is 0).
    Three producer threads render batches while the step runs."""
    import queue
    import threading

    from ..core.device import resolve_device

    device = resolve_device(device)
    if init:
        params = load_params(init)
        print(f"initialized from {init}")
    else:
        params = init_digit_params(torch.Generator().manual_seed(seed))
    trainer = DigitTrainer(params, steps, lr, device)

    q: "queue.Queue" = queue.Queue(maxsize=8)
    stop = threading.Event()

    def producer(tid: int):
        rng = np.random.default_rng(seed * 1000003 + tid)
        while not stop.is_set():
            item = make_batch(rng, batch)
            while not stop.is_set():
                try:
                    q.put(item, timeout=1.0)
                    break
                except queue.Full:
                    pass

    workers = [threading.Thread(target=producer, args=(k,), daemon=True)
               for k in range(3)]
    for w in workers:
        w.start()
    best_acc, best_params = -1.0, None
    try:
        for i in range(steps):
            loss, acc = trainer.step(*q.get())
            if i % log_every == 0 or i == steps - 1:
                print(f"digit step {i:5d} loss {loss:.4f} acc {acc:.3f}", flush=True)
            if eval_every and (i + 1) % eval_every == 0:
                em = eval_exact_match(trainer.net)
                tag = ""
                if em > best_acc:
                    best_acc, best_params = em, trainer.params()
                    tag = " (best)"
                print(f"digit step {i:5d} EVAL exact-match {em:.4f}{tag}", flush=True)
    finally:
        stop.set()
        for w in workers:
            w.join()
    if best_params is None:
        best_params = trainer.params()
    if out:
        from ..models.checkpoint import save_params

        save_params(out, best_params)
        print(f"saved {out} (held-out exact-match {max(best_acc, 0):.4f})")
    return best_params


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Train the jersey-digit net")
    ap.add_argument("--steps", type=int, default=3000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--eval-every", type=int, default=500)
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--init", type=str, default=None,
                    help="warm-start from a checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; f32 on either")
    args = ap.parse_args(argv)
    train(steps=args.steps, batch=args.batch, out=args.out, seed=args.seed,
          eval_every=args.eval_every, init=args.init, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
