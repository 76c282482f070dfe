"""Contrastive training of the team-embedding MobileNetV3: port of
hockey_tpu/teams/embed_train.py.

The net (models/mobilenetv3.py) learns from scratch with an NT-Xent
objective on synthetic jersey designs: two jittered views of one design
(hue and pattern: solid, hoops, vertical stripes, sash or yoke, with a
random number) are a positive pair, the other designs of the batch its
negatives. The loss is the cross-entropy of the (B, B) cosine logits at
temperature 0.2 in both directions; the pair accuracy is the share of
rows whose largest logit is their own pair.

BN runs on batch statistics during training; `calibrate_bn` sets the
running statistics afterwards from 16 fresh batches. The optimizer is
optax's AdamW chain written out (train/optim.py): warmup 50, cosine to
lr * 0.05, weight decay 1e-5 on every leaf. f32 with TF32 off, on the
card unless `device='cpu'`.

`render_design` draws with cv2 (`putText`, `warpAffine`, `blur`,
`resize`), imported inside it; the step takes the rendered batches, so
it runs where cv2 is absent. The numpy random calls come in the JAX
package's order, so a seed renders the same pairs.

    python -m hockey_tpu_torch.teams.embed_train [--steps 1200] [--out F]

writes `checkpoints/team_embed.msgpack` by default (the JAX package's
checkpoint format), never into the JAX package's shipped weights.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

H, W = 64, 32  # jersey crop shape fed to the embedder during training
DEFAULT_OUT = os.path.join("checkpoints", "team_embed.msgpack")
PATTERNS = ("solid", "hoops", "stripes", "sash", "yoke")
TEMPERATURE = 0.2
WARMUP, END_FRAC, WEIGHT_DECAY = 50, 0.05, 1e-5


def sample_design(rng: np.random.Generator) -> Dict:
    base = rng.uniform(0, 255, 3)
    second = rng.uniform(0, 255, 3)
    while np.abs(base - second).sum() < 120:
        second = rng.uniform(0, 255, 3)
    return {
        "base": base,
        "second": second,
        "pattern": PATTERNS[int(rng.integers(0, len(PATTERNS)))],
    }


def render_design(rng: np.random.Generator, design: Dict) -> np.ndarray:
    """One augmented view of a jersey design: (H, W, 3) BGR uint8."""
    import cv2

    s = int(rng.integers(48, 120))
    sw = s // 2
    img = np.full((s, sw, 3), design["base"], np.float32)
    c2 = design["second"]
    p = design["pattern"]
    if p == "hoops":
        period = max(s // int(rng.integers(4, 7)), 3)
        for y in range(0, s, period * 2):
            img[y: y + period] = c2
    elif p == "stripes":
        period = max(sw // int(rng.integers(3, 6)), 2)
        for x in range(0, sw, period * 2):
            img[:, x: x + period] = c2
    elif p == "sash":
        yy, xx = np.mgrid[0:s, 0:sw]
        band = np.abs(yy - xx * (s / sw)) < s * 0.18
        img[band] = c2
    elif p == "yoke":
        img[: int(s * 0.3)] = c2
    img = img.astype(np.uint8)
    # the number varies between views: identity is the design
    if rng.uniform() < 0.8:
        col = (250, 250, 250) if design["base"].sum() < 380 else (15, 15, 15)
        cv2.putText(img, str(int(rng.integers(1, 99))),
                    (int(sw * 0.15), int(s * 0.62)),
                    cv2.FONT_HERSHEY_SIMPLEX, s / 80.0, col,
                    max(1, s // 40))
    # photometric and geometric jitter
    ang = rng.uniform(-15, 15)
    m = cv2.getRotationMatrix2D((sw / 2, s / 2), ang, rng.uniform(0.85, 1.2))
    img = cv2.warpAffine(img, m, (sw, s), borderMode=cv2.BORDER_REFLECT)
    if rng.uniform() < 0.5:
        img = cv2.blur(img, (int(rng.integers(1, 4)),) * 2)
    gain = rng.uniform(0.6, 1.3)
    img = np.clip(img.astype(np.float32) * gain + rng.uniform(-25, 25)
                  + rng.normal(0, rng.uniform(1, 8), img.shape),
                  0, 255).astype(np.uint8)
    return cv2.resize(img, (W, H))


def make_pair_batch(rng: np.random.Generator, n_designs: int
                    ) -> Tuple[np.ndarray, np.ndarray]:
    a, b = [], []
    for _ in range(n_designs):
        d = sample_design(rng)
        a.append(render_design(rng, d))
        b.append(render_design(rng, d))
    return np.stack(a), np.stack(b)


def pair_loss(net, xa: torch.Tensor, xb: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(contrastive loss, pair accuracy) of two preprocessed view batches,
    BN on batch statistics (hockey_tpu embed_train.py `loss_fn`)."""
    za = net(xa, stats=[])
    zb = net(xb, stats=[])
    za = za / (torch.linalg.vector_norm(za, dim=1, keepdim=True) + 1e-6)
    zb = zb / (torch.linalg.vector_norm(zb, dim=1, keepdim=True) + 1e-6)
    logits = za @ zb.T / TEMPERATURE  # (B, B)
    labels = torch.arange(za.shape[0], device=za.device)
    l1 = F.cross_entropy(logits, labels, reduction="none")
    l2 = F.cross_entropy(logits.T, labels, reduction="none")
    acc = (logits.argmax(dim=1) == labels).float().mean()
    return (l1 + l2).mean() / 2.0, acc


class EmbedTrainer:
    """The embedder from a JAX-layout tree, in the training form on
    `device`, and its AdamW over every leaf of the tree (the running
    statistics too, whose gradient is zero: weight decay shrinks them,
    as optax does to the JAX tree's). `step(a, b)` takes two uint8 BGR
    view batches (B, H, W, 3)."""

    def __init__(self, params: Dict, steps: int, lr: float = 1e-3,
                 device="cuda"):
        from ..models.mobilenetv3 import build_trainable
        from ..train.optim import AdamW, warmup_cosine

        self.device = torch.device(device)
        self.net = build_trainable(params, self.device)
        tree = self.net.state_dict(keep_vars=True)
        self.names, self.leaves = list(tree), list(tree.values())
        self.opt = AdamW(self.leaves,
                         warmup_cosine(0.0, lr, WARMUP, steps, lr * END_FRAC),
                         WEIGHT_DECAY)

    def preprocess(self, crops: np.ndarray) -> torch.Tensor:
        from ..models.mobilenetv3 import preprocess_bgr

        return preprocess_bgr(torch.as_tensor(crops).to(self.device))

    def grads(self, a: np.ndarray, b: np.ndarray
              ) -> Tuple[torch.Tensor, torch.Tensor, List[Optional[torch.Tensor]]]:
        """(loss, pair accuracy, each leaf's gradient or None) at the
        current weights."""
        from ..train.optim import exact_f32

        for t in self.leaves:
            t.grad = None
        with exact_f32():  # the backward too
            loss, acc = pair_loss(self.net, self.preprocess(a), self.preprocess(b))
            loss.backward()
        return loss.detach(), acc.detach(), [t.grad for t in self.leaves]

    def step(self, a: np.ndarray, b: np.ndarray) -> Tuple[float, float]:
        loss, acc, grads = self.grads(a, b)
        self.opt.step(grads)
        return float(loss), float(acc)

    def calibrate(self, batches: Sequence[np.ndarray]) -> None:
        """`calibrate_bn` over uint8 view batches."""
        from ..models.mobilenetv3 import calibrate_bn

        calibrate_bn(self.net, [self.preprocess(x) for x in batches])

    def params(self) -> Dict:
        """The JAX-layout tree (depthwise kernels HWIO with I = 1)."""
        from ..models.yolov8 import params_to_jax

        return params_to_jax(self.net)


def train(steps: int = 1200, batch: int = 48, lr: float = 1e-3,
          seed: int = 0, out: Optional[str] = DEFAULT_OUT,
          log_every: int = 50, device="cuda", params: Optional[Dict] = None) -> Dict:
    """Train from `params` (default: `init_params` from a generator seeded
    `seed`), calibrate BN on 16 fresh batches, write `out` (None: no
    file); returns the tree."""
    from ..core.device import resolve_device
    from ..models.mobilenetv3 import init_params

    device = resolve_device(device)
    if params is None:
        params = init_params(torch.Generator().manual_seed(seed))
    trainer = EmbedTrainer(params, steps, lr, device)
    rng = np.random.default_rng(seed)
    for i in range(steps):
        a, b = make_pair_batch(rng, batch)
        loss, acc = trainer.step(a, b)
        if i % log_every == 0 or i == steps - 1:
            print(f"embed step {i:5d} loss {loss:.4f} pair-acc {acc:.3f}",
                  flush=True)
    # calibrate the BN running statistics on fresh views
    trainer.calibrate([make_pair_batch(rng, batch)[0] for _ in range(16)])
    params = trainer.params()
    if out:
        from ..models.checkpoint import save_params

        save_params(out, params)
        print(f"saved {out}")
    return params


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Train the team embedder")
    ap.add_argument("--steps", type=int, default=1200)
    ap.add_argument("--batch", type=int, default=48)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=str, default=DEFAULT_OUT)
    ap.add_argument("--device", type=str, default="cuda",
                    help="cuda (default) or cpu; f32 on either")
    args = ap.parse_args(argv)
    train(steps=args.steps, batch=args.batch, lr=args.lr, seed=args.seed,
          out=args.out, device=args.device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
