"""The jersey-digit net's training half (hockey_tpu_torch/ocr/digits.py)
against the JAX package's (hockey_tpu/ocr/digits.py, optax) on the CPU:

- `render_number_crop`, `render_scene_number_crop` (through generator
  A's `_draw_player`) and `make_batch` bit for bit on the same rng;
- `init_digit_params` has the JAX tree's leaves and shapes;
- on a batch of 16, the loss and exact-match accuracy within 1e-5 and
  every gradient within 1e-4 of the largest, then three AdamW steps
  against the jitted optax step (warmup 100, weight decay 1e-4; lr 0
  first): each leaf's update within 2e-3 of its own (L2), the
  parameters within 1e-6;
- `eval_exact_match` of the shipped weights on one batch of 250 equals
  the JAX function's;
- the CLI for 101 steps on batches of 4 writes a checkpoint outside the
  JAX package that the JAX package reads.
`train()`'s batch order depends on its threads in both packages, so it is
held to JAX through its parts.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hockey_tpu.models.checkpoint import load_params as jax_load_params  # noqa: E402
from hockey_tpu.ocr import digits as JD  # noqa: E402
from hockey_tpu_torch.models.checkpoint import flatten_tree  # noqa: E402
from hockey_tpu_torch.ocr import digits as PD  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

STEPS = 110


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def test_crops_and_batches_bit_equal():
    for fn in ("render_number_crop", "render_scene_number_crop"):
        rng_p, rng_j = np.random.default_rng(3), np.random.default_rng(3)
        for _ in range(6):
            got, want = getattr(PD, fn)(rng_p), getattr(JD, fn)(rng_j)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1:] == want[1:]
    got = PD.make_batch(np.random.default_rng(8), 12)
    want = JD.make_batch(np.random.default_rng(8), 12)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[0].shape == (12, 48, 48, 1)


def test_init_tree_has_the_jax_layout():
    mine = flatten_tree(PD.init_digit_params(torch.Generator().manual_seed(0)))
    shapes = {"c0": (3, 3, 1, 16), "c1": (3, 3, 16, 32), "c2": (3, 3, 32, 64),
              "c3": (3, 3, 64, 128), "c4": (3, 3, 128, 192), "tens": (1, 1, 192, 11),
              "ones": (1, 1, 192, 10)}
    want = {(k, "w"): s for k, s in shapes.items()}
    want.update({(k, "b"): (s[-1],) for k, s in shapes.items()})
    assert {k: v.shape for k, v in mine.items()} == want
    assert all(v.dtype == np.float32 for v in mine.values())


def jax_loss_fn(p, x, t, o):  # hockey_tpu digits.py `train.loss_fn`
    tl, ol = JD.forward(p, x)
    lt = optax.softmax_cross_entropy_with_integer_labels(tl, t).mean()
    lo = optax.softmax_cross_entropy_with_integer_labels(ol, o).mean()
    acc = jnp.mean((tl.argmax(-1) == t) & (ol.argmax(-1) == o))
    return lt + lo, acc


def test_loss_grads_and_three_steps_match_optax():
    tree = PD.init_digit_params(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(4)
    batches = [PD.make_batch(rng, 16) for _ in range(3)]
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(
        0.0, 1e-3, 100, STEPS, 1e-3 * 0.01), weight_decay=1e-4)

    @jax.jit
    def step(p, s, x, t, o):
        (loss, acc), g = jax.value_and_grad(jax_loss_fn, has_aux=True)(p, x, t, o)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss, acc, g

    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    s = opt.init(jp)
    trainer = PD.DigitTrainer(tree, STEPS, device="cpu")
    before = flatten_tree(tree)
    names = [n for n, _ in trainer.net.named_parameters()]
    for k, (x, t, o) in enumerate(batches):
        jp, s, loss_j, acc_j, g_j = step(jp, s, jnp.asarray(x), jnp.asarray(t), jnp.asarray(o))
        loss, acc, grads = trainer.grads(x, t, o)
        assert abs(float(loss) - float(loss_j)) <= 1e-5 * abs(float(loss_j))
        assert float(acc) == float(acc_j)
        g_j = flatten_tree(jax.tree_util.tree_map(np.asarray, g_j))
        scale = max(np.abs(g).max() for g in g_j.values())
        for name, g in zip(names, grads):
            g = g.numpy()
            g = g.transpose(2, 3, 1, 0) if g.ndim == 4 else g
            assert np.abs(g - g_j[tuple(name.split("."))]).max() <= 1e-4 * scale, name
        trainer.opt.step(grads)
        got = flatten_tree(trainer.params())
        want = flatten_tree(jax.tree_util.tree_map(np.asarray, jp))
        assert got.keys() == want.keys()
        for key, w in want.items():
            step_j, step_p = w - before[key], got[key] - before[key]
            assert np.linalg.norm(step_p - step_j) <= 2e-3 * np.linalg.norm(step_j), key
            assert np.abs(got[key] - w).max() <= 1e-6 * max(np.abs(w).max(), 1.0), key
        if k == 0:  # optax's first rate is 0: nothing moved but nothing else
            assert all(np.array_equal(got[key], before[key]) for key in got)


def test_eval_exact_match_of_the_shipped_weights_equals_jax():
    params = PD.load_default_params()
    net = PD.DigitNet.from_params(params)
    got = PD.eval_exact_match(net, seed=424242, n=250, batch=250)
    want = JD.eval_exact_match(jax.tree_util.tree_map(jnp.asarray, params),
                               seed=424242, n=250, batch=250)
    assert got == want and got > 0.5


def test_cli_writes_outside_the_jax_package(tmp_path):
    assert PD.DEFAULT_OUT == os.path.join("checkpoints", "jersey_digits.msgpack")
    out = str(tmp_path / "digits.msgpack")
    assert PD.main(["--steps", "101", "--batch", "4", "--eval-every", "0",
                    "--out", out, "--device", "cpu"]) == 0
    back = jax_load_params(out)
    tl, ol = JD.forward(back, jnp.zeros((2, 48, 48, 1)))
    assert tl.shape == (2, 11) and ol.shape == (2, 10)
    assert np.isfinite(np.asarray(tl)).all()
    net = PD.DigitNet.from_params(PD.load_params(out))
    assert PD.predict(net, np.zeros((2, 48, 48, 1), np.float32))[1].shape == (2,)
