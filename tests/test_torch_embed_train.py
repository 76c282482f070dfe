"""The team embedder's training (hockey_tpu_torch/teams/embed_train.py,
models/mobilenetv3.py's training form, train/optim.py) against the JAX
package's (hockey_tpu/teams/embed_train.py, models/mobilenetv3.py,
optax) on the CPU, in f32, on 6 designs a batch:

- `make_pair_batch` bit for bit;
- the batch-statistics forward: the recorded means and variances, in the
  JAX call order, within 1e-5 of each's scale, the embeddings within 2e-5
  of theirs, the loss and pair accuracy within 1e-5, every leaf's
  gradient within 1e-4 of the largest gradient;
- three AdamW steps against the jitted optax step, the schedule at
  counts 0, 1, 2 (lr 0 first): each leaf's update within 2e-3 of that
  leaf's own update (L2; measured 1.1e-3 at most) and the parameters
  within 1e-6, the running statistics shrunk by the weight decay as
  optax shrinks the JAX tree's; the 11 leaves whose gradient is rounding
  noise on both sides (the project convs' BN biases, 0 in exact
  arithmetic) only bounded by Adam's step;
- `warmup_cosine` against optax at every count of the JAX defaults, and
  `AdamW`'s decay of a leaf without gradient;
- `calibrate_bn` against the JAX function (the mean of the batches'
  variances, not the pooled variance) within 1e-5 relative;
- the CLI for 52 steps on 2 designs writes a checkpoint outside the JAX
  package that the JAX package reads.

The trees start from the port's `init_params` (the JAX one draws for
~20 s eagerly); both sides take the same tree.
"""

import os

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from hockey_tpu.models import mobilenetv3 as JM  # noqa: E402
from hockey_tpu.models.checkpoint import load_params as jax_load_params  # noqa: E402
from hockey_tpu.teams import embed_train as JE  # noqa: E402
from hockey_tpu_torch.models import mobilenetv3 as PM  # noqa: E402
from hockey_tpu_torch.models.checkpoint import flatten_tree  # noqa: E402
from hockey_tpu_torch.teams import embed_train as PE  # noqa: E402
from hockey_tpu_torch.train.optim import AdamW, warmup_cosine  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

N, STEPS = 6, 60


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def leaf_key(name):
    return tuple(name.split("."))


def as_tree_layout(name, t):
    a = t.detach().cpu().numpy()
    return a.transpose(2, 3, 1, 0) if name.endswith(".w") and a.ndim == 4 else a


@pytest.fixture(scope="module")
def setup():
    tree = PM.init_params(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(1)
    batches = [PE.make_pair_batch(rng, N) for _ in range(3)]
    return tree, batches


def jax_loss_fn(p, xa, xb):  # hockey_tpu embed_train.py `loss_fn`
    za = JM.embed(p, xa, stats=[])
    zb = JM.embed(p, xb, stats=[])
    za = za / (jnp.linalg.norm(za, axis=1, keepdims=True) + 1e-6)
    zb = zb / (jnp.linalg.norm(zb, axis=1, keepdims=True) + 1e-6)
    logits = za @ zb.T / 0.2
    labels = jnp.arange(za.shape[0])
    l1 = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    l2 = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
    acc = jnp.mean(logits.argmax(axis=1) == labels)
    return (l1 + l2).mean() / 2.0, acc


@jax.jit
def jax_embed_with_stats(p, x):
    """JAX `embed` with batch statistics, jitted: (embeddings, stats)."""
    stats = []
    return JM.embed(p, x, stats=stats), stats


@pytest.fixture(scope="module")
def jax_steps(setup):
    """Three jitted optax steps from the tree: (loss, acc, grads, params
    after) each."""
    tree, batches = setup
    opt = optax.adamw(optax.warmup_cosine_decay_schedule(0.0, 1e-3, 50, STEPS, 1e-3 * 0.05),
                      weight_decay=1e-5)

    @jax.jit
    def step(p, s, xa, xb):
        (loss, acc), g = jax.value_and_grad(jax_loss_fn, has_aux=True)(p, xa, xb)
        up, s = opt.update(g, s, p)
        return optax.apply_updates(p, up), s, loss, acc, g

    p = jax.tree_util.tree_map(jnp.asarray, tree)
    s, out = opt.init(p), []
    for a, b in batches:
        p, s, loss, acc, g = step(p, s, JM.preprocess_bgr(jnp.asarray(a)),
                                  JM.preprocess_bgr(jnp.asarray(b)))
        out.append((float(loss), float(acc), flatten_tree(jax.tree_util.tree_map(np.asarray, g)),
                    flatten_tree(jax.tree_util.tree_map(np.asarray, p))))
    return out


def test_pair_batch_bit_equal():
    for seed in (0, 5):
        got = PE.make_pair_batch(np.random.default_rng(seed), N)
        want = JE.make_pair_batch(np.random.default_rng(seed), N)
        for g, w in zip(got, want):
            assert g.shape == (N, PE.H, PE.W, 3) and g.dtype == np.uint8
            np.testing.assert_array_equal(g, w)


def test_batch_stat_forward_loss_and_grads(setup, jax_steps):
    tree, batches = setup
    a, b = batches[0]
    xa = np.asarray(JM.preprocess_bgr(jnp.asarray(a)))
    z_j, stats_j = jax_embed_with_stats(jax.tree_util.tree_map(jnp.asarray, tree),
                                        jnp.asarray(xa))
    z_j = np.asarray(z_j)
    trainer = PE.EmbedTrainer(tree, STEPS, device="cpu")
    stats_p = []
    with torch.no_grad():
        z_p = trainer.net(torch.from_numpy(xa.copy()), stats=stats_p).numpy()
    assert len(stats_p) == len(stats_j) == len(trainer.net.bn_nodes()) == 34
    for (mp, vp), (mj, vj) in zip(stats_p, stats_j):
        mj, vj = np.asarray(mj), np.asarray(vj)
        # means to the channels' spread (some are ~0), variances to their scale
        assert np.abs(mp.numpy() - mj).max() <= 1e-5 * np.sqrt(vj.max())
        assert np.abs(vp.numpy() - vj).max() <= 1e-5 * vj.max()
    assert np.abs(z_p - z_j).max() <= 2e-5 * np.abs(z_j).max()

    loss_j, acc_j, grads_j, _ = jax_steps[0]
    loss, acc, grads = trainer.grads(a, b)
    assert abs(float(loss) - loss_j) <= 1e-5 * abs(loss_j)
    assert float(acc) == acc_j
    scale = max(np.abs(g).max() for g in grads_j.values())
    names = list(trainer.net.state_dict().keys())
    assert {leaf_key(n) for n in names} == set(grads_j)
    for name, g in zip(names, grads):
        want = grads_j[leaf_key(name)]
        if g is None:  # the running statistics
            assert not want.any()
            continue
        assert np.abs(as_tree_layout(name, g) - want).max() <= 1e-4 * scale, name


def test_three_adamw_steps_match_optax(setup, jax_steps):
    tree, batches = setup
    trainer = PE.EmbedTrainer(tree, STEPS, device="cpu")
    before = flatten_tree(tree)
    grads_j = jax_steps[0][2]
    scale = max(np.abs(g).max() for g in grads_j.values())
    # leaves whose gradient is rounding noise (the project convs' BN
    # biases: a batch-statistics BN follows, so it is 0 in exact
    # arithmetic): Adam turns the noise into steps of either sign, on
    # both sides
    noise = {k for k, g in grads_j.items() if 0 < np.abs(g).max() <= 1e-4 * scale}
    assert noise == {("blocks", str(i), "project", "bn", "bias") for i in range(11)}
    lrs = []
    for (a, b), (loss_j, _, _, params_j) in zip(batches, jax_steps):
        loss, _ = trainer.step(a, b)
        lrs.append(trainer.opt.schedule(trainer.opt.count - 1))
        assert abs(loss - loss_j) <= 1e-5 * abs(loss_j)
        got = flatten_tree(trainer.params())
        assert got.keys() == params_j.keys()
        for k, want in params_j.items():
            step_j, step_p = want - before[k], got[k] - before[k]
            if k in noise:  # Adam's steps are at most lr each
                assert np.abs(step_p).max() <= 1.01 * sum(lrs)
                continue
            # the leaf's update against its own size (an entry whose
            # gradient is near 0 may take Adam's step of the other sign)
            assert np.linalg.norm(step_p - step_j) <= 2e-3 * np.linalg.norm(step_j), k
            assert np.abs(got[k] - want).max() <= 1e-6 * max(np.abs(want).max(), 1.0), k
    assert lrs[0] == 0.0 and 0 < lrs[1] < lrs[2]
    # the running statistics (gradient 0) take the weight decay alone
    var = flatten_tree(trainer.params())[("head", "bn", "var")]
    np.testing.assert_array_equal(var, jax_steps[-1][3][("head", "bn", "var")])


def test_schedule_matches_optax():
    sched = optax.warmup_cosine_decay_schedule(0.0, 1e-3, 50, 1200, 1e-3 * 0.05)
    mine = warmup_cosine(0.0, 1e-3, 50, 1200, 1e-3 * 0.05)
    counts = np.arange(0, 1205)
    want = np.asarray(jax.vmap(sched)(jnp.asarray(counts, jnp.int32)))
    got = np.asarray([mine(int(c)) for c in counts], np.float32)
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=0)
    assert got[0] == 0.0
    with pytest.raises(ValueError, match="warmup"):
        warmup_cosine(0.0, 1e-3, 50, 50, 0.0)


def test_adamw_decays_a_leaf_without_gradient_as_optax():
    lr, wd = (lambda c: 0.1), 0.01
    p = {"w": np.linspace(-3, 3, 7, dtype=np.float32),
         "var": np.full(3, 1000.0, np.float32)}
    opt = optax.adamw(lr, weight_decay=wd)
    jp = jax.tree_util.tree_map(jnp.asarray, p)
    s = opt.init(jp)
    leaves = [torch.from_numpy(p["w"].copy()), torch.from_numpy(p["var"].copy())]
    mine = AdamW(leaves, lr, wd)
    for k in range(3):
        g = {"w": jnp.asarray(np.sin(np.arange(7) + k), jnp.float32), "var": jnp.zeros(3)}
        up, s = opt.update(g, s, jp)
        jp = optax.apply_updates(jp, up)
        mine.step([torch.from_numpy(np.asarray(g["w"])), None])
    np.testing.assert_allclose(leaves[0].numpy(), np.asarray(jp["w"]), rtol=1e-6)
    np.testing.assert_allclose(leaves[1].numpy(), np.asarray(jp["var"]), rtol=1e-7)
    assert (leaves[1].numpy() < 1000.0).all()


def test_calibrate_bn_matches_jax(setup, monkeypatch):
    tree, batches = setup

    def jitted_embed(p, x, stats=None):  # JAX calibrate_bn's forward, jitted
        z, st = jax_embed_with_stats(p, x)
        stats.extend(st)
        return z

    monkeypatch.setattr(JM, "embed", jitted_embed)
    cal = [np.asarray(JM.preprocess_bgr(jnp.asarray(a))) for a, _ in batches]
    want = flatten_tree(jax.tree_util.tree_map(
        np.asarray, JM.calibrate_bn(jax.tree_util.tree_map(jnp.asarray, tree), cal)))
    trainer = PE.EmbedTrainer(tree, STEPS, device="cpu")
    trainer.calibrate([a for a, _ in batches])
    got = flatten_tree(trainer.params())
    n = 0
    for k, w in want.items():
        if k[-1] in ("mean", "var"):
            np.testing.assert_allclose(got[k], w, rtol=1e-5, atol=1e-6, err_msg=str(k))
            n += 1
        else:
            np.testing.assert_array_equal(got[k], w)
    assert n == 68
    # the average of per-batch variances, not the pooled variance
    stem = [torch.var_mean(torch.nn.functional.conv2d(
        PM.preprocess_bgr(torch.from_numpy(a)).permute(0, 3, 1, 2),
        torch.from_numpy(tree["stem"]["w"].transpose(3, 2, 0, 1)), None, 2, 1),
        dim=(0, 2, 3), unbiased=False)[0] for a, _ in batches]
    np.testing.assert_allclose(got[("stem", "bn", "var")],
                               torch.stack(stem).double().mean(0).numpy(), rtol=1e-5)


def test_cli_writes_outside_the_jax_package(tmp_path):
    assert PE.DEFAULT_OUT == os.path.join("checkpoints", "team_embed.msgpack")
    out = str(tmp_path / "embed.msgpack")
    assert PE.main(["--steps", "52", "--batch", "2", "--out", out, "--device", "cpu"]) == 0
    back = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_load_params(out)))
    assert back.keys() == flatten_tree(PM.init_params(torch.Generator())).keys()
    net = PM.build_embedder(jax_load_params(out), "cpu")
    z = PM.embed(net, torch.zeros((2, 64, 32, 3), dtype=torch.uint8))
    assert z.shape == (2, PM.FEATURE_DIM) and torch.isfinite(z).all()
