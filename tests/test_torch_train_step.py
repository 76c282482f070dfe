"""The port's train step (hockey_tpu_torch/train/trainer.py) against the
JAX package's `make_train_step` on the CPU, YOLOv8n at 64 px, batch 2,
f32 on both sides (JAX convs at Precision.HIGHEST), from the same
weights (JAX `init_params`, carried across by `params_from_jax`).

Tolerances: the loss, its components and `grad_norm` within 1e-3
relative per step; after three steps the parameters, BN running
statistics and the EMA within REL (1e-4) of each leaf's largest
magnitude (at least 1), the SGD momentum, a sum of raw gradients,
within MOMENTUM_REL (5e-3); `num_fg` and `skipped` equal. The BN batch statistics are f32
in both packages (the JAX package casts to f32 before `jnp.mean` and
`jnp.var`), reduced in other orders: they differ by ~3e-6 relative at
the stem even with f64 convolutions on both sides, ~1e-4 at the head's
maps after 57 BN layers, and each update carries that into the next
step (measured at step 3: components 3.8e-4 and `grad_norm` 4.4e-4
relative, parameters 3.8e-5 and the momentum 1.8e-3 of their scale).
Those limits are wider than weight decay's share of three updates, so
`test_update_matches_jax_leaf_by_leaf` holds each leaf's update (the
parameters' change and the momentum) against JAX's relative to that
leaf's own update, within UPDATE_REL (2e-2; measured at most 8.6e-3 at
weight decay 5e-4, 0.05 and 0.5), where a step without the decay is off
by 100% or more at every one of those settings. With the statistics and the
loss in f64 on both sides (a check outside the suite, as it patches
both packages' casts) the loss agrees to 4e-14 and every gradient to
1e-12 relative: the difference is f32 reduction order alone. The
schedule equals optax's within 1e-6 relative.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hockey_tpu.models.yolov8 import YoloConfig as JYoloConfig
from hockey_tpu.models.yolov8 import init_params as jax_init_params
from hockey_tpu.train import trainer as J
from hockey_tpu_torch.models.checkpoint import flatten_tree
from hockey_tpu_torch.models.layers import trainable
from hockey_tpu_torch.models.yolov8 import YoloConfig, build_model, params_to_jax
from hockey_tpu_torch.train import trainer as T
from tests.test_torch_session import one_torch_thread  # noqa: F401
from tests.test_train import synth_batch

JCFG, CFG = JYoloConfig("n", num_classes=2), YoloConfig("n", num_classes=2)
IMGSZ = 64
TC = dict(imgsz=IMGSZ, total_steps=10, warmup_steps=2, compute_dtype="float32")
TC_WD = 5e-4  # TrainConfig's default weight decay
REL = 1e-4         # parameters, BN running statistics, EMA
MOMENTUM_REL = 5e-3
UPDATE_REL = 2e-2  # each leaf's update against its own scale
BF16_SPREAD, BF16_EARLY = 1.5, 2e-2  # precise-BN in bf16


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


def _batches(n, seed=0):
    rng = np.random.default_rng(seed)
    return [{k: np.asarray(v) for k, v in synth_batch(rng).items()}
            for _ in range(n)]


def _torch(batch):
    return {k: torch.tensor(v) for k, v in batch.items()}


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (what, err, scale)


def _assert_trees_close(port_tree, jax_tree, rel=REL):
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jax_tree))
    got = flatten_tree(port_tree)
    assert got.keys() == want.keys()
    for k in want:
        _close(got[k], want[k], rel, "/".join(k))


def _jax_trace(opt_state):
    states = [s for s in jax.tree_util.tree_leaves(
        opt_state, is_leaf=lambda x: isinstance(x, optax.TraceState))
        if isinstance(s, optax.TraceState)]
    assert len(states) == 1
    return states[0].trace


def _port_momentum(trainer):
    """The momentum as a JAX-layout tree (HWIO kernels). The JAX trace
    also holds the BN running statistics, whose gradient is zero: zeros
    here."""
    model = trainable(build_model(CFG, params_to_jax(trainer.model)))
    mom = trainer.momentum()
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(mom[n])
        for b in model.buffers():
            b.zero_()
    return params_to_jax(model)


@functools.lru_cache(maxsize=None)
def _jax_step(ema, weight_decay=TC_WD):
    """(optimizer, jitted train step), compiled once per setting."""
    tc_j = J.TrainConfig(**TC, weight_decay=weight_decay)
    opt = J.make_optimizer(tc_j)
    return opt, jax.jit(J.make_train_step(JCFG, tc_j, opt, ema_decay=ema))


def _setup(ema=0.0, seed=0, weight_decay=TC_WD):
    params = jax_init_params(JCFG, seed=seed)
    opt, step = _jax_step(ema, weight_decay)
    trainer = T.Trainer(CFG, T.TrainConfig(**TC, weight_decay=weight_decay),
                        build_model(CFG, jax.tree_util.tree_map(np.asarray, params)),
                        ema_decay=ema)
    return params, opt, step, trainer


def _check_metrics(got, want):
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "grad_norm"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-3,
                                   atol=1e-6, err_msg=k)
    assert float(got["num_fg"]) == float(want["num_fg"])
    assert float(got["skipped"]) == float(want["skipped"])


@pytest.mark.parametrize("ema", [0.0, 0.999])
def test_three_steps_match_make_train_step(ema):
    params, opt, step, trainer = _setup(ema)
    opt_state = opt.init(params)
    ema_state = J.init_ema(params) if ema else None
    for batch in _batches(3):
        if ema:
            params, ema_state, opt_state, want = step(
                params, ema_state, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        else:
            params, opt_state, want = step(
                params, opt_state, {k: jnp.asarray(v) for k, v in batch.items()})
        got = trainer.step(_torch(batch))
        _check_metrics(got, want)
    assert trainer.count == 3
    _assert_trees_close(params_to_jax(trainer.model), params)  # BN stats too
    _assert_trees_close(_port_momentum(trainer), _jax_trace(opt_state),
                        MOMENTUM_REL)
    if ema:
        assert trainer.ema.count == 3
        _assert_trees_close(params_to_jax(trainer.ema.model), ema_state["params"])


@pytest.mark.parametrize("weight_decay", [TC_WD, 0.5])
def test_update_matches_jax_leaf_by_leaf(weight_decay):
    """Three steps' change of every parameter and the momentum against
    JAX's, each leaf relative to its own largest value: the decay's
    share of a leaf's update is far above this limit (at the default
    decay the head's `out` kernels that no gt reaches move by decay
    alone), so a step that drops or misplaces it fails here."""
    params, opt, step, trainer = _setup(weight_decay=weight_decay)
    start = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    opt_state = opt.init(params)
    for batch in _batches(3):
        params, opt_state, _ = step(params, opt_state,
                                    {k: jnp.asarray(v) for k, v in batch.items()})
        trainer.step(_torch(batch))
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, params))
    got = flatten_tree(params_to_jax(trainer.model))
    want_m = flatten_tree(jax.tree_util.tree_map(np.asarray, _jax_trace(opt_state)))
    got_m = flatten_tree(_port_momentum(trainer))
    for k in want:
        if k[-1] in ("mean", "var"):  # running statistics: no gradient
            continue
        for g, w, what in ((got[k] - start[k], want[k] - start[k], "update"),
                           (got_m[k], want_m[k], "momentum")):
            scale = float(np.abs(w).max())
            err = float(np.abs(g - w).max())
            assert err <= UPDATE_REL * scale if scale else err == 0.0, \
                ("/".join(k), what, err, scale)


def test_first_step_runs_at_lr_zero():
    """optax evaluates the schedule before counting the update: step 0
    leaves every parameter where it was, while the momentum and the BN
    running statistics move."""
    params, opt, step, trainer = _setup()
    before = params_to_jax(trainer.model)
    batch = _batches(1)[0]
    new, opt_state, _ = step(params, opt.init(params),
                             {k: jnp.asarray(v) for k, v in batch.items()})
    trainer.step(_torch(batch))
    after = flatten_tree(params_to_jax(trainer.model))
    for k, v in flatten_tree(before).items():
        if k[-1] in ("mean", "var"):
            assert not np.array_equal(after[k], v), k
        else:
            np.testing.assert_array_equal(after[k], v, err_msg="/".join(k))
    _assert_trees_close(params_to_jax(trainer.model), new)
    _assert_trees_close(_port_momentum(trainer), _jax_trace(opt_state),
                        MOMENTUM_REL)


def test_schedule_matches_optax():
    for tc in (T.TrainConfig(total_steps=10, warmup_steps=2),
               T.TrainConfig(total_steps=1000, warmup_steps=100,
                             learning_rate=0.02),
               T.TrainConfig(total_steps=3, warmup_steps=100)):
        sched = optax.warmup_cosine_decay_schedule(
            0.0, tc.learning_rate, max(1, min(tc.warmup_steps, tc.total_steps // 2)),
            tc.total_steps, tc.learning_rate * tc.final_lr_frac)
        for c in sorted({0, 1, 2, 3, 50, 99, 100, 101, 500, tc.total_steps - 1,
                         tc.total_steps, tc.total_steps + 5}):
            want = float(sched(jnp.asarray(c, jnp.int32)))
            np.testing.assert_allclose(T.learning_rate(tc, c), want, rtol=1e-6,
                                       atol=1e-12, err_msg=str(c))
    assert T.learning_rate(T.TrainConfig(), 0) == 0.0


def test_weight_decay_mask_matches_optax():
    """Decay on every parameter named `w` (the head's `out` kernels too),
    never on BN parameters or biases: the port's decayed group equals the
    JAX mask."""
    params, _, _, trainer = _setup()
    want = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in jax.tree_util.tree_flatten_with_path(params)[0]
            if any(getattr(k, "key", None) == "w" for k in path)}
    ids = {id(p) for p in trainer.opt.param_groups[0]["params"]}
    got = {n.replace(".", "/") for n, p in trainer.model.named_parameters()
           if id(p) in ids}
    assert got == want
    assert any(n.endswith("out/w") for n in got)
    assert trainer.opt.param_groups[0]["weight_decay"] == 5e-4
    assert trainer.opt.param_groups[1]["weight_decay"] == 0.0


def test_non_finite_batch_is_skipped():
    """A NaN image discards the whole update in both packages: parameters,
    momentum, BN statistics and the schedule's count stay, `skipped` is 1,
    and the next finite step matches JAX again."""
    params, opt, step, trainer = _setup()
    opt_state = opt.init(params)
    good, nxt = _batches(2)
    jb = {k: jnp.asarray(v) for k, v in good.items()}
    params, opt_state, _ = step(params, opt_state, jb)
    trainer.step(_torch(good))
    bad = dict(good, images=good["images"].copy())
    bad["images"][0, 3, 3, 0] = np.nan
    before, mom = params_to_jax(trainer.model), _port_momentum(trainer)
    params2, opt_state2, want = step(params, opt_state,
                                     {k: jnp.asarray(v) for k, v in bad.items()})
    got = trainer.step(_torch(bad))
    assert float(got["skipped"]) == float(want["skipped"]) == 1.0
    assert not np.isfinite(float(got["loss"]))
    assert trainer.count == 1
    for a, b in ((params_to_jax(trainer.model), before), (_port_momentum(trainer), mom)):
        fa, fb = flatten_tree(a), flatten_tree(b)
        for k in fb:
            np.testing.assert_array_equal(fa[k], fb[k], err_msg="/".join(k))
    params3, _, want = step(params2, opt_state2,
                            {k: jnp.asarray(v) for k, v in nxt.items()})
    _check_metrics(trainer.step(_torch(nxt)), want)
    _assert_trees_close(params_to_jax(trainer.model), params3)


def test_precise_bn_matches_jax():
    params, _, _, trainer = _setup(seed=1)
    imgs = [b["images"] for b in _batches(3, seed=4)]
    want = J.precise_bn(params, J.make_bn_stats_fn(JCFG, "float32"),
                        [jnp.asarray(x) for x in imgs])
    before = params_to_jax(trainer.model)
    got = T.precise_bn(trainer.model, T.make_bn_stats_fn("float32"), imgs)
    _assert_trees_close(params_to_jax(got), want)
    fa, fb = flatten_tree(params_to_jax(trainer.model)), flatten_tree(before)
    assert all(np.array_equal(fa[k], fb[k]) for k in fb)  # input unchanged
    assert T.precise_bn(trainer.model, None, []) is trainer.model


def test_precise_bn_bf16_as_close_to_f32_as_jax():
    """Precise-BN with the statistics' forward in bf16, as the loop runs
    it on the card. bf16 rounding compounds through the layers of a
    random-init model at 64 px (the 2x2 maps at stride 32 give each BN 8
    values per channel), so the two packages' bf16 statistics cannot be
    held to each other deep in the model: each package's bf16 running
    statistics depart from its own f32 by up to 0.41 of the leaf's scale
    (JAX) and 0.31 (the port), median 0.0188 and 0.0183 over the 114
    leaves. The port must depart from f32 no more than JAX does (median
    and maximum, within BF16_SPREAD = 1.5x JAX's), and equal JAX's bf16
    statistics within BF16_EARLY = 2e-2 of max(|leaf|, 1) in the
    backbone up to `c2f2` (13 layers), where the rounding has not
    compounded (measured at most 6.6e-3)."""
    params, _, _, trainer = _setup(seed=1)
    imgs = [b["images"] for b in _batches(3, seed=4)]

    def jax_pbn(dt):
        out = J.precise_bn(params, J.make_bn_stats_fn(JCFG, dt),
                           [jnp.asarray(x) for x in imgs])
        return flatten_tree(jax.tree_util.tree_map(np.asarray, out))

    def port_pbn(dt):
        return flatten_tree(params_to_jax(
            T.precise_bn(trainer.model, T.make_bn_stats_fn(dt), imgs)))

    j32, j16, p32, p16 = jax_pbn("float32"), jax_pbn("bfloat16"), \
        port_pbn("float32"), port_pbn("bfloat16")

    def rel(a, b, k):
        a, b = np.asarray(a[k], np.float64), np.asarray(b[k], np.float64)
        return float(np.abs(a - b).max()) / max(float(np.abs(b).max()), 1e-30)

    stats = [k for k in j32 if k[-1] in ("mean", "var")]
    port = [rel(p16, p32, k) for k in stats]
    ref = [rel(j16, j32, k) for k in stats]
    assert np.median(port) <= BF16_SPREAD * np.median(ref), (np.median(port), np.median(ref))
    assert max(port) <= BF16_SPREAD * max(ref), (max(port), max(ref))
    early = [k for k in stats if k[0] == "backbone" and k[1] in (
        "stem", "down1", "c2f1", "down2", "c2f2")]
    assert len(early) == 2 * 13
    for k in early:
        _close(p16[k], j16[k], BF16_EARLY, "/".join(k))


def test_eval_step_matches_jax():
    params, _, _, trainer = _setup(seed=2)
    batch = _batches(1, seed=5)[0]
    want = jax.jit(J.make_eval_step(JCFG, J.TrainConfig(**TC)))(
        params, {k: jnp.asarray(v) for k, v in batch.items()})
    got = T.make_eval_step(CFG, T.TrainConfig(**TC))(trainer.model, _torch(batch))
    for k in ("loss", "box_loss", "cls_loss", "dfl_loss", "num_fg"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-4,
                                   atol=1e-6, err_msg=k)
