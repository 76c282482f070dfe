"""The port's MobileNetV3 embedder and the hybrid colour vector against the
JAX package, on the CPU, on numpy-seeded crops.

Tolerances, and why:
- `embed` in f32 on the shipped weights: |diff| <= 1e-4 + 2e-5 |value|
  (values up to ~10) and the cosine of each 576-d pair >= 0.99999. The JAX
  side runs its convs at Precision.HIGHEST with BN after the conv; the
  port folds BN into the kernels (measured: 1.1e-4 on a value of 10.4,
  relative 1.05e-5);
- `preprocess_bgr`: equal within 1e-6 (the same f32 operations);
- the 49-dim colour vector: the histograms and ratios within 1e-3, the
  means and standard deviations / 255 within 1e-3 (a colour conversion's
  rounding flips a few values by 1; see test_torch_teams.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.models import mobilenetv3 as jax_mnv3
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.teams import features as jax_features
from hockey_tpu_torch.models import mobilenetv3 as mnv3
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.teams import features
from tests.test_torch_session import one_torch_thread  # noqa: F401

EMBED_ATOL, EMBED_RTOL, EMBED_COS = 1e-4, 2e-5, 0.99999


@pytest.fixture(scope="module")
def crops():
    """(24, 128, 64, 3) f32 BGR: uniform noise and flat jerseys on ice."""
    rng = np.random.default_rng(0)
    noise = rng.uniform(0, 255, (12, 128, 64, 3))
    flat = np.full((12, 128, 64, 3), 235.0)
    flat[:, 20:100, 16:48] = rng.uniform(0, 255, (12, 1, 1, 3))
    flat += rng.normal(0, 6, flat.shape)
    return np.clip(np.concatenate([noise, flat]), 0, 255).astype(np.float32)


@pytest.fixture(scope="module")
def jax_tree():
    return jax_load_params(shipped_weights_path("team_embed"))


@pytest.fixture(scope="module")
def jax_embeddings(crops, jax_tree):
    params = jax.tree_util.tree_map(jnp.asarray, jax_tree)
    return np.asarray(jax_mnv3.embed(
        params, jax_mnv3.preprocess_bgr(jnp.asarray(crops))))


def _check_embeddings(got, want):
    assert got.shape == want.shape == (len(want), mnv3.FEATURE_DIM)
    np.testing.assert_allclose(got, want, rtol=EMBED_RTOL, atol=EMBED_ATOL)
    cos = (got * want).sum(1) / np.linalg.norm(got, axis=1) / np.linalg.norm(want, axis=1)
    assert cos.min() >= EMBED_COS


@pytest.mark.parametrize("carry", ["params_from_jax", "port_loader"])
def test_embed_matches_jax(crops, jax_tree, jax_embeddings, carry):
    """The JAX loader's tree carried across by `params_from_jax`, and the
    port's own msgpack decoder, give the same net."""
    tree = (jax.tree_util.tree_map(np.asarray, jax_tree) if carry == "params_from_jax"
            else mnv3.load_default_params())
    net = mnv3.build_embedder(tree, "cpu")
    assert all(getattr(m, "bn", None) is None for m in net.modules())  # folded
    got = mnv3.embed(net, torch.from_numpy(crops)).numpy()
    _check_embeddings(got, jax_embeddings)


def test_state_dict_names_the_jax_tree(jax_tree):
    state = mnv3.params_from_jax(jax.tree_util.tree_map(np.asarray, jax_tree))
    net = mnv3.MobileNetV3()
    assert set(state) == set(net.state_dict())
    assert state["blocks.3.dw.w"].shape == (96, 1, 5, 5)  # depthwise OIHW


def test_preprocess_matches_jax(crops):
    want = np.asarray(jax_mnv3.preprocess_bgr(jnp.asarray(crops)))
    got = mnv3.preprocess_bgr(torch.from_numpy(crops)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_init_params_from_generator(jax_tree):
    """The random tree has the shipped tree's layout, is fixed by the
    generator's seed, and builds a working net."""
    a = mnv3.init_params(torch.Generator().manual_seed(3))
    b = mnv3.init_params(torch.Generator().manual_seed(3))
    c = mnv3.init_params(torch.Generator().manual_seed(4))
    flat = jax.tree_util.tree_leaves(a)
    assert [x.shape for x in flat] == [np.shape(x) for x in
                                      jax.tree_util.tree_leaves(jax_tree)]
    assert all(np.array_equal(x, y) for x, y in zip(flat, jax.tree_util.tree_leaves(b)))
    assert not np.array_equal(a["stem"]["w"], c["stem"]["w"])
    z = mnv3.embed(mnv3.build_embedder(a, "cpu"), torch.zeros(2, 64, 32, 3))
    assert z.shape == (2, 576) and torch.isfinite(z).all()


@pytest.mark.parametrize("mask", ["ones", "random"])
def test_hybrid_color_features_match_jax(crops, mask):
    rng = np.random.default_rng(1)
    m = (np.ones(crops.shape[:3], np.float32) if mask == "ones"
         else (rng.uniform(size=crops.shape[:3]) < 0.6).astype(np.float32))
    want = np.asarray(jax_features.hybrid_color_features(jnp.asarray(crops),
                                                         jnp.asarray(m)))
    got = features.hybrid_color_features(torch.from_numpy(crops),
                                         torch.from_numpy(m)).numpy()
    assert got.shape == want.shape == (len(crops), 49)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-3)


def test_color_ambiguous_teams_separate():
    """tests/test_teams.py::TestTrainedEmbeddings on the port: two teams of
    the same hue, solid against hoops, separate in the shipped embedding
    space."""
    from hockey_tpu.teams.embed_train import render_design

    rng = np.random.default_rng(5)
    base = np.asarray([40.0, 40.0, 200.0])
    designs = [{"base": base, "second": np.asarray([240.0, 240.0, 240.0]),
                "pattern": p} for p in ("solid", "hoops")]
    crops = [render_design(rng, designs[0]) for _ in range(8)] + \
            [render_design(rng, designs[1]) for _ in range(8)]
    net = mnv3.build_embedder(mnv3.load_default_params(), "cpu")
    z = mnv3.embed(net, torch.from_numpy(np.stack(crops))).numpy()
    z = z / (np.linalg.norm(z, axis=1, keepdims=True) + 1e-6)
    sim = z @ z.T
    within = (sim[:8, :8].sum() - 8 + sim[8:, 8:].sum() - 8) / (2 * 56)
    assert within > sim[:8, 8:].mean() + 0.08
