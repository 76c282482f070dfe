"""YOLOv8 layers, forward pass, decode and letterbox of the port against
the JAX package, in f32 on the CPU (JAX convs at Precision.HIGHEST).

Tolerances: conv outputs within 1e-4 of the largest magnitude of the
reference tensor (two f32 convolution libraries summing in different
orders; measured ~2e-6 relative on the x-scale model); decoded boxes within
1e-3 px and scores within 1e-5; letterbox within 1e-6 (values in [0, 1],
two f32 matrix products)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hockey_tpu.models import layers as jl
from hockey_tpu.models import yolov8 as jy
from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.ops import letterbox as jlb
from hockey_tpu_torch.models import layers as tl
from hockey_tpu_torch.models import yolov8 as ty
from hockey_tpu_torch.models.checkpoint import shipped_weights_path
from hockey_tpu_torch.ops import letterbox as tlb

REL = 1e-4


def _close(got, want, rel=REL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1.0)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _perturb_bn(tree, rng):
    """Random BN statistics, so the BN fold is exercised (JAX init is the
    identity BN)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k == "bn":
                c = v["scale"].shape[0]
                out[k] = {"scale": rng.uniform(0.5, 1.5, c).astype(np.float32),
                          "bias": rng.normal(0, 0.1, c).astype(np.float32),
                          "mean": rng.normal(0, 0.1, c).astype(np.float32),
                          "var": rng.uniform(0.5, 1.5, c).astype(np.float32)}
            else:
                out[k] = _perturb_bn(v, rng)
        return out
    if isinstance(tree, list):
        return [_perturb_bn(v, rng) for v in tree]
    return np.asarray(tree)


def _load(module, tree):
    module.load_state_dict(ty.params_from_jax(tree), strict=True)
    return module.eval()


def _nhwc(fn, x):
    """Run a port NCHW module on an NHWC numpy batch; NHWC numpy out."""
    with torch.inference_mode():
        return fn(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()


LAYERS = {
    # name: (JAX init, JAX apply, port module, cin)
    "conv3x3": (lambda kg: jl.conv_init(kg, 8, 16, 3),
                lambda p, x: jl.conv_apply(p, x), lambda: tl.Conv(8, 16, 3), 8),
    "conv3x3_s2": (lambda kg: jl.conv_init(kg, 8, 16, 3),
                   lambda p, x: jl.conv_apply(p, x, stride=2),
                   lambda: tl.Conv(8, 16, 3, 2), 8),
    "conv1x1_bias_noact": (
        lambda kg: {**jl.conv_init(kg, 8, 12, 1, bn=False, bias=True),
                    "b": jnp.linspace(-1, 1, 12)},
        lambda p, x: jl.conv_apply(p, x, act=False),
        lambda: tl.Conv(8, 12, 1, bn=False, bias=True, act=False), 8),
    "c2f_shortcut": (lambda kg: jl.c2f_init(kg, 16, 16, 2),
                     lambda p, x: jl.c2f_apply(p, x, True),
                     lambda: tl.C2f(16, 16, 2, True), 16),
    "c2f_plain": (lambda kg: jl.c2f_init(kg, 24, 16, 1),
                  lambda p, x: jl.c2f_apply(p, x, False),
                  lambda: tl.C2f(24, 16, 1, False), 24),
    "sppf": (lambda kg: jl.sppf_init(kg, 16, 16),
             lambda p, x: jl.sppf_apply(p, x), lambda: tl.SPPF(16, 16), 16),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name, rng):
    init, apply, make, cin = LAYERS[name]
    params = _perturb_bn(jax.tree_util.tree_map(np.asarray, init(jl.KeyGen(3))), rng)
    x = rng.standard_normal((2, 12, 20, cin)).astype(np.float32)
    want = np.asarray(apply(jax.tree_util.tree_map(jnp.asarray, params),
                            jnp.asarray(x)))
    module = _load(make(), params)
    _close(_nhwc(module, x), want)
    # BN folded into the kernel gives the same function
    _close(_nhwc(tl.fuse_model(module), x), want)


def test_upsample_and_fuse_for_inference(rng):
    x = rng.standard_normal((2, 5, 7, 3)).astype(np.float32)
    np.testing.assert_array_equal(_nhwc(tl.upsample2x, x),
                                  np.asarray(jl.upsample2x(jnp.asarray(x))))
    conv = _load(tl.Conv(3, 4, 3), _perturb_bn(jax.tree_util.tree_map(
        np.asarray, jl.conv_init(jl.KeyGen(0), 3, 4, 3)), rng))
    fused = tl.fuse_for_inference(conv, torch.bfloat16)
    assert fused.bn is None and fused.w.dtype == fused.b.dtype == torch.bfloat16


def _forward_and_decode(cfg, params, x):
    """JAX and port forward_raw + decode_boxes on the same NHWC input."""
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    raw_j = jax.jit(lambda p, v: jy.forward_raw(p, v, cfg))(jp, jnp.asarray(x))
    model = ty.build_model(cfg, params)
    with torch.inference_mode():
        raw_t = ty.forward_raw(model, torch.from_numpy(x))
    for key in ("box", "cls"):
        assert len(raw_t[key]) == 3
        for a, b in zip(raw_j[key], raw_t[key]):
            _close(b.numpy(), np.asarray(a))
    hw = x.shape[1:3]
    bj, sj = jy.decode_boxes(raw_j, cfg, hw)
    bt, st = ty.decode_boxes(raw_t, cfg, hw)
    a = jy.anchor_points(hw)[0].shape[0]
    assert bt.shape == (x.shape[0], a, 4) and st.shape == (x.shape[0], a, cfg.num_classes)
    np.testing.assert_allclose(bt.numpy(), np.asarray(bj), rtol=0, atol=1e-3)
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), rtol=0, atol=1e-5)


def test_random_init_n_scale_matches_jax(rng):
    cfg = jy.YoloConfig("n", num_classes=2)
    params = _perturb_bn(jax.tree_util.tree_map(
        np.asarray, jy.init_params(cfg, seed=1)), rng)
    x = rng.uniform(0, 1, (2, 64, 96, 3)).astype(np.float32)
    _forward_and_decode(ty.YoloConfig("n", num_classes=2), params, x)


def test_shipped_player_x_scale_matches_jax(rng):
    params = jax.tree_util.tree_map(np.asarray, jax_load_params(
        shipped_weights_path("hockey-player-detection")))
    x = rng.uniform(0, 1, (2, 64, 128, 3)).astype(np.float32)
    _forward_and_decode(ty.MODEL_ZOO["hockey-player-detection"], params, x)


def test_anchor_points_match_jax():
    for hw in (64, (736, 1280)):
        for a, b in zip(ty.anchor_points(hw), jy.anchor_points(hw)):
            np.testing.assert_array_equal(a, b)
    assert ty.anchor_points((736, 1280))[0].shape[0] == 19320


@pytest.mark.parametrize("h,w,imgsz", [(1080, 1920, 1280), (108, 192, 128),
                                       (480, 640, 320), (720, 500, 640)])
def test_letterbox_geometry_matches_jax(h, w, imgsz):
    assert tlb.letterbox_params(h, w, imgsz) == jlb.letterbox_params(h, w, imgsz)
    assert tlb.rect_shape(h, w, imgsz) == jlb.rect_shape(h, w, imgsz)
    assert tlb.rect_letterbox_params(h, w, imgsz) == jlb.rect_letterbox_params(h, w, imgsz)
    np.testing.assert_array_equal(tlb._resize_matrix(h, 77), jlb._resize_matrix(h, 77))


@pytest.mark.parametrize("rect", [True, False])
def test_letterbox_matches_jax(rect, rng):
    frames = rng.integers(0, 256, (2, 108, 192, 3), dtype=np.uint8)
    if rect:
        got = tlb.letterbox_rect_batch(torch.from_numpy(frames), 128, 32, torch.float32)
        want = jlb.letterbox_rect_batch(jnp.asarray(frames), 128, 32, jnp.float32)
    else:
        got = tlb.letterbox_batch(torch.from_numpy(frames), 128, torch.float32)
        want = jlb.letterbox_batch(jnp.asarray(frames), 128, jnp.float32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-6)
