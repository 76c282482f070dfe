"""NMS of the port against the JAX package on the CPU.

The plain suppression (`suppress_reference`, what the CUDA kernel is held
to on the card) against `_suppress_exact` and the Pallas kernel in
interpret mode, on this module's cases and on `chip_smoke.kernel_cases`,
the very inputs the kernel meets on the card; then the whole batched
`nms` against the JAX `nms` per frame. Tolerance: kept sets, validity
and classes equal; boxes and scores within 1e-6 (the same f32 operations
in the same order, so in practice they are equal)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from hockey_tpu.ops.iou import box_iou as jax_box_iou
from hockey_tpu.ops.nms import _suppress_exact
from hockey_tpu.ops.nms import nms as jax_nms
from hockey_tpu.ops.pallas.nms_kernel import suppress_pallas
from hockey_tpu_torch.ops.iou import box_iou
from hockey_tpu_torch.ops.nms import nms, suppression_matrix
from hockey_tpu_torch.ops.nms_kernel import suppress, suppress_reference

B = 2  # frames per case: the port's batch dimension against a JAX loop


def _boxes(rng, k, spread=500.0):
    xy = rng.uniform(0, spread, (B, k, 2))
    wh = rng.uniform(10, 80, (B, k, 2))
    return np.concatenate([xy, xy + wh], -1).astype(np.float32)


def _case(name, k, rng):
    """(matrix (B, K, K) f32, keep0 (B, K) bool, thr)."""
    keep0 = rng.uniform(size=(B, k)) > 0.1
    if name == "iou":
        bx = torch.from_numpy(_boxes(rng, k))
        return box_iou(bx, bx).numpy(), keep0, 0.5
    if name == "containment":
        bx = _boxes(rng, k, spread=200.0)
        cls = rng.integers(0, 2, (B, k, 1)).astype(np.float32) * 1e4
        m, thr = suppression_matrix(torch.from_numpy(bx + cls), 0.45, 0.5)
        return m.numpy(), keep0, thr
    if name == "ties":  # duplicated boxes and entries exactly at thr
        bx = torch.from_numpy(np.repeat(_boxes(rng, k // 2 + 1, 200.0), 2, 1)[:, :k])
        return (torch.round(box_iou(bx, bx) * 4) / 4).numpy(), keep0, 0.5
    if name == "all_invalid":
        bx = torch.from_numpy(_boxes(rng, k))
        return box_iou(bx, bx).numpy(), np.zeros((B, k), bool), 0.5
    if name == "all_disjoint":
        xs = np.arange(k, dtype=np.float32) * 100
        bx = np.broadcast_to(np.stack([xs, xs, xs + 50, xs + 50], 1), (B, k, 4))
        bx = torch.from_numpy(np.ascontiguousarray(bx))
        return box_iou(bx, bx).numpy(), np.ones((B, k), bool), 0.5
    if name == "nan":  # NaN > thr is false: a NaN entry suppresses nothing
        bx = torch.from_numpy(_boxes(rng, k, spread=200.0))
        m = box_iou(bx, bx).numpy()
        m[rng.uniform(size=m.shape) < 0.1] = np.nan
        return m, keep0, 0.5
    raise ValueError(name)


def _assert_matches_jax(m, keep0, thr):
    """suppress_reference on the batch against `_suppress_exact` and the
    Pallas kernel in interpret mode on each frame, exactly; returns the
    batch's kept set."""
    got = suppress_reference(torch.from_numpy(m), torch.from_numpy(keep0), thr)
    for b in range(m.shape[0]):
        want = np.asarray(_suppress_exact(jnp.asarray(m[b]),
                                          jnp.asarray(keep0[b]), thr))
        pallas = np.asarray(suppress_pallas(jnp.asarray(m[b]),
                                            jnp.asarray(keep0[b]), thr,
                                            interpret=True))
        np.testing.assert_array_equal(got[b].numpy(), want)
        np.testing.assert_array_equal(pallas, want)
    return got


@pytest.mark.parametrize("k", [1, 33, 64, 100, 256])
@pytest.mark.parametrize("name", ["iou", "containment", "ties", "all_invalid",
                                  "all_disjoint", "nan"])
def test_suppress_reference_matches_jax(name, k):
    rng = np.random.default_rng(k)
    m, keep0, thr = _case(name, k, rng)
    got = _assert_matches_jax(m, keep0, thr)
    if name == "all_disjoint":
        assert got.all()
    if name == "all_invalid":
        assert not got.any()


@functools.lru_cache(maxsize=1)
def _kernel_cases():
    return {name: (m.numpy(), keep0.numpy(), thr)
            for name, m, keep0, thr in chip_smoke.kernel_cases("cpu")}


@pytest.mark.parametrize("name", chip_smoke.KERNEL_CASES)
def test_kernel_cases_match_jax(name):
    """Every case chip_smoke.py holds the CUDA kernel to on the card (the
    kernel against suppress_reference, bit for bit) is itself held to the
    JAX package here, frame by frame and exactly; interpret mode is quick
    enough to run on all of them, K = 1024 included."""
    m, keep0, thr = _kernel_cases()[name]
    got = _assert_matches_jax(m, keep0, thr)
    if name.startswith("all-overlapping"):  # only candidate 0 survives
        assert got[:, 0].all() and not got[:, 1:].any()


def test_suppress_wrapper_on_cpu_runs_plain_version(rng):
    bx = torch.from_numpy(_boxes(rng, 64))
    m = box_iou(bx, bx)
    keep0 = torch.from_numpy(rng.uniform(size=(B, 64)) > 0.2)
    before = suppress.launches
    np.testing.assert_array_equal(suppress(m, keep0, 0.5).numpy(),
                                  suppress_reference(m, keep0, 0.5).numpy())
    assert suppress.launches == before  # CPU calls launch nothing
    with pytest.raises(TypeError):
        suppress(m.double(), keep0, 0.5)
    with pytest.raises(ValueError):
        suppress(m[:, :10], keep0, 0.5)


def _nms_inputs(rng, a, classes=2):
    boxes = _boxes(rng, a, spread=300.0)
    # two decimals: many exact score ties, as bf16 heads give
    scores = np.round(rng.uniform(0, 1, (B, a)), 2).astype(np.float32)
    cls = rng.integers(0, classes, (B, a)).astype(np.int32)
    return boxes, scores, cls


@pytest.mark.parametrize("containment,class_aware,exact,a", [
    (0.0, True, True, 500),
    (0.5, True, True, 500),
    (0.5, False, True, 500),
    (0.0, True, False, 500),
    (0.5, True, False, 500),
    (0.5, True, True, 40),   # K = 40 < max_det: padded slots
    (0.0, False, True, 40),
])
def test_nms_matches_jax(containment, class_aware, exact, a):
    rng = np.random.default_rng(a + int(containment * 10))
    boxes, scores, cls = _nms_inputs(rng, a)
    kw = dict(score_threshold=0.3, iou_threshold=0.45,
              containment_threshold=containment, pre_topk=256, max_det=64,
              class_aware=class_aware, exact=exact)
    got = nms(torch.from_numpy(boxes), torch.from_numpy(scores),
              torch.from_numpy(cls), **kw)
    for b in range(B):
        want = jax.tree_util.tree_map(np.asarray, jax_nms(
            jnp.asarray(boxes[b]), jnp.asarray(scores[b]), jnp.asarray(cls[b]),
            **kw))
        np.testing.assert_array_equal(got.valid[b].numpy(), want.valid)
        np.testing.assert_array_equal(got.classes[b].numpy(), want.classes)
        np.testing.assert_allclose(got.boxes[b].numpy(), want.boxes, rtol=0, atol=1e-6)
        np.testing.assert_allclose(got.scores[b].numpy(), want.scores, rtol=0, atol=1e-6)
        assert want.valid.sum() > 5


def test_box_iou_matches_jax(rng):
    a, b = _boxes(rng, 30)[0], _boxes(rng, 20)[0]
    np.testing.assert_array_equal(
        box_iou(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
        np.asarray(jax_box_iou(jnp.asarray(a), jnp.asarray(b))))
