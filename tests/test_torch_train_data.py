"""The port's training data (hockey_tpu_torch/train/data.py augmenting
half, train/device_aug.py) against the JAX package on the CPU.

- OpenCV's 8-bit HSV in numpy: `bgr_to_hsv` equals cv2.cvtColor on all
  16,777,216 BGR colours, `hsv_to_bgr` on every HSV triple with H < 180
  laid out in rows of 4096 pixels (OpenCV's vectorised path); in rows
  whose width is not a multiple of 32 the last width mod 32 pixels take
  OpenCV's scalar path, which rounds instead of truncating: within 1
  level there (measured: 13% of a 37x53 image's values, all off by 1).
  The port's images are 64-640 px squares, multiples of 32.
- `hsv_augment`, `mosaic4`, `mixup`, `PoolDataset.load(i, hsv_jitter,
  flip)`, `YoloDataset.load(...)` and `batch_iterator` equal the JAX
  functions (which call cv2) bit for bit on the same numpy seeds.
- The device transforms on JAX's own draws (drawn with jax.random in the
  split order of `make_device_batch_fn` and `make_pose_batch_fn`): images
  within 1e-6 (the pose batch, run op by op in JAX, is equal; compiled,
  XLA's rewrites move the HSV round trip by up to ~1e-6), boxes, classes
  and masks equal; `stage_pool` equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from hockey_tpu.train import data as jdata  # noqa: E402
from hockey_tpu.train import device_aug as jaug  # noqa: E402
from hockey_tpu.train.scenes import HardSyntheticHockeyDataset  # noqa: E402
from hockey_tpu_torch.train import data as tdata  # noqa: E402
from hockey_tpu_torch.train import device_aug as taug  # noqa: E402
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

S = 64
POOL = 12


@pytest.fixture(autouse=True)
def _one_thread(one_torch_thread):
    yield


@pytest.fixture(scope="module")
def pool_path(tmp_path_factory):
    """A pool of POOL hard scenes at S px in the `save_cache` format."""
    path = str(tmp_path_factory.mktemp("pool") / "pool.npz")
    HardSyntheticHockeyDataset(imgsz=S, seed=3, pool_size=POOL).save_cache(path)
    return path


def _pools(path):
    j = HardSyntheticHockeyDataset(imgsz=S, seed=3, pool_size=POOL)
    assert j.load_cache(path)
    return j, tdata.PoolDataset(path)


def _equal_items(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_bgr_to_hsv_equals_cv2_on_every_colour():
    g = np.stack(np.meshgrid(*[np.arange(256)] * 3, indexing="ij"),
                 -1).astype(np.uint8).reshape(4096, 4096, 3)
    np.testing.assert_array_equal(tdata.bgr_to_hsv(g),
                                  cv2.cvtColor(g, cv2.COLOR_BGR2HSV))


def test_hsv_to_bgr_equals_cv2():
    g = np.stack(np.meshgrid(np.arange(180), np.arange(256), np.arange(256),
                             indexing="ij"), -1).astype(np.uint8).reshape(-1, 4096, 3)
    np.testing.assert_array_equal(tdata.hsv_to_bgr(g),
                                  cv2.cvtColor(g, cv2.COLOR_HSV2BGR))
    rng = np.random.default_rng(0)
    odd = rng.integers(0, 256, (37, 53, 3)).astype(np.uint8)
    odd[..., 0] %= 180
    d = np.abs(tdata.hsv_to_bgr(odd).astype(int)
               - cv2.cvtColor(odd, cv2.COLOR_HSV2BGR))
    assert d.max() <= 1
    np.testing.assert_array_equal(d[:, :32], 0)  # the vectorised columns


def test_hsv_augment_matches_jax():
    img = _pools_img()
    for seed in range(4):
        np.testing.assert_array_equal(
            tdata.hsv_augment(img, np.random.default_rng(seed)),
            jdata.hsv_augment(img, np.random.default_rng(seed)))


def _pools_img():
    rng = np.random.default_rng(7)
    return rng.integers(0, 256, (S, S, 3)).astype(np.uint8)


def test_pool_load_with_flip_and_jitter_matches_jax(pool_path):
    j, t = _pools(pool_path)
    assert t.augmentable and len(t) == len(j) == POOL
    for i in range(POOL):
        for flip in (False, True):
            _equal_items(t.load(i, hsv_jitter=np.random.default_rng(i), flip=flip),
                         j.load(i, hsv_jitter=np.random.default_rng(i), flip=flip))


def test_mosaic_and_mixup_match_jax(pool_path):
    j, t = _pools(pool_path)
    items = [t.load(i) for i in range(8)]
    for seed in range(4):
        _equal_items(tdata.mosaic4(items[seed:seed + 4], np.random.default_rng(seed)),
                     jdata.mosaic4(items[seed:seed + 4], np.random.default_rng(seed)))
        _equal_items(tdata.mixup(items[seed], items[seed + 1], np.random.default_rng(seed)),
                     jdata.mixup(items[seed], items[seed + 1], np.random.default_rng(seed)))


def test_batch_iterator_matches_jax(pool_path):
    j, t = _pools(pool_path)
    kw = dict(batch_size=3, steps=3, seed=11, mosaic_prob=0.5, mixup_prob=0.3)
    got = list(tdata.batch_iterator(t, **kw))
    want = list(jdata.batch_iterator(j, **kw))
    assert len(got) == len(want) == 3
    for a, b in zip(got, want):
        _equal_items(a, b)


def test_yolo_dataset_load_with_flip_and_jitter_matches_jax(tmp_path):
    rng = np.random.default_rng(2)
    (tmp_path / "images").mkdir()
    (tmp_path / "labels").mkdir()
    for i, (h, w) in enumerate([(48, 80), (90, 60)]):
        cv2.imwrite(str(tmp_path / "images" / f"{i}.png"),
                    rng.integers(0, 256, (h, w, 3)).astype(np.uint8))
        (tmp_path / "labels" / f"{i}.txt").write_text(
            "0 0.5 0.5 0.3 0.4\n1 0.25 0.3 0.1 0.2\n")
    t = tdata.YoloDataset(str(tmp_path / "images"), imgsz=S)
    j = jdata.YoloDataset(str(tmp_path / "images"), imgsz=S)
    for i in range(2):
        for flip in (False, True):
            _equal_items(t.load(i, hsv_jitter=np.random.default_rng(i), flip=flip),
                         j.load(i, hsv_jitter=np.random.default_rng(i), flip=flip))


def test_keypoint_pool_is_not_augmentable(tmp_path):
    path = str(tmp_path / "rink.npz")
    np.savez(path, images=np.zeros((2, S, S, 3), np.uint8),
             boxes=np.zeros((2, 1, 4), np.float32), classes=np.zeros((2, 1), np.int32),
             counts=np.ones(2, np.int32), keypoints=np.zeros((2, 56, 3), np.float32))
    ds = tdata.PoolDataset(path)
    assert not ds.augmentable
    with pytest.raises(ValueError, match="not augmentable"):
        ds.load(0, flip=True)


# ---------------------------------------------------------------------------
# device transforms on JAX's draws

def _jax_draws(pool_n, batch, key, mixup):
    """make_device_batch_fn's draws, in its split order."""
    keys = jax.random.split(key, 2 * batch)
    n = 2 * batch if mixup else batch
    cols = {k: [] for k in ("mos_idx", "centre", "offset", "plain_idx", "sel",
                            "flip", "gains")}
    mix_keys = []
    for k in keys[:n]:
        k_sel, k_mos, k_plain, k_flip, k_hsv, k_mix = jax.random.split(k, 6)
        k_idx, k_c, k_off = jax.random.split(k_mos, 3)
        cols["mos_idx"].append(jax.random.randint(k_idx, (4,), 0, pool_n))
        cols["centre"].append(jax.random.uniform(k_c, (2,), minval=0.35, maxval=0.65))
        cols["offset"].append(jax.random.uniform(k_off, (4, 2)))
        cols["plain_idx"].append(jax.random.randint(k_plain, (), 0, pool_n))
        cols["sel"].append(jax.random.uniform(k_sel))
        cols["flip"].append(jax.random.uniform(k_flip))
        cols["gains"].append(jax.random.uniform(k_hsv, (3,), minval=-1.0, maxval=1.0))
        mix_keys.append(k_mix)
    out = {k: torch.from_numpy(np.stack([np.asarray(v) for v in vs]))
           for k, vs in cols.items()}
    out["mos_idx"], out["plain_idx"] = out["mos_idx"].long(), out["plain_idx"].long()
    out["lam"] = torch.from_numpy(np.asarray(jax.random.beta(
        mix_keys[0], 32.0, 32.0, (batch, 1, 1, 1))).reshape(batch))
    out["mix"] = torch.from_numpy(np.asarray(jax.random.uniform(
        mix_keys[1], (batch, 1, 1, 1))).reshape(batch))
    return out


def test_stage_pool_matches_jax(pool_path):
    _, t = _pools(pool_path)
    jpool, tpool = jaug.stage_pool(t), taug.stage_pool(t, device="cpu")
    assert jpool.keys() == tpool.keys()
    for k in jpool:
        np.testing.assert_array_equal(tpool[k].numpy(), np.asarray(jpool[k]))


def _rect_pool(n=8, m=16, seed=4):
    """Noise images with 2-6 large boxes each in tables of m = max_gt rows
    (the hard scenes' players are too small at S px to survive a mosaic's
    crop)."""
    rng = np.random.default_rng(seed)
    xy = rng.uniform(0, S - 24, (n, m, 2))
    boxes = np.concatenate([xy, xy + rng.uniform(8, 24, (n, m, 2))], -1)
    mask = np.arange(m)[None] < rng.integers(2, 7, (n, 1))
    return {"images": rng.integers(0, 256, (n, S, S, 3)).astype(np.uint8),
            "boxes": (boxes * mask[..., None]).astype(np.float32),
            "classes": (rng.integers(0, 2, (n, m)) * mask).astype(np.int32),
            "mask": mask}


@pytest.mark.parametrize("mosaic,mixup,seed", [(1.0, 0.15, 0), (0.5, 0.6, 1),
                                               (0.0, 0.0, 2)])
def test_device_batch_matches_jax_on_its_draws(mosaic, mixup, seed):
    pool = _rect_pool()
    jpool = {k: jnp.asarray(v) for k, v in pool.items()}
    tpool = {k: torch.from_numpy(v) for k, v in pool.items()}
    batch, key = 4, jax.random.PRNGKey(seed)
    want = jax.jit(jaug.make_device_batch_fn(S, batch, max_gt=16, mosaic_prob=mosaic,
                                             mixup_prob=mixup))(jpool, key)
    got = taug.augment_batch(tpool, _jax_draws(len(pool["images"]), batch, key,
                                               mixup > 0), S,
                             batch, max_gt=16, mosaic_prob=mosaic, mixup_prob=mixup)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]),
                               rtol=0, atol=1e-6)
    for k in ("boxes", "classes", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert got["mask"].any()


def test_pose_batch_matches_jax_on_its_draws():
    rng = np.random.default_rng(5)
    n, batch = 6, 3
    pool = {"images": rng.integers(0, 256, (n, S, S, 3)).astype(np.uint8),
            "boxes": rng.uniform(0, S, (n, 4, 4)).astype(np.float32),
            "classes": np.zeros((n, 4), np.int32),
            "mask": rng.uniform(size=(n, 4)) < 0.5,
            "keypoints": rng.uniform(0, S, (n, 4, 56, 3)).astype(np.float32)}
    key = jax.random.PRNGKey(3)
    want = jaug.make_pose_batch_fn(batch)(  # op by op: jit rewrites x / 6
        {k: jnp.asarray(v) for k, v in pool.items()}, key)
    k_idx, k_hsv = jax.random.split(key)
    draws = {"idx": torch.from_numpy(np.asarray(
                 jax.random.randint(k_idx, (batch,), 0, n))).long(),
             "gains": torch.from_numpy(np.stack([np.asarray(jax.random.uniform(
                 k, (3,), minval=-1.0, maxval=1.0)) for k in jax.random.split(k_hsv, batch)]))}
    got = taug.pose_batch({k: torch.from_numpy(v) for k, v in pool.items()}, draws)
    np.testing.assert_allclose(got["images"].numpy(), np.asarray(want["images"]),
                               rtol=0, atol=1e-6)
    for k in ("boxes", "classes", "mask", "keypoints"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)


def test_samplers_draw_the_jax_distributions():
    gen = torch.Generator().manual_seed(0)
    d = taug.sample_draws(gen, POOL, 512, mixup=True)
    assert d["mos_idx"].shape == (1024, 4) and d["gains"].shape == (1024, 3)
    assert d["lam"].shape == d["mix"].shape == (512,)
    assert 0 <= int(d["mos_idx"].min()) and int(d["mos_idx"].max()) < POOL
    assert 0.35 <= float(d["centre"].min()) and float(d["centre"].max()) < 0.65
    assert -1 <= float(d["gains"].min()) and float(d["gains"].max()) < 1
    # Beta(32, 32): mean 1/2, sd 1 / sqrt(4 * 65) ~ 0.062
    assert abs(float(d["lam"].mean()) - 0.5) < 0.01
    assert abs(float(d["lam"].std()) - 0.062) < 0.01
    again = taug.sample_draws(torch.Generator().manual_seed(0), POOL, 512, mixup=True)
    assert all(torch.equal(d[k], again[k]) for k in d)
    p = taug.sample_pose_draws(gen, 7, 5)
    assert p["idx"].shape == (5,) and p["gains"].shape == (5, 3)


def test_device_batch_fn_runs_on_its_own_draws(pool_path):
    _, t = _pools(pool_path)
    pool = taug.stage_pool(t, device="cpu")
    fn = taug.make_device_batch_fn(S, 3, mosaic_prob=1.0, mixup_prob=0.5)
    out = fn(pool, torch.Generator().manual_seed(1))
    assert out["images"].shape == (3, S, S, 3) and out["boxes"].shape == (3, 64, 4)
    assert 0 <= float(out["images"].min()) and float(out["images"].max()) <= 1
    assert out["mask"].any()

