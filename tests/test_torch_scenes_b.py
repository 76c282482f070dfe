"""Generator B of the port (hockey_tpu_torch/train/scenes_b.py) against the
JAX package's (hockey_tpu/train/scenes_b.py) on the CPU, bit for bit:
`render_scene_b` with players and with pucks on three seeds,
`render_scene_sequence_b` with its puck, `HardSyntheticHockeyDatasetB`'s
pool (threads, then one by one in another order) and `load`,
`SyntheticRinkDatasetB`'s items; and the val CLI's `--dataset hard-b`,
`hard-puck-b` and `rink-b` against the JAX CLI rebuilt at f32.
"""

import numpy as np
import pytest

cv2 = pytest.importorskip("cv2")

from hockey_tpu.train import scenes_b as JB  # noqa: E402
from hockey_tpu_torch.train import scenes_b as PB  # noqa: E402
from tests.test_torch_scenes import (  # noqa: E402,F401
    _one_thread, assert_same, check_val_dataset, f32_jax_and_zoos, player_ckpt,
    val_argv)
from tests.test_torch_session import one_torch_thread  # noqa: E402,F401

S = 160


@pytest.mark.parametrize("pucks", [False, True])
def test_render_scene_b_bit_equal(pucks):
    for seed in (0, 1, 2):
        assert_same(PB.render_scene_b(np.random.default_rng(seed), S, pucks=pucks),
                    JB.render_scene_b(np.random.default_rng(seed), S, pucks=pucks))


def test_render_scene_sequence_b_bit_equal():
    kw = dict(s=S, n_frames=4, include_puck=True)
    assert_same(PB.render_scene_sequence_b(np.random.default_rng(5), **kw),
                JB.render_scene_sequence_b(np.random.default_rng(5), **kw))


@pytest.mark.parametrize("pucks", [False, True])
def test_pool_b_equals_jax(pucks):
    mine = PB.HardSyntheticHockeyDatasetB(imgsz=128, seed=2, pool_size=5, pucks=pucks)
    theirs = JB.HardSyntheticHockeyDatasetB(imgsz=128, seed=2, pool_size=5, pucks=pucks)
    mine.pregenerate(workers=3)
    alone = PB.HardSyntheticHockeyDatasetB(imgsz=128, seed=2, pool_size=5, pucks=pucks)
    for i in (4, 1, 3, 0, 2):
        assert_same(alone._scene(i), mine._scene(i))
    for i in range(5):
        assert_same(mine.load(i), theirs.load(i))
    assert not mine.augmentable and len(mine) == 5


def test_rink_dataset_b_equals_jax():
    mine, theirs = PB.SyntheticRinkDatasetB(128, seed=3), JB.SyntheticRinkDatasetB(128, seed=3)
    for i in range(4):
        item = mine.load(i)
        assert_same(item, theirs.load(i))
        assert item["keypoints"].shape == (4, 56, 3)


@pytest.mark.parametrize("dataset", ["hard-b", "hard-puck-b", "rink-b"])
def test_val_cli_dataset_b_matches_jax(player_ckpt, dataset, capsys):
    if dataset == "rink-b":  # the shipped rink pose model
        argv = ["--model", "hockey-detection", "--imgsz", "256", "--limit", "8",
                "--dataset", dataset]
        jax_ds = JB.SyntheticRinkDatasetB(imgsz=256, seed=7777)
    else:
        argv = val_argv(dataset, player_ckpt)
        s = int(argv[argv.index("--imgsz") + 1])
        jax_ds = JB.HardSyntheticHockeyDatasetB(imgsz=s, seed=7777, pool_size=8,
                                                pucks=dataset == "hard-puck-b")
    want = check_val_dataset(argv, jax_ds, capsys)
    if dataset == "hard-puck-b":
        assert want["mAP50"] > 0.2
    if dataset == "rink-b":
        assert want["pck"] > 0.2
