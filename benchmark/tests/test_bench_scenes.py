"""The benchmark's scene drawers, frozen copies of chip_smoke.py's, draw
the same pixels for a seed; the ping-pong play and a traffic file's clip."""

import numpy as np
import pytest

from benchmark.harness.cell import load_json, BENCH_DIR
from benchmark.traffic import scenes


@pytest.fixture(scope="module")
def chip_smoke():
    return pytest.importorskip("chip_smoke")


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 3])
def test_frames_equal_chip_smokes(chip_smoke, seed):
    np.testing.assert_array_equal(scenes.synthetic_frames(seed, 3),
                                  chip_smoke.synthetic_frames(seed, 3))


def test_puck_scene_equals_chip_smokes(chip_smoke):
    np.testing.assert_array_equal(scenes.puck_scene(5, 3), chip_smoke.puck_scene(5, 3))
    np.testing.assert_array_equal(scenes.puck_path(9), chip_smoke.puck_path(9))


def test_pingpong():
    assert [scenes.pingpong(i, 4) for i in range(10)] == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3]
    src = scenes.PingPong(np.arange(4)[:, None])
    assert [int(next(src)[0]) for _ in range(7)] == [0, 1, 2, 3, 2, 1, 0]
    assert len(src.pulled) == 7 and src.pulled == sorted(src.pulled)


@pytest.mark.parametrize("cell", ["classify-fused", "puck-sliced", "detect-only"])
def test_traffic_files_draw(cell):
    """A seed gives the same clip and start every time; seeds differ by
    the mirror, the kits and the start, never by the skaters' paths."""
    params = dict(load_json(BENCH_DIR, "workloads", f"{cell}.json")["traffic"], frames=2)
    (a, sa), (b, sb) = scenes.clip(params, 11), scenes.clip(params, 11)
    assert a.shape == (2, 1080, 1920, 3) and a.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    assert sa == sb and 0 <= sa < 2
    base = scenes.synthetic_frames(0, 1, players=0)[0]
    figures = lambda c: (c != base).any(-1)  # noqa: E731  (where anything is drawn)
    first = figures(scenes.clip(params, 0)[0])
    for seed in range(1, 20):
        f = figures(scenes.clip(params, seed)[0])
        assert np.array_equal(f, first) or np.array_equal(f[:, :, ::-1], first)
    assert len({scenes.clip(params, s)[0][0, 540].tobytes() for s in range(20)}) == 4


def test_pingpong_start():
    src = scenes.PingPong(np.arange(4)[:, None], start=5)
    assert [int(next(src)[0]) for _ in range(4)] == [1, 0, 1, 2]
