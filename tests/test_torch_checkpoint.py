"""The port's pure-Python msgpack decoder against flax's own restore:
leaves bit for bit, structure (dicts and lists) alike; and its writer
against flax's `msgpack_serialize` and the JAX package's `save_params`,
byte for byte."""

import numpy as np
import pytest
from flax import serialization

from hockey_tpu.models.checkpoint import load_params as jax_load_params
from hockey_tpu.models.checkpoint import save_params as jax_save_params
from hockey_tpu_torch.models.checkpoint import (
    flatten_tree,
    load_params,
    msgpack_restore,
    msgpack_serialize,
    save_params,
    shipped_weights_path,
)


def _assert_same_tree(got, want):
    assert type(got) is type(want)
    if isinstance(want, dict):
        assert list(got) == list(want)
        for k in want:
            _assert_same_tree(got[k], want[k])
    elif isinstance(want, list):
        assert len(got) == len(want)
        for a, b in zip(got, want):
            _assert_same_tree(a, b)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    else:
        assert got == want


@pytest.mark.parametrize("name,n_leaves,dtype", [
    ("jersey_digits", 14, np.float32),
    ("hockey-detection", 333, np.float16),
])
def test_shipped_checkpoint_matches_flax(name, n_leaves, dtype):
    path = shipped_weights_path(name)
    with open(path, "rb") as f:
        data = f.read()
    got = msgpack_restore(data)
    _assert_same_tree(got, serialization.msgpack_restore(data))
    leaves = flatten_tree(got)
    assert len(leaves) == n_leaves
    assert {v.dtype for v in leaves.values()} == {np.dtype(dtype)}


def test_fresh_tree_roundtrip(tmp_path, rng):
    tree = {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "half": rng.standard_normal((5,)).astype(np.float16),
        "ints": rng.integers(-2**31, 2**31 - 1, (2, 3)).astype(np.int32),
        "m": [{"w": rng.standard_normal((2, 2, 3, 4)).astype(np.float32)},
              [np.zeros((0,), np.float32), np.float32(rng.standard_normal((1,)))]],
        "scalar": np.asarray(1.5, np.float32),
    }
    meta = {"n": 7, "neg": -300, "big": 2**40, "f": 0.25, "s": "x" * 40,
            "none": None, "flag": True}
    data = serialization.msgpack_serialize({**tree, "meta": meta})
    _assert_same_tree(msgpack_restore(data), serialization.msgpack_restore(data))

    # load_params: f16 leaves come back as f32, like the JAX package's
    path = tmp_path / "tree.msgpack"
    path.write_bytes(serialization.msgpack_serialize(tree))
    got, want = load_params(str(path)), jax_load_params(str(path))
    for k, v in flatten_tree(want).items():
        g = flatten_tree(got)[k]
        want_np = np.asarray(v)
        assert g.dtype == want_np.dtype, k
        np.testing.assert_array_equal(g, want_np)
    assert got["half"].dtype == np.float32


@pytest.mark.parametrize("dtype", [None, "float16"])
def test_writer_bytes_match_flax(tmp_path, rng, dtype):
    """f32, f16 and integer leaves, nested lists, a 0-d array and arrays
    whose ext payloads cross msgpack's fixext, ext8, ext16 and ext32
    sizes: the port's bytes are flax's, and its file is the JAX
    package's `save_params` file (f32 leaves stored as f16 with
    `dtype='float16'`)."""
    tree = {
        "a": rng.standard_normal((3, 4)).astype(np.float32),
        "big": rng.standard_normal((130, 130)).astype(np.float32),  # ext32
        "half": rng.standard_normal((5,)).astype(np.float16),
        "ints": rng.integers(-2**31, 2**31 - 1, (2, 3)).astype(np.int32),
        "longs": rng.integers(-2**62, 2**62, (70,)).astype(np.int64),  # ext16
        "m": [{"bn": {"mean": rng.standard_normal((3,)).astype(np.float32)},
               "w": rng.standard_normal((2, 2, 3, 4)).astype(np.float32)},
              [np.zeros((0,), np.float32), np.ones((1,), np.uint8)]],
        "scalar": np.asarray(1.5, np.float32),
    }
    assert msgpack_serialize(tree) == serialization.msgpack_serialize(tree)
    got, want = tmp_path / "port.msgpack", tmp_path / "jax.msgpack"
    save_params(str(got), tree, dtype=dtype)
    jax_save_params(str(want), tree, dtype=dtype)
    assert got.read_bytes() == want.read_bytes()
    back = flatten_tree(serialization.msgpack_restore(got.read_bytes()))
    for k, v in flatten_tree(tree).items():
        stored = v.astype(dtype) if dtype and v.dtype == np.float32 else v
        assert back[k].dtype == stored.dtype, k
        np.testing.assert_array_equal(back[k], stored)
