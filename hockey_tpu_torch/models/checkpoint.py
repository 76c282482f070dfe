"""Reading and writing the JAX package's checkpoints without flax or
msgpack.

The shipped weights (`hockey_tpu/data/weights/*.msgpack`) are written by
`flax.serialization.msgpack_serialize`: a msgpack tree of maps, lists and
ext-type-1 array leaves, each leaf's payload itself a msgpack
`[shape, dtype-name, raw C-order bytes]` (flax `_ndarray_to_bytes`). This
module decodes exactly that subset of msgpack in pure Python, so the port
loads weights on a machine that has neither package, and `save_params`
encodes a tree of that subset as flax does, byte for byte, so the JAX
package's `load_params` reads the port's checkpoints. The shipped files are
read in place; nothing is converted or copied into the tree.

f16-shipped leaves come back as f32, as hockey_tpu/models/checkpoint.py
`load_params` does.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np

_EXT_NDARRAY = 1  # flax _MsgpackExtType.ndarray


class _Reader:
    """Cursor over one msgpack buffer."""

    def __init__(self, data):
        self.buf = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# fixed-width headers: type byte -> (struct format of the length/value)
_UINT = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q"}
_INT = {0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
_BIN = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
_STR = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
_ARRAY = {0xDC: ">H", 0xDD: ">I"}
_MAP = {0xDE: ">H", 0xDF: ">I"}
_EXT = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}


def _decode(r: _Reader) -> Any:
    t = r.take(1)[0]
    if t <= 0x7F:
        return t
    if t >= 0xE0:
        return t - 0x100
    if 0x80 <= t <= 0x8F:
        return _map(r, t & 0x0F)
    if 0x90 <= t <= 0x9F:
        return [_decode(r) for _ in range(t & 0x0F)]
    if 0xA0 <= t <= 0xBF:
        return str(r.take(t & 0x1F), "utf-8")
    if t == 0xC0:
        return None
    if t == 0xC2:
        return False
    if t == 0xC3:
        return True
    if t == 0xCA:
        return r.unpack(">f")
    if t == 0xCB:
        return r.unpack(">d")
    if t in _UINT:
        return r.unpack(_UINT[t])
    if t in _INT:
        return r.unpack(_INT[t])
    if t in _BIN:
        return bytes(r.take(r.unpack(_BIN[t])))
    if t in _STR:
        return str(r.take(r.unpack(_STR[t])), "utf-8")
    if t in _ARRAY:
        return [_decode(r) for _ in range(r.unpack(_ARRAY[t]))]
    if t in _MAP:
        return _map(r, r.unpack(_MAP[t]))
    if t in _EXT:
        n = r.unpack(_EXT[t])
        return _ext(r.unpack(">b"), r.take(n))
    if t in _FIXEXT:
        code = r.unpack(">b")
        return _ext(code, r.take(_FIXEXT[t]))
    raise ValueError(f"unsupported msgpack type byte 0x{t:02x}")


def _map(r: _Reader, n: int) -> Dict:
    out = {}
    for _ in range(n):
        k = _decode(r)
        out[k] = _decode(r)
    return out


def _ext(code: int, payload: memoryview) -> np.ndarray:
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, raw = _decode(_Reader(payload))
    if dtype_name == "bfloat16":
        raise ValueError("bfloat16 leaves are not supported")
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape)


def msgpack_restore(data: bytes) -> Any:
    """Decode a flax msgpack checkpoint into nested dicts/lists of numpy
    arrays, leaves bit-identical to flax.serialization.msgpack_restore."""
    r = _Reader(data)
    tree = _decode(r)
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return tree


def _f16_to_f32(tree):
    if isinstance(tree, dict):
        return {k: _f16_to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_f16_to_f32(v) for v in tree]
    if isinstance(tree, np.ndarray) and tree.dtype == np.float16:
        return tree.astype(np.float32)
    return tree


def load_params(path: str) -> Dict:
    """Checkpoint file -> parameter tree of numpy arrays (f16 -> f32)."""
    with open(path, "rb") as f:
        return _f16_to_f32(msgpack_restore(f.read()))


def _pack_uint(out: bytearray, n: int, fix_max: int, fix_base: int,
               heads) -> None:
    """A length or count header: the fixed form below `fix_max`, else the
    smallest of `heads` ((limit, type byte, struct format) in order)."""
    if n < fix_max:
        out.append(fix_base | n)
        return
    for limit, code, fmt in heads:
        if n < limit:
            out.append(code)
            out += struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


_BIN_HEADS = ((1 << 8, 0xC4, ">B"), (1 << 16, 0xC5, ">H"), (1 << 32, 0xC6, ">I"))
_STR_HEADS = ((1 << 8, 0xD9, ">B"), (1 << 16, 0xDA, ">H"), (1 << 32, 0xDB, ">I"))
_ARRAY_HEADS = ((1 << 16, 0xDC, ">H"), (1 << 32, 0xDD, ">I"))
_MAP_HEADS = ((1 << 16, 0xDE, ">H"), (1 << 32, 0xDF, ">I"))
_FIXEXT_CODE = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}


def _encode(out: bytearray, x) -> None:
    """Append `x` (dict with str keys, list, tuple, str, bytes, int or
    numpy array) as msgpack-python's `packb` writes it, arrays as flax's
    ext type 1 and dict keys sorted (flax rebuilds the tree with
    jax.tree_util, which sorts them)."""
    if isinstance(x, dict):
        _pack_uint(out, len(x), 16, 0x80, _MAP_HEADS)
        for k, v in sorted(x.items()):
            _encode(out, k)
            _encode(out, v)
    elif isinstance(x, (list, tuple)):
        _pack_uint(out, len(x), 16, 0x90, _ARRAY_HEADS)
        for v in x:
            _encode(out, v)
    elif isinstance(x, str):
        b = x.encode("utf-8")
        _pack_uint(out, len(b), 32, 0xA0, _STR_HEADS)
        out += b
    elif isinstance(x, bytes):
        _pack_uint(out, len(x), 0, 0, _BIN_HEADS)
        out += x
    elif isinstance(x, (int, np.integer)) and not isinstance(x, bool):
        x = int(x)
        if 0 <= x < 0x80:
            out.append(x)
        elif -32 <= x < 0:
            out.append(x & 0xFF)
        elif x >= 0:
            for limit, (code, fmt) in zip((1 << 8, 1 << 16, 1 << 32, 1 << 64),
                                          _UINT.items()):
                if x < limit:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} too large for msgpack")
        else:
            for limit, (code, fmt) in zip((1 << 7, 1 << 15, 1 << 31, 1 << 63),
                                          _INT.items()):
                if -limit <= x:
                    out.append(code)
                    out += struct.pack(fmt, x)
                    return
            raise ValueError(f"integer {x} too large for msgpack")
    elif isinstance(x, np.ndarray):
        if x.dtype.hasobject or x.dtype.names is not None:
            raise ValueError(f"unsupported array dtype {x.dtype}")
        payload = bytearray()
        _encode(payload, (list(x.shape), x.dtype.name, x.tobytes("C")))
        n = len(payload)
        if n in _FIXEXT_CODE:
            out.append(_FIXEXT_CODE[n])
        else:
            _pack_uint(out, n, 0, 0, tuple(zip((1 << 8, 1 << 16, 1 << 32),
                                               _EXT, _EXT.values())))
        out += struct.pack(">b", _EXT_NDARRAY)
        out += payload
    else:
        raise TypeError(f"cannot encode {type(x).__name__} in a checkpoint")


def msgpack_serialize(tree) -> bytes:
    """Nested dicts/lists of numpy arrays -> the bytes that
    flax.serialization.msgpack_serialize gives for the same tree (arrays
    below flax's 1 GiB chunking size)."""
    out = bytearray()
    _encode(out, tree)
    return bytes(out)


def save_params(path: str, tree: Dict, dtype=None) -> None:
    """Write a parameter tree (numpy arrays, e.g. `params_to_jax`) as a
    checkpoint the JAX package's `load_params` reads; `dtype='float16'`
    stores f32 leaves as f16, as hockey_tpu/models/checkpoint.py
    `save_params` does."""
    def cast(t):
        if isinstance(t, dict):
            return {k: cast(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [cast(v) for v in t]
        a = np.asarray(t)
        return a.astype(dtype) if dtype is not None and a.dtype == np.float32 else a

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    data = msgpack_serialize(cast(tree))
    with open(path, "wb") as f:
        f.write(data)


def shipped_weights_path(model_name: str) -> Optional[str]:
    """The JAX package's shipped checkpoint for `model_name`
    (hockey_tpu/data/weights/<name>.msgpack, read in place), or None."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    path = os.path.join(root, "hockey_tpu", "data", "weights",
                        f"{model_name}.msgpack")
    return path if os.path.exists(path) else None


def flatten_tree(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], Any]:
    """Nested dicts/lists -> {path tuple: leaf}; list items are keyed by
    their index as a string (the nn.ModuleList naming)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out = {}
    for k, v in items:
        out.update(flatten_tree(v, prefix + (str(k),)))
    return out
