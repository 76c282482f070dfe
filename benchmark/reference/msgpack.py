"""A frozen copy of the program's reader of flax msgpack checkpoints:
the subset of msgpack that `flax.serialization.msgpack_serialize` writes
(maps, lists and ext-type-1 array leaves), decoded in pure Python, so the
reference reads the shipped weight files itself. float16 leaves come back
as float32. Nothing here imports the program.
"""

from __future__ import annotations

import struct
from typing import Any, Dict

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


def load_tree(path: str) -> Dict:
    """Checkpoint file -> nested dicts and lists of numpy arrays (f16 ->
    f32)."""
    with open(path, "rb") as f:
        return _f16_to_f32(msgpack_restore(f.read()))
