"""A pure-Python reader and writer for the bytes of flax's
``serialization.to_bytes`` / ``msgpack_restore``.

The JAX package stores variables and training states in that format
(``hcunet_tpu/utils/checkpoint.py``, ``train/trainer.py``).  Neither msgpack
nor flax is installed where the port runs, so the port carries this codec
for exactly what those files hold:

* msgpack maps (str keys), arrays, ints, floats, bool, nil, str and bin;
* ext type 1, an ndarray: the msgpack array ``(shape, dtype name, raw C-order
  bytes)``;
* ext type 3, a numpy scalar, stored as a 0-d ndarray;
* flax's chunked arrays: an array of more than ``MAX_CHUNK_SIZE`` bytes is
  stored as ``{"__msgpack_chunked_array__": True, "shape": {...},
  "chunks": {...}}`` of flat pieces.

The writer makes the same encoding choices as msgpack-python's packer and
keeps each map's key order, as ``to_bytes`` does, so :func:`to_bytes` of a
tree of dicts, lists and numpy arrays gives the bytes flax's ``to_bytes``
gives.  A ``bfloat16`` array (which numpy cannot hold) is read widened
to float32, exactly.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np

MAX_CHUNK_SIZE = 2**30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------


def _pack_int(v: int, out: bytearray) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out += struct.pack(">b", v)
    elif v >= 0:
        for tag, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                              (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", 2**64 - 1)):
            if v <= top:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's uint64")
    else:
        for tag, fmt, low in ((0xD0, ">b", -(2**7)), (0xD1, ">h", -(2**15)),
                              (0xD2, ">i", -(2**31)), (0xD3, ">q", -(2**63))):
            if v >= low:
                out.append(tag)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack's int64")


def _pack_len(n: int, small_tag: int, small_max: int, tags, out: bytearray) -> None:
    """A length header: ``small_tag | n`` below ``small_max``, else the
    first of ``tags`` (8-, 16-, 32-bit lengths; None where msgpack has no
    such form) that holds ``n``."""
    if small_tag is not None and n < small_max:
        out.append(small_tag | n)
        return
    for tag, fmt, top in zip(tags, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if tag is not None and n <= top:
            out.append(tag)
            out += struct.pack(fmt, n)
            return
    raise OverflowError(f"length {n} does not fit msgpack")


def _pack_ext(code: int, data: bytes, out: bytearray) -> None:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        out.append(fixed[len(data)])
    else:
        _pack_len(len(data), None, 0, (0xC7, 0xC8, 0xC9), out)
    out += struct.pack(">b", code)
    out += data


def _ndarray_bytes(a: np.ndarray) -> bytes:
    """flax's ``_ndarray_to_bytes``: ``packb((shape, dtype name, bytes))``."""
    if a.dtype.hasobject or a.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    out = bytearray()
    _pack([list(a.shape), a.dtype.name, a.tobytes("C")], out)
    return bytes(out)


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif type(obj) is int:
        _pack_int(obj, out)
    elif type(obj) is float:
        out.append(0xCB)
        out += struct.pack(">d", obj)
    elif type(obj) is str:
        raw = obj.encode("utf-8")
        _pack_len(len(raw), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out += raw
    elif type(obj) in (bytes, bytearray, memoryview):
        raw = bytes(obj)
        _pack_len(len(raw), None, 0, (0xC4, 0xC5, 0xC6), out)
        out += raw
    elif type(obj) is list:
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for v in obj:
            _pack(v, out)
    elif type(obj) is dict:
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        _pack_ext(_EXT_NDARRAY, _ndarray_bytes(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(_EXT_NPSCALAR, _ndarray_bytes(np.asarray(obj)), out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _chunk(a: np.ndarray) -> dict:
    """flax's ``_chunk``: an oversized array as flat pieces."""
    size = max(1, int(MAX_CHUNK_SIZE / a.dtype.itemsize))
    flat = a.reshape(-1)
    return {
        _CHUNKED: True,
        "shape": {str(i): s for i, s in enumerate(a.shape)},
        "chunks": {str(i): flat[j : j + size] for i, j in enumerate(range(0, flat.size, size))},
    }


def _state_dict(tree):
    """The tree as flax's ``to_state_dict`` leaves it (lists and tuples as
    dicts keyed "0", "1", ...; keys as str), with oversized arrays
    chunked."""
    if isinstance(tree, (list, tuple)):
        tree = {str(i): v for i, v in enumerate(tree)}
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, np.ndarray) and tree.nbytes > MAX_CHUNK_SIZE:
        return _chunk(tree)
    return tree


def to_bytes(tree) -> bytes:
    """The bytes ``flax.serialization.to_bytes`` gives for a tree of dicts,
    lists and tuples with Python scalars, str, bytes and numpy arrays or
    scalars as leaves (arrays above ``MAX_CHUNK_SIZE`` bytes chunked)."""
    out = bytearray()
    _pack(_state_dict(tree), out)
    return bytes(out)


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------


class _Reader:
    def __init__(self, data: bytes, raw_str: bool = False):
        self.data = memoryview(data)
        self.pos = 0
        self.raw_str = raw_str

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos : self.pos + n].tobytes()
        self.pos += n
        return b

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        raw = self.take(n)
        return raw if self.raw_str else raw.decode("utf-8")

    def read(self):
        t = self.take(1)[0]
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.read() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in simple:
            return simple[t]
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I",
                   0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I", 0xC7: ">B", 0xC8: ">H",
                   0xC9: ">I", 0xD9: ">B", 0xDA: ">H", 0xDB: ">I", 0xDC: ">H",
                   0xDD: ">I", 0xDE: ">H", 0xDF: ">I"}
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if t in fixext:
            return self.ext(fixext[t])
        if t not in lengths:
            raise ValueError(f"msgpack type byte {t:#x} is not supported")
        n = self.unpack(lengths[t])
        if t <= 0xC6:
            return self.take(n)
        if t <= 0xC9:
            return self.ext(n)
        if t <= 0xDB:
            return self.str_(n)
        if t <= 0xDD:
            return [self.read() for _ in range(n)]
        return self.map_(n)

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.unpack(">b")
        data = self.take(n)
        if code == _EXT_NDARRAY:
            return _ndarray_from_bytes(data)
        if code == _EXT_NPSCALAR:
            return _ndarray_from_bytes(data)[()]
        name = "a complex number" if code == _EXT_COMPLEX else f"ext type {code}"
        raise ValueError(f"{name} is not supported by the port's flax codec")


def _ndarray_from_bytes(data: bytes) -> np.ndarray:
    shape, name, buf = _Reader(data, raw_str=True).read()
    name = name.decode()
    if name == "bfloat16":
        u16 = np.frombuffer(buf, np.uint16)
        return (u16.astype(np.uint32) << 16).view(np.float32).reshape(shape)
    return np.frombuffer(buf, np.dtype(name)).reshape(shape).copy()


def _unchunk(d: dict) -> np.ndarray:
    shape = tuple(d["shape"][str(i)] for i in range(len(d["shape"])))
    flat = np.concatenate([d["chunks"][str(i)] for i in range(len(d["chunks"]))])
    return flat.reshape(shape)


def _unchunk_leaves(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            return _unchunk(tree)
        return {k: _unchunk_leaves(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """The tree ``flax.serialization.msgpack_restore`` gives for ``data``:
    nested dicts and lists with numpy leaves (chunked arrays joined)."""
    reader = _Reader(data)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk_leaves(tree)
