"""A reader of flax's msgpack bytes, in plain Python and numpy.

The JAX package writes its checkpoints with `flax.serialization.to_bytes`
(stemgnn_tpu/train/checkpoint.py): msgpack of a tree of maps with string
keys, whose array leaves are msgpack extension types. This module decodes
that format without `msgpack`, `flax` or `ml_dtypes`, none of which the port
needs:

- maps, arrays, strings, bin, ints, floats, nil and bool (the msgpack spec);
- ext 1, an ndarray: a nested msgpack array of (shape, dtype name, the
  C-order bytes);
- ext 3, a numpy scalar: an ndarray of shape (), returned as its scalar;
- ext 2, a Python complex: a nested msgpack array (real, imag);
- flax's chunked arrays: an array of more than `flax.serialization.
  MAX_CHUNK_SIZE` bytes is stored as {"__msgpack_chunked_array__": True,
  "shape": {...}, "chunks": {...}}, its flattened chunks to concatenate.

numpy cannot name bfloat16 without ml_dtypes, so a bfloat16 array comes back
as a torch tensor of dtype bfloat16, from its 16-bit patterns; every other
array as a numpy array of its dtype.

flax stores a list or tuple as a map with keys "0", "1", ...:
`msgpack_restore` keeps those maps as flax's own `msgpack_restore` does, and
`as_lists` turns them back into lists in integer order ("10" after "9").

Truncated bytes, trailing bytes, an unknown type byte or an unknown
extension code raise a ValueError that names them: nothing is skipped.
"""

from __future__ import annotations

import struct
from typing import Any

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"


class _Reader:
    """Decodes one msgpack object from `buf` at a time, from `pos` on."""

    def __init__(self, buf, raw: bool = False):
        self.buf = memoryview(buf)
        self.pos = 0
        self.raw = raw  # strings as bytes (flax's nested ndarray header) or str

    def take(self, n: int) -> memoryview:
        end = self.pos + n
        if end > len(self.buf):
            raise ValueError(f"msgpack truncated: {n} bytes needed at offset {self.pos}, "
                             f"{len(self.buf) - self.pos} left")
        out = self.buf[self.pos:end]
        self.pos = end
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def str_(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b")
        return _ext(code, bytes(self.take(n)))

    def obj(self) -> Any:
        at = self.pos
        t = self.unpack(">B")
        if t <= 0x7F:
            return t
        if t >= 0xE0:
            return t - 0x100
        if 0x80 <= t <= 0x8F:
            return self.map_(t & 0x0F)
        if 0x90 <= t <= 0x9F:
            return [self.obj() for _ in range(t & 0x0F)]
        if 0xA0 <= t <= 0xBF:
            return self.str_(t & 0x1F)
        fixed = {0xC0: None, 0xC2: False, 0xC3: True}
        if t in fixed:
            return fixed[t]
        sized = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}  # bin 8, 16, 32
        if t in sized:
            return bytes(self.take(self.unpack(sized[t])))
        sized = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}  # ext 8, 16, 32
        if t in sized:
            return self.ext(self.unpack(sized[t]))
        scalars = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if t in scalars:
            return self.unpack(scalars[t])
        if 0xD4 <= t <= 0xD8:  # fixext 1, 2, 4, 8, 16
            return self.ext(1 << (t - 0xD4))
        sized = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}  # str 8, 16, 32
        if t in sized:
            return self.str_(self.unpack(sized[t]))
        if t in (0xDC, 0xDD):  # array 16, 32
            return [self.obj() for _ in range(self.unpack(">H" if t == 0xDC else ">I"))]
        if t in (0xDE, 0xDF):  # map 16, 32
            return self.map_(self.unpack(">H" if t == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{t:02x} at offset {at} is not a type")

    def map_(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.obj()
            out[k] = self.obj()
        return out


def unpackb(blob, raw: bool = False) -> Any:
    """The one msgpack object in `blob`, flax's extension types decoded."""
    r = _Reader(blob, raw)
    out = r.obj()
    if r.pos != len(r.buf):
        raise ValueError(f"msgpack: {len(r.buf) - r.pos} bytes after the object, "
                         f"at offset {r.pos}")
    return out


def _ndarray(data: bytes):
    """flax's `_ndarray_from_bytes`: (shape, dtype name, C-order bytes)."""
    shape, name, buffer = unpackb(data, raw=True)
    shape = tuple(shape)
    name = name.decode("ascii") if isinstance(name, bytes) else name
    if name == "bfloat16":
        bits = np.frombuffer(buffer, dtype=np.uint16).reshape(shape).copy()
        return torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    dtype = np.dtype(name)
    if len(buffer) != dtype.itemsize * int(np.prod(shape, dtype=np.int64)):
        raise ValueError(f"ndarray of shape {shape} and dtype {name}: "
                         f"{len(buffer)} bytes")
    return np.frombuffer(buffer, dtype=dtype).reshape(shape).copy()


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(data)
    if code == EXT_NPSCALAR:
        a = _ndarray(data)
        return a if isinstance(a, torch.Tensor) else a[()]
    if code == EXT_COMPLEX:
        re, im = unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack extension type {code} is none of flax's (ndarray "
                     f"{EXT_NDARRAY}, complex {EXT_COMPLEX}, numpy scalar {EXT_NPSCALAR})")


def _indexed(d: dict) -> list:
    """The values of flax's map of a list, in integer order of its keys."""
    return [d[str(i)] for i in range(len(d))]


def _unchunk(d: dict):
    """flax's `_unchunk`: the chunks concatenated, reshaped."""
    shape = tuple(_indexed(d["shape"]))
    chunks = _indexed(d["chunks"])
    if isinstance(chunks[0], torch.Tensor):
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return np.concatenate(chunks).reshape(shape)


def _restore_chunks(tree):
    if isinstance(tree, dict):
        if CHUNKED in tree:
            return _unchunk(tree)
        return {k: _restore_chunks(v) for k, v in tree.items()}
    return tree


def msgpack_restore(blob) -> Any:
    """flax.serialization.msgpack_restore: the tree `to_bytes` wrote, its
    chunked arrays reassembled."""
    return _restore_chunks(unpackb(blob))


def _is_list_map(d: dict) -> bool:
    return bool(d) and all(isinstance(k, str) and k.isdigit() for k in d) and \
        set(d) == {str(i) for i in range(len(d))}


def as_lists(tree):
    """`tree` with every map whose keys are "0" to "n-1" as a list, in integer
    order (flax's state dict of a list or tuple)."""
    if isinstance(tree, dict):
        if _is_list_map(tree):
            return [as_lists(v) for v in _indexed(tree)]
        return {k: as_lists(v) for k, v in tree.items()}
    return tree
