"""The bytes the JAX package's `checkpoint.save` writes, without JAX: a
msgpack packer of flax's state dicts (`flax.serialization.to_bytes`:
msgpack.packb with flax's ndarray and numpy-scalar extension types) and the
JAX package's file layout (an 8-byte little-endian header length, the JSON
meta, the msgpack bytes). chip_smoke.py times the port's reading of such a
file at the ECG flagship's width on a host that has no JAX;
tests/test_torch_port_fixtures.py holds these bytes to flax's own.

`jax_layout` gives a tree the layout JAX and flax give it: each dict's keys
sorted (jax.tree rebuilds dicts in key order) and each list a map of "0",
"1", ... (flax's state dict of a list).
"""

from __future__ import annotations

import json
import struct

import numpy as np


def _int(v: int) -> bytes:
    if 0 <= v < 0x80:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for code, fmt, top in ((0xCC, ">B", 1 << 8), (0xCD, ">H", 1 << 16),
                               (0xCE, ">I", 1 << 32), (0xCF, ">Q", 1 << 64)):
            if v < top:
                return bytes([code]) + struct.pack(fmt, v)
    for code, fmt, bits in ((0xD0, ">b", 7), (0xD1, ">h", 15), (0xD2, ">i", 31),
                            (0xD3, ">q", 63)):
        if v >= -(1 << bits):
            return bytes([code]) + struct.pack(fmt, v)
    raise ValueError(f"{v} does not fit in 64 bits")


def _sized(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A header of a str, bin, array or map of n entries or bytes."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in codes:
        if n < top:
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"{n} entries")


_STR = ((0xD9, ">B", 1 << 8), (0xDA, ">H", 1 << 16), (0xDB, ">I", 1 << 32))
_BIN = ((0xC4, ">B", 1 << 8), (0xC5, ">H", 1 << 16), (0xC6, ">I", 1 << 32))
_ARRAY = ((0xDC, ">H", 1 << 16), (0xDD, ">I", 1 << 32))
_MAP = ((0xDE, ">H", 1 << 16), (0xDF, ">I", 1 << 32))
_FIXEXT = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
_EXT = ((0xC7, ">B", 1 << 8), (0xC8, ">H", 1 << 16), (0xC9, ">I", 1 << 32))


def _ext(code: int, data: bytes) -> bytes:
    n = len(data)
    head = bytes([_FIXEXT[n]]) if n in _FIXEXT else _sized(n, None, -1, _EXT)
    return head + struct.pack(">b", code) + data


def packb(obj) -> bytes:
    """msgpack of `obj` as flax packs a state dict."""
    if obj is None:
        return b"\xc0"
    if isinstance(obj, bool):
        return b"\xc3" if obj else b"\xc2"
    if isinstance(obj, int):
        return _int(obj)
    if isinstance(obj, float):
        return b"\xcb" + struct.pack(">d", obj)
    if isinstance(obj, str):
        b = obj.encode("utf-8")
        return _sized(len(b), 0xA0, 31, _STR) + b
    if isinstance(obj, bytes):
        return _sized(len(obj), None, -1, _BIN) + obj
    if isinstance(obj, (list, tuple)):
        return _sized(len(obj), 0x90, 15, _ARRAY) + b"".join(packb(v) for v in obj)
    if isinstance(obj, dict):
        return _sized(len(obj), 0x80, 15, _MAP) + b"".join(
            packb(k) + packb(v) for k, v in obj.items())
    if isinstance(obj, np.ndarray):
        return _ext(1, packb((tuple(obj.shape), obj.dtype.name, obj.tobytes("C"))))
    if isinstance(obj, np.generic):
        a = np.asarray(obj)
        return _ext(3, packb((tuple(a.shape), a.dtype.name, a.tobytes("C"))))
    raise TypeError(f"cannot pack {type(obj)}")


def jax_layout(tree):
    if isinstance(tree, dict):
        return {str(k): jax_layout(tree[k]) for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return {str(i): jax_layout(v) for i, v in enumerate(tree)}
    return tree


def checkpoint_bytes(params, opt_state=None, meta=None) -> bytes:
    """A file of the JAX package's `checkpoint.save` of these numpy trees
    (in `jax_layout`)."""
    state = {"params": params}
    if opt_state is not None:
        state["opt_state"] = opt_state
    header = json.dumps(meta or {}).encode("utf-8")
    return struct.pack("<Q", len(header)) + header + packb(state)


def rmsprop_state(nu, count: int, lr: float):
    """The JAX package's RMSProp state under optax.inject_hyperparams in its
    layout: f32 hyperparameters, the int32 count and the moments `nu`, a
    numpy tree shaped like the parameters."""
    return {"count": np.asarray(count, np.int32),
            "hyperparams": {"alpha": np.asarray(0.99, np.float32),
                            "eps": np.asarray(1e-8, np.float32),
                            "learning_rate": np.asarray(lr, np.float32)},
            "hyperparams_states": {},
            "inner_state": {"nu": jax_layout(nu)}}
