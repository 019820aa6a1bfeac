"""Flax msgpack variables files, read and written without `msgpack` or
flax.

The JAX package's `scripts/train_eval_synth.py --save-variables` writes
`{"params", "batch_stats"}` with `flax.serialization.msgpack_serialize`:
msgpack maps of str keys, sorted (flax copies the tree through
`jax.tree_util`, which sorts dict keys), and array leaves as msgpack
extension types:

  * type 1, an ndarray: the msgpack of `(shape, dtype name, C-order
    bytes)`, with `bfloat16` named as such;
  * type 3, a numpy scalar: the same encoding of its 0-d array.

This module carries its own encoder and decoder of that subset of msgpack
(nil, bool, int, float, str, bin, array, map, ext), so that the port
reads and writes those files where `msgpack` is not installed. The bytes
it writes are flax's, byte for byte: each value in its shortest msgpack
form, str keys as UTF-8 str (never bin), Python floats as float 64.
Arrays decode to numpy arrays that own their memory, except `bfloat16`,
which numpy lacks and which decodes to a `torch.bfloat16` tensor; the
encoder takes numpy arrays and scalars and torch tensors. Arrays above
flax's 1 GiB chunking limit are refused both ways.
"""

from __future__ import annotations

import os
import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_NPSCALAR = 1, 3
MAX_CHUNK_SIZE = 2 ** 30            # flax splits larger arrays into chunks


# ---------------------------------------------------------------- encoder

def _int(n: int) -> bytes:
    if 0 <= n < 0x80:
        return bytes((n,))
    if -0x20 <= n < 0:
        return struct.pack("b", n)
    if 0 <= n <= 0xFF:
        return b"\xcc" + struct.pack(">B", n)
    if -0x80 <= n < 0:
        return b"\xd0" + struct.pack(">b", n)
    if 0 <= n <= 0xFFFF:
        return b"\xcd" + struct.pack(">H", n)
    if -0x8000 <= n < 0:
        return b"\xd1" + struct.pack(">h", n)
    if 0 <= n <= 0xFFFFFFFF:
        return b"\xce" + struct.pack(">I", n)
    if -0x80000000 <= n < 0:
        return b"\xd2" + struct.pack(">i", n)
    if 0 <= n <= 0xFFFFFFFFFFFFFFFF:
        return b"\xcf" + struct.pack(">Q", n)
    if -0x8000000000000000 <= n < 0:
        return b"\xd3" + struct.pack(">q", n)
    raise OverflowError(f"integer {n} does not fit msgpack's 64 bits")


def _header(n: int, fix: int, fix_max: int, codes) -> bytes:
    """A length header: the fix form below `fix_max`, else 8-, 16- or
    32-bit lengths (`codes` without an 8-bit form holds None there)."""
    if n < fix_max:
        return bytes((fix | n,))
    for code, fmt, limit in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= limit:
            return bytes((code,)) + struct.pack(fmt, n)
    raise ValueError(f"length {n} exceeds msgpack's 32 bits")


def _bin(b: bytes) -> bytes:
    return _header(len(b), 0, 0, (0xC4, 0xC5, 0xC6)) + b


def _ext(code: int, data: bytes) -> bytes:
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if len(data) in fixed:
        return bytes((fixed[len(data)], code)) + data
    return _header(len(data), 0, 0, (0xC7, 0xC8, 0xC9)) + bytes((code,)) + data


def _array_payload(shape, dtype_name: str, data: bytes) -> bytes:
    return (_header(3, 0x90, 16, (None, 0xDC, 0xDD))
            + _pack(tuple(int(d) for d in shape)) + _pack(dtype_name) + _bin(data))


def _ndarray(x) -> tuple[tuple, str, bytes]:
    """(shape, dtype name, C-order bytes) of a numpy array or a tensor."""
    if torch.is_tensor(x):
        t = x.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return tuple(t.shape), "bfloat16", t.view(torch.int16).numpy().tobytes()
        x = t.numpy()
    x = np.asarray(x)
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes are not serializable")
    if x.nbytes > MAX_CHUNK_SIZE:
        raise ValueError(f"an array of {x.nbytes} bytes is above flax's chunking limit")
    return x.shape, x.dtype.name, x.tobytes("C")


def _pack(obj) -> bytes:
    if obj is None:
        return b"\xc0"
    if obj is True or obj is False:
        return b"\xc3" if obj else b"\xc2"
    if type(obj) is int:
        return _int(obj)
    if type(obj) is float:
        return b"\xcb" + struct.pack(">d", obj)
    if type(obj) is str:
        b = obj.encode("utf-8")
        return _header(len(b), 0xA0, 32, (0xD9, 0xDA, 0xDB)) + b
    if type(obj) in (bytes, bytearray):
        return _bin(bytes(obj))
    if type(obj) in (list, tuple):
        return (_header(len(obj), 0x90, 16, (None, 0xDC, 0xDD))
                + b"".join(_pack(v) for v in obj))
    if isinstance(obj, dict):
        return (_header(len(obj), 0x80, 16, (None, 0xDE, 0xDF))
                + b"".join(_pack(k) + _pack(v) for k, v in obj.items()))
    if isinstance(obj, np.generic):
        return _ext(EXT_NPSCALAR, _array_payload(*_ndarray(np.asarray(obj))))
    if isinstance(obj, np.ndarray) or torch.is_tensor(obj):
        return _ext(EXT_NDARRAY, _array_payload(*_ndarray(obj)))
    raise TypeError(f"cannot serialize {type(obj).__name__}")


def _sorted_tree(tree):
    """The tree with every dict's keys sorted, as `jax.tree_util` rebuilds
    it before flax packs it."""
    if isinstance(tree, dict):
        return {k: _sorted_tree(tree[k]) for k in sorted(tree)}
    return tree


def packb(tree) -> bytes:
    """`flax.serialization.msgpack_serialize(tree)`'s bytes for a tree of
    dicts with str keys and array leaves."""
    return _pack(_sorted_tree(tree))


# ---------------------------------------------------------------- decoder

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self):
        b = self.unpack(">B")
        if b < 0x80:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        lengths = {0xC4: ">B", 0xC5: ">H", 0xC6: ">I"}
        if b in lengths:
            return bytes(self.take(self.unpack(lengths[b])))
        ext = {0xC7: ">B", 0xC8: ">H", 0xC9: ">I"}
        if b in ext:
            n = self.unpack(ext[b])
            return self.ext(self.unpack(">b"), n)
        if 0xD4 <= b <= 0xD8:
            return self.ext(self.unpack(">b"), 1 << (b - 0xD4))
        numbers = {0xCA: ">f", 0xCB: ">d", 0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
                   0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q"}
        if b in numbers:
            return self.unpack(numbers[b])
        strs = {0xD9: ">B", 0xDA: ">H", 0xDB: ">I"}
        if b in strs:
            return str(self.take(self.unpack(strs[b])), "utf-8")
        if b in (0xDC, 0xDD):
            return self.array(self.unpack(">H" if b == 0xDC else ">I"))
        if b in (0xDE, 0xDF):
            return self.map(self.unpack(">H" if b == 0xDE else ">I"))
        raise ValueError(f"msgpack type byte 0x{b:02x} is not supported")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def ext(self, code: int, n: int):
        data = bytes(self.take(n))
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack extension type {code} is not supported")
        shape, name, buf = _Reader(data).value()
        name = name.decode() if isinstance(name, bytes) else name
        if name == "bfloat16":
            arr = torch.frombuffer(bytearray(buf), dtype=torch.bfloat16).reshape(shape)
            return arr if code == EXT_NDARRAY else arr.reshape(())
        arr = np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape).copy()
        return arr if code == EXT_NDARRAY else arr[()]


def unpackb(data: bytes):
    """`flax.serialization.msgpack_restore(data)` for the subset above."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError(f"{len(reader.data) - reader.pos} bytes after the msgpack value")
    _refuse_chunked(tree)
    return tree


def _refuse_chunked(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            raise ValueError("an array above flax's chunking limit: not supported")
        for v in tree.values():
            _refuse_chunked(v)


# ---------------------------------------------------------------- files

def write_variables(path, variables) -> None:
    """Write `variables` (`{"params", "batch_stats"}` as nested dicts of
    arrays, the JAX package's layout: `convert.to_jax_variables`) as a
    flax msgpack file."""
    data = packb(variables)
    tmp = os.fspath(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)


def read_variables(path):
    """A flax msgpack file → its tree (nested dicts of numpy arrays)."""
    with open(path, "rb") as f:
        return unpackb(f.read())
