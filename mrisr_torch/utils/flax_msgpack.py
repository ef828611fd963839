"""Read Flax msgpack checkpoints without flax or msgpack.

``read_msgpack`` returns what ``flax.serialization.msgpack_restore`` returns
for a checkpoint written by ``msgpack_serialize``: a nested dict of numpy
arrays and Python scalars.  It decodes the subset of msgpack that Flax writes
(maps, arrays, str, bin, ints, floats, bool, nil, ext) and Flax's three ext
types (``flax/serialization.py``, ``_MsgpackExtType``):

* 1 ``ndarray``: a msgpack ``(shape, dtype name, C-order bytes)`` triple;
* 2 ``native_complex``: a msgpack ``(real, imag)`` pair, a Python complex;
* 3 ``npscalar``: an ndarray triple of shape ``()``, a numpy scalar;

and joins Flax's chunked arrays (``{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}``) back into one array.  A ``bfloat16``
array (numpy has no such dtype) is widened exactly to float32.
"""
from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

EXT_NDARRAY, EXT_NATIVE_COMPLEX, EXT_NPSCALAR = 1, 2, 3
CHUNKED = "__msgpack_chunked_array__"

# Fixed-width formats: first byte -> (struct format, size).
_FIXED = {
    0xCA: (">f", 4), 0xCB: (">d", 8),
    0xCC: (">B", 1), 0xCD: (">H", 2), 0xCE: (">I", 4), 0xCF: (">Q", 8),
    0xD0: (">b", 1), 0xD1: (">h", 2), 0xD2: (">i", 4), 0xD3: (">q", 8),
}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, buf: memoryview, raw: bool):
        self.buf, self.pos, self.raw = buf, 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        out = self.buf[self.pos : self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str, size: int):
        return struct.unpack(fmt, self.take(size))[0]

    def length(self, size: int) -> int:
        return self.unpack(_LEN[size], size)

    def string(self, n: int):
        data = bytes(self.take(n))
        return data if self.raw else data.decode("utf-8")

    def ext(self, n: int):
        code = self.unpack(">b", 1)
        return _decode_ext(code, self.take(n))

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.string(b & 0x1F)
        if b in _FIXED:
            return self.unpack(*_FIXED[b])
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if 0xC4 <= b <= 0xC6:  # bin 8/16/32
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if 0xC7 <= b <= 0xC9:  # ext 8/16/32
            return self.ext(self.length(1 << (b - 0xC7)))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            return self.ext(1 << (b - 0xD4))
        if 0xD9 <= b <= 0xDB:  # str 8/16/32
            return self.string(self.length(1 << (b - 0xD9)))
        if b in (0xDC, 0xDD):  # array 16/32
            return self.array(self.length(2 if b == 0xDC else 4))
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.length(2 if b == 0xDE else 4))
        raise ValueError(f"byte 0x{b:02x} at offset {self.pos - 1} starts no msgpack value")

    def array(self, n: int) -> list:
        return [self.value() for _ in range(n)]

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out


def _unpackb(data, raw: bool = False):
    reader = _Reader(memoryview(data), raw)
    out = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} bytes after the msgpack value")
    return out


def _ndarray(payload: memoryview) -> np.ndarray:
    """Flax's ndarray triple: shape, dtype name and the C-order bytes."""
    shape, name, data = _unpackb(payload, raw=True)
    if name == b"bfloat16":  # the high half of a float32: widen exactly
        bits = np.frombuffer(data, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name.decode())).reshape(shape)


def _decode_ext(code: int, payload: memoryview):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NATIVE_COMPLEX:
        real, imag = _unpackb(payload)
        return complex(real, imag)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack ext type {code} is not one that Flax writes")


def _unchunk(tree):
    """Join Flax's chunked arrays, at any depth of the tree."""
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def read_msgpack(source: str | Path | bytes) -> dict:
    """The tree of a Flax msgpack checkpoint (a path, or its bytes)."""
    data = source if isinstance(source, (bytes, bytearray, memoryview)) else Path(source).read_bytes()
    return _unchunk(_unpackb(data))
