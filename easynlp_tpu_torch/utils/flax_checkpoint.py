"""Reader of the JAX package's `flax_params.msgpack` checkpoints.

`flax.serialization.to_bytes` writes a parameter tree as MessagePack
(https://github.com/msgpack/msgpack/blob/master/spec.md): nested maps with
string keys, numpy arrays as ext type 1 (the payload a MessagePack array of
shape, dtype name and the C-order bytes), numpy scalars as ext type 3 (the
same payload), complex numbers as ext type 2, and an array larger than
2^30 bytes split into a map {'__msgpack_chunked_array__': True, 'shape':
{'0': ...}, 'chunks': {'0': flat chunk, ...}}. This module decodes that
subset in plain Python and numpy (neither `msgpack` nor `flax` is
imported), so a JAX checkpoint loads where JAX is not installed.
"""

import struct

import numpy as np

from easynlp_tpu_torch.utils.io_utils import io

_NDARRAY, _COMPLEX, _NPSCALAR = 1, 2, 3
_CHUNKED = "__msgpack_chunked_array__"
# fixed-width MessagePack types: first byte -> (struct format, size)
_FIXED = {0xca: (">f", 4), 0xcb: (">d", 8),
          0xcc: (">B", 1), 0xcd: (">H", 2), 0xce: (">I", 4), 0xcf: (">Q", 8),
          0xd0: (">b", 1), 0xd1: (">h", 2), 0xd2: (">i", 4), 0xd3: (">q", 8)}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}


class _Reader:
    def __init__(self, data):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n):
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data at byte %d" % self.pos)
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n):
        return int.from_bytes(self.take(n), "big")

    def value(self):
        b = self.uint(1)
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return self.str(b & 0x1f)
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):                      # bin 8/16/32
            return bytes(self.take(self.uint(1 << (b - 0xc4))))
        if b in (0xc7, 0xc8, 0xc9):                      # ext 8/16/32
            n = self.uint(1 << (b - 0xc7))
            return self.ext(self.uint(1), n)
        if b in _FIXED:
            fmt, n = _FIXED[b]
            return struct.unpack(fmt, self.take(n))[0]
        if b in _FIXEXT:
            code = self.uint(1)
            return self.ext(code, _FIXEXT[b])
        if b in (0xd9, 0xda, 0xdb):                      # str 8/16/32
            return self.str(self.uint(1 << (b - 0xd9)))
        if b in (0xdc, 0xdd):                            # array 16/32
            return self.array(self.uint(2 if b == 0xdc else 4))
        if b in (0xde, 0xdf):                            # map 16/32
            return self.map(self.uint(2 if b == 0xde else 4))
        raise ValueError("unsupported msgpack type byte 0x%02x at byte %d"
                         % (b, self.pos - 1))

    def str(self, n):
        return bytes(self.take(n)).decode("utf-8")

    def array(self, n):
        return [self.value() for _ in range(n)]

    def map(self, n):
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def ext(self, code, n):
        payload = bytes(self.take(n))
        if code in (_NDARRAY, _NPSCALAR):
            shape, dtype, buffer = _Reader(payload).value()
            if isinstance(dtype, bytes):
                dtype = dtype.decode("ascii")
            if dtype == "bfloat16":
                # the top half of an f32: widen exactly
                bits = np.frombuffer(buffer, np.uint16).astype(np.uint32)
                arr = (bits << 16).view(np.float32)
            else:
                arr = np.frombuffer(buffer, np.dtype(dtype)).copy()
            arr = arr.reshape(shape)
            return arr[()] if code == _NPSCALAR else arr
        if code == _COMPLEX:
            real, imag = _Reader(payload).value()
            return complex(real, imag)
        raise ValueError("unsupported msgpack ext type %d" % code)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if tree.get(_CHUNKED):
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data):
    """The tree `flax.serialization.to_bytes` encoded in data: dicts, numpy
    arrays (bfloat16 widened to float32) and Python scalars, chunked arrays
    joined."""
    reader = _Reader(data)
    tree = reader.value()
    if reader.pos != len(reader.data):
        raise ValueError("%d bytes after the msgpack value"
                         % (len(reader.data) - reader.pos))
    return _unchunk(tree)


def load_flax_params(path):
    """The parameter tree of a `flax_params.msgpack` file."""
    with io.open(path, "rb") as f:
        return msgpack_restore(f.read())
