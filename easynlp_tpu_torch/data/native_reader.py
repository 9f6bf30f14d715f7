"""ctypes wrapper for the native mmap TSV reader (native/tsv_reader.cpp), the
port's own copy of easynlp_tpu/data/native_reader.py over a library that
data/native_lib.py builds."""

import ctypes
import threading

import numpy as np

from easynlp_tpu_torch.data import native_lib

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is None:
        lib = native_lib.load("tsv_reader")
        if lib:
            lib.tsv_open.restype = ctypes.c_void_p
            lib.tsv_open.argtypes = [ctypes.c_char_p]
            lib.tsv_num_rows.restype = ctypes.c_int64
            lib.tsv_num_rows.argtypes = [ctypes.c_void_p]
            lib.tsv_row.restype = ctypes.c_int64
            lib.tsv_row.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                                    ctypes.c_char_p, ctypes.c_int64]
            lib.tsv_close.argtypes = [ctypes.c_void_p]
            lib.tsv_nonblank.restype = ctypes.c_int64
            lib.tsv_nonblank.argtypes = [ctypes.c_void_p,
                                         ctypes.POINTER(ctypes.c_int64),
                                         ctypes.c_int64]
        _LIB = lib or False
    return _LIB


def available():
    return bool(_load_lib())


class NativeTSVReader:
    """mmap-backed random-access row reader."""

    _handle = None

    def __init__(self, path, max_row_bytes=1 << 20):
        lib = _load_lib()
        if not lib:
            raise RuntimeError("the native TSV reader is unavailable")
        self._lib = lib
        self._handle = lib.tsv_open(str(path).encode())
        if not self._handle:
            raise IOError("cannot open %s" % path)
        # per-thread row buffer: __getitem__ is called from the
        # --data_workers featurisation thread pool
        self._tls = threading.local()
        self._max = max_row_bytes

    @property
    def _buf(self):
        buf = getattr(self._tls, "buf", None)
        if buf is None:
            buf = self._tls.buf = ctypes.create_string_buffer(self._max)
        return buf

    def __len__(self):
        return self._lib.tsv_num_rows(self._handle)

    def __getitem__(self, idx):
        buf = self._buf
        n = self._lib.tsv_row(self._handle, int(idx), buf, self._max)
        if n < 0:
            raise IndexError(idx)
        return buf.raw[:n].decode("utf-8", errors="replace")

    def nonblank_indices(self):
        """Indices of rows with any non-whitespace byte (the Python
        reader's `if line.strip()` filter)."""
        n = len(self)
        out = np.empty(max(n, 1), np.int64)
        cnt = self._lib.tsv_nonblank(
            self._handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n)
        return out[:cnt].copy()

    def close(self):
        if self._handle:
            self._lib.tsv_close(self._handle)
            self._handle = None

    def __del__(self):
        self.close()


class NativeLazyRows:
    """List-like lazy view over the non-blank rows of a TSV (len, int index,
    slices as index views), served by the native reader."""

    def __init__(self, path=None, _reader=None, _index=None):
        if _reader is not None:
            self._reader = _reader
            self._index = _index
            return
        self._reader = NativeTSVReader(path)
        self._index = self._reader.nonblank_indices()

    def __len__(self):
        return len(self._index)

    def __getitem__(self, key):
        if isinstance(key, slice):
            return NativeLazyRows(_reader=self._reader,
                                  _index=self._index[key])
        return self._reader[int(self._index[int(key)])]

    def __iter__(self):
        for i in range(len(self)):
            yield self[i]
