"""ctypes wrapper for the native SentencePiece unigram encoder
(native/sp_unigram.cpp), the port's own copy of
easynlp_tpu/data/fast_sp.py over a library that data/native_lib.py builds
into build/native/. The fast path of SentencePieceModel._encode_unigram:
the normalisation (charsmap or NFKC) stays in Python, the Viterbi runs
native, with the same ids. Where the library is missing the model keeps its
Python path."""

import ctypes
import os

import numpy as np

from easynlp_tpu_torch.data import native_lib

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is None:
        lib = native_lib.load("sp_unigram")
        if lib:
            lib.spu_create.restype = ctypes.c_void_p
            lib.spu_create.argtypes = [
                ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
                ctypes.POINTER(ctypes.c_double), ctypes.c_double,
                ctypes.c_int32, ctypes.POINTER(ctypes.c_int32),
                ctypes.c_int32]
            lib.spu_destroy.argtypes = [ctypes.c_void_p]
            lib.spu_encode.restype = ctypes.c_int64
            lib.spu_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                       ctypes.c_int64,
                                       ctypes.POINTER(ctypes.c_int32),
                                       ctypes.c_int64]
        _LIB = lib or False
    return _LIB


class FastUnigram:
    """Native engine built from a SentencePieceModel's tables. create()
    returns None where it is unavailable (the caller keeps the Python
    path)."""

    def __init__(self, handle, lib):
        self._handle = handle
        self._lib = lib

    @classmethod
    def create(cls, model):
        if os.environ.get("EASYNLP_FAST_TOKENIZER", "1") != "1":
            return None
        lib = _load_lib()
        if not lib:
            return None
        from easynlp_tpu_torch.modelzoo.tokenization_sentencepiece import (
            NORMAL, UNK_PENALTY, USER_DEFINED)
        pieces = model.pieces
        blob_parts = []
        for i, (p, _s, t) in enumerate(pieces):
            keep = model.piece_to_id.get(p) == i and t in (NORMAL,
                                                          USER_DEFINED)
            if keep and "\n" in p:
                return None  # cannot be written into the newline blob
            blob_parts.append(p.encode("utf-8") if keep else b"")
        blob = b"\n".join(blob_parts)
        scores = np.ascontiguousarray([s for _, s, _ in pieces],
                                      dtype=np.float64)
        byte_ids = np.full((256,), model.unk_id, np.int32)
        has_bytes = model._byte_ids is not None
        if has_bytes:
            for b, i in model._byte_ids.items():
                byte_ids[b] = i
        handle = lib.spu_create(
            blob, len(blob), len(pieces),
            scores.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
            ctypes.c_double(model._min_score - UNK_PENALTY), model.unk_id,
            byte_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
            1 if has_bytes else 0)
        if not handle:
            return None
        return cls(handle, lib)

    def encode(self, normalized_text):
        """Ids of already-normalised text, or None where the native
        encoder refuses it."""
        data = normalized_text.encode("utf-8")
        cap = max(16, 2 * len(data) + 8)
        out = (ctypes.c_int32 * cap)()
        n = self._lib.spu_encode(self._handle, data, len(data), out, cap)
        if n < 0:
            return None
        return list(out[:n])

    def __del__(self):
        if getattr(self, "_handle", None) and self._lib:
            self._lib.spu_destroy(self._handle)
            self._handle = None
