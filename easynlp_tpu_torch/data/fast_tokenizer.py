"""ctypes wrapper for the native WordPiece tokenizer
(native/wordpiece_tokenizer.cpp), the port's own copy of
easynlp_tpu/data/fast_tokenizer.py over a library that data/native_lib.py
builds. The fast path for BertTokenizer's tokenize + convert; where the
library is missing, the tokenizer takes its pure-Python path (same ids)."""

import ctypes
import unicodedata

from easynlp_tpu_torch.data import native_lib

_LIB = None


def _load_lib():
    global _LIB
    if _LIB is None:
        lib = native_lib.load("wordpiece_tokenizer")
        if lib:
            lib.wp_create.restype = ctypes.c_void_p
            lib.wp_create.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_int, ctypes.c_char_p]
            lib.wp_destroy.argtypes = [ctypes.c_void_p]
            lib.wp_encode.restype = ctypes.c_int64
            lib.wp_encode.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int32),
                                      ctypes.c_int64]
            lib.wp_set_classes.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                           ctypes.c_int64]
        _LIB = lib or False
    return _LIB


_CLASS_TABLE = None
_CLASS_TABLE_LIMIT = 0x30000  # planes 0-2 cover every practical Zs/Cc/Cf/P*


def _char_class_table():
    """Per-codepoint class flags (1 whitespace, 2 control, 4 punctuation)
    from unicodedata, so the native pipeline splits exactly like the
    pure-Python one."""
    global _CLASS_TABLE
    if _CLASS_TABLE is not None:
        return _CLASS_TABLE
    table = bytearray(_CLASS_TABLE_LIMIT)
    for cp in range(_CLASS_TABLE_LIMIT):
        ch = chr(cp)
        cat = unicodedata.category(ch)
        flags = 0
        if ch in " \t\n\r" or cat == "Zs":
            flags |= 1
        elif cat in ("Cc", "Cf"):
            flags |= 2
        if (33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96
                or 123 <= cp <= 126 or cat.startswith("P")):
            flags |= 4
        table[cp] = flags
    _CLASS_TABLE = bytes(table)
    return _CLASS_TABLE


def available():
    return bool(_load_lib())


class FastWordPiece:
    """Native tokenizer over a vocab.txt; encode(text) -> list[int]."""

    def __init__(self, vocab_file, do_lower_case=True, unk_token="[UNK]",
                 strip_accents=None, max_ids=512):
        lib = _load_lib()
        if not lib:
            raise RuntimeError("the native WordPiece tokenizer is unavailable")
        self._lib = lib
        with open(vocab_file, "rb") as f:
            data = f.read()
        self._handle = lib.wp_create(data, len(data), int(do_lower_case),
                                     unk_token.encode())
        tbl = _char_class_table()
        lib.wp_set_classes(self._handle, tbl, len(tbl))
        self.do_lower_case = do_lower_case
        self.strip_accents = strip_accents
        self.max_ids = max_ids
        self._buf = (ctypes.c_int32 * max_ids)()

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.wp_destroy(self._handle)

    def _normalize(self, text):
        # lowercasing and accent stripping use unicode tables: applied here
        # (only for non-ASCII text); the native side lowercases ASCII only
        if not text.isascii():
            if self.do_lower_case:
                text = text.lower()
            if (self.do_lower_case and self.strip_accents is not False) \
                    or self.strip_accents:
                text = unicodedata.normalize("NFD", text)
                text = "".join(ch for ch in text
                               if unicodedata.category(ch) != "Mn")
        return text

    def encode(self, text):
        data = self._normalize(text).encode("utf-8")
        n = self._lib.wp_encode(self._handle, data, len(data), self._buf,
                                self.max_ids)
        return list(self._buf[:n])
