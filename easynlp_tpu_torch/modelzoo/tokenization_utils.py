"""Tokenizer base for the PyTorch port (its own copy of
easynlp_tpu/modelzoo/tokenization_utils.py): the slow-tokenizer surface the
apps use (__call__ with truncation and padding, convert_tokens_to_ids,
decode, save_pretrained), BERT's basic and WordPiece tokenizers, in pure
Python. Encoding pads to max_length by default and batches come back as
numpy int32 arrays, as in the JAX package, so both give the same features.
"""

import json
import os
import unicodedata

import numpy as np

from easynlp_tpu_torch.utils.io_utils import io

VOCAB_NAME = "vocab.txt"
SPECIAL_TOKENS_MAP_NAME = "special_tokens_map.json"
TOKENIZER_CONFIG_NAME = "tokenizer_config.json"


def load_vocab(vocab_file):
    vocab = {}
    with io.open(vocab_file) as f:
        for idx, line in enumerate(f):
            token = line.rstrip("\n")
            if token in vocab:
                from easynlp_tpu_torch.utils.logger import logger
                logger.warning(
                    "duplicate vocab token %r at index %d (first at %d); "
                    "ids will not round-trip through save_vocabulary",
                    token, idx, vocab[token])
            vocab[token] = idx
    return vocab


def whitespace_tokenize(text):
    text = text.strip()
    return text.split() if text else []


class PreTrainedTokenizer:
    """Minimal common surface. Subclasses implement _tokenize and the
    special-token layout (build_inputs_with_special_tokens)."""

    padding_side = "right"

    def __init__(self, unk_token="[UNK]", sep_token="[SEP]", pad_token="[PAD]",
                 cls_token="[CLS]", mask_token="[MASK]", bos_token=None,
                 eos_token=None, **kwargs):
        self.unk_token = unk_token
        self.sep_token = sep_token
        self.pad_token = pad_token
        self.cls_token = cls_token
        self.mask_token = mask_token
        self.bos_token = bos_token
        self.eos_token = eos_token
        self.init_kwargs = dict(kwargs)

    # subclass API ------------------------------------------------------------
    def _tokenize(self, text):
        raise NotImplementedError

    def _convert_token_to_id(self, token):
        raise NotImplementedError

    def _convert_id_to_token(self, index):
        raise NotImplementedError

    @property
    def vocab_size(self):
        raise NotImplementedError

    # common ------------------------------------------------------------------
    def tokenize(self, text):
        return self._tokenize(text)

    def convert_tokens_to_ids(self, tokens):
        if isinstance(tokens, str):
            return self._convert_token_to_id(tokens)
        return [self._convert_token_to_id(t) for t in tokens]

    def convert_ids_to_tokens(self, ids, skip_special_tokens=False):
        if isinstance(ids, (int, np.integer)):
            return self._convert_id_to_token(int(ids))
        toks = [self._convert_id_to_token(int(i)) for i in ids]
        if skip_special_tokens:
            toks = [t for t in toks if t not in self.all_special_tokens]
        return toks

    @property
    def all_special_tokens(self):
        return [t for t in (self.unk_token, self.sep_token, self.pad_token,
                            self.cls_token, self.mask_token, self.bos_token,
                            self.eos_token) if t]

    @property
    def all_special_ids(self):
        return [self._convert_token_to_id(t) for t in self.all_special_tokens]

    @property
    def pad_token_id(self):
        return self._convert_token_to_id(self.pad_token) if self.pad_token else 0

    @property
    def unk_token_id(self):
        return self._convert_token_to_id(self.unk_token)

    @property
    def cls_token_id(self):
        return self._convert_token_to_id(self.cls_token) if self.cls_token else None

    @property
    def sep_token_id(self):
        return self._convert_token_to_id(self.sep_token) if self.sep_token else None

    @property
    def mask_token_id(self):
        return self._convert_token_to_id(self.mask_token) if self.mask_token else None

    @property
    def bos_token_id(self):
        return self._convert_token_to_id(self.bos_token) if self.bos_token else None

    @property
    def eos_token_id(self):
        return self._convert_token_to_id(self.eos_token) if self.eos_token else None

    # pair layout: subclass overrides (BERT: [CLS] A [SEP] B [SEP])
    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        if ids_b is None:
            return list(ids_a)
        return list(ids_a) + list(ids_b)

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        if ids_b is None:
            return [0] * len(self.build_inputs_with_special_tokens(ids_a))
        return [0] * (len(ids_a) + 2) + [1] * (len(ids_b) + 1)

    def num_special_tokens_to_add(self, pair=False):
        return len(self.build_inputs_with_special_tokens(
            [], [] if pair else None))

    def truncate_sequences(self, ids_a, ids_b, max_tokens):
        """Longest-first truncation (HF default used by the reference apps)."""
        if ids_b is None:
            return ids_a[:max_tokens], None
        while len(ids_a) + len(ids_b) > max_tokens:
            if len(ids_a) >= len(ids_b):
                ids_a = ids_a[:-1]
            else:
                ids_b = ids_b[:-1]
        return ids_a, ids_b

    def _encode_core(self, text):
        """Text → ids without special tokens; subclasses may route this to a
        native fast path."""
        return self.convert_tokens_to_ids(self.tokenize(text))

    def encode_plus(self, text, text_pair=None, max_length=128, padding="max_length",
                    truncation=True, add_special_tokens=True):
        ids_a = self._encode_core(text)
        ids_b = (self._encode_core(text_pair)
                 if text_pair is not None else None)
        if truncation:
            budget = max_length - (self.num_special_tokens_to_add(
                pair=ids_b is not None) if add_special_tokens else 0)
            ids_a, ids_b = self.truncate_sequences(ids_a, ids_b, budget)
        if add_special_tokens:
            input_ids = self.build_inputs_with_special_tokens(ids_a, ids_b)
            token_type_ids = self.create_token_type_ids_from_sequences(ids_a, ids_b)
        else:
            input_ids = list(ids_a) + (list(ids_b) if ids_b else [])
            token_type_ids = [0] * len(input_ids)
        attention_mask = [1] * len(input_ids)
        if padding == "max_length":
            pad_n = max_length - len(input_ids)
            input_ids += [self.pad_token_id] * pad_n
            token_type_ids += [0] * pad_n
            attention_mask += [0] * pad_n
        return {"input_ids": input_ids,
                "token_type_ids": token_type_ids,
                "attention_mask": attention_mask}

    def __call__(self, text, text_pair=None, max_length=128, padding="max_length",
                 truncation=True, add_special_tokens=True, return_numpy=True):
        """Encode a string or a batch of strings into fixed-shape arrays."""
        if isinstance(text, str):
            enc = self.encode_plus(text, text_pair, max_length, padding,
                                   truncation, add_special_tokens)
            if return_numpy:
                return {k: np.asarray(v, np.int32) for k, v in enc.items()}
            return enc
        pairs = text_pair if text_pair is not None else [None] * len(text)
        encs = [self.encode_plus(t, p, max_length, padding, truncation,
                                 add_special_tokens)
                for t, p in zip(text, pairs)]
        batch = {k: [e[k] for e in encs] for k in encs[0]}
        if return_numpy:
            return {k: np.asarray(v, np.int32) for k, v in batch.items()}
        return batch

    def decode(self, ids, skip_special_tokens=True):
        toks = self.convert_ids_to_tokens(ids, skip_special_tokens=skip_special_tokens)
        return self.convert_tokens_to_string(toks)

    def convert_tokens_to_string(self, tokens):
        return " ".join(tokens)

    # persistence --------------------------------------------------------------
    def save_pretrained(self, save_directory):
        io.makedirs(save_directory)
        self.save_vocabulary(save_directory)
        smap = {k: getattr(self, k) for k in
                ("unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token", "bos_token", "eos_token") if getattr(self, k)}
        with io.open(os.path.join(save_directory, SPECIAL_TOKENS_MAP_NAME), "w") as f:
            json.dump(smap, f, ensure_ascii=False, indent=2)
        with io.open(os.path.join(save_directory, TOKENIZER_CONFIG_NAME), "w") as f:
            json.dump({"tokenizer_class": type(self).__name__,
                       **self.init_kwargs}, f, ensure_ascii=False, indent=2)

    def save_vocabulary(self, save_directory):
        raise NotImplementedError


class BasicTokenizer:
    """Pre-tokenisation: unicode cleaning, CJK char isolation, optional
    lowercasing + accent stripping, punctuation splitting. Semantics match the
    reference's vendored BERT basic tokenizer (modelzoo/models/bert/
    tokenization_bert.py) so CLUE tokenisation is byte-identical."""

    def __init__(self, do_lower_case=True, never_split=None,
                 tokenize_chinese_chars=True, strip_accents=None):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split or [])
        self.tokenize_chinese_chars = tokenize_chinese_chars
        self.strip_accents = strip_accents

    def tokenize(self, text, never_split=None):
        never_split = self.never_split | set(never_split or [])
        text = self._clean_text(text)
        if self.tokenize_chinese_chars:
            text = self._pad_cjk_chars(text)
        out = []
        for token in whitespace_tokenize(text):
            if token in never_split:
                out.append(token)
                continue
            if self.do_lower_case:
                token = token.lower()
                if self.strip_accents is not False:
                    token = self._strip_accents(token)
            elif self.strip_accents:
                token = self._strip_accents(token)
            out.extend(self._split_on_punc(token))
        return whitespace_tokenize(" ".join(out))

    @staticmethod
    def _clean_text(text):
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    @staticmethod
    def _strip_accents(text):
        text = unicodedata.normalize("NFD", text)
        return "".join(ch for ch in text if unicodedata.category(ch) != "Mn")

    @staticmethod
    def _split_on_punc(text):
        out, current = [], []
        for ch in text:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
        return out

    @staticmethod
    def _pad_cjk_chars(text):
        out = []
        for ch in text:
            if _is_cjk_char(ord(ch)):
                out.append(" ")
                out.append(ch)
                out.append(" ")
            else:
                out.append(ch)
        return "".join(out)


class WordpieceTokenizer:
    """Greedy longest-match-first subword matching."""

    def __init__(self, vocab, unk_token="[UNK]", max_input_chars_per_word=100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_input_chars_per_word = max_input_chars_per_word

    def tokenize(self, text):
        out = []
        for token in whitespace_tokenize(text):
            chars = list(token)
            if len(chars) > self.max_input_chars_per_word:
                out.append(self.unk_token)
                continue
            is_bad, start, sub_tokens = False, 0, []
            while start < len(chars):
                end, cur = len(chars), None
                while start < end:
                    substr = "".join(chars[start:end])
                    if start > 0:
                        substr = "##" + substr
                    if substr in self.vocab:
                        cur = substr
                        break
                    end -= 1
                if cur is None:
                    is_bad = True
                    break
                sub_tokens.append(cur)
                start = end
            out.extend([self.unk_token] if is_bad else sub_tokens)
        return out


# --- character classes (match BERT reference semantics) ----------------------

def _is_whitespace(ch):
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch):
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch):
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk_char(cp):
    return ((0x4E00 <= cp <= 0x9FFF) or (0x3400 <= cp <= 0x4DBF)
            or (0x20000 <= cp <= 0x2A6DF) or (0x2A700 <= cp <= 0x2B73F)
            or (0x2B740 <= cp <= 0x2B81F) or (0x2B820 <= cp <= 0x2CEAF)
            or (0xF900 <= cp <= 0xFAFF) or (0x2F800 <= cp <= 0x2FA1F))
