"""SentencePiece tokenization (unigram and BPE) for the PyTorch port, with
no dependency on the `sentencepiece` package.

The port's own copy of easynlp_tpu/modelzoo/tokenization_sentencepiece.py,
giving the same ids and decodes:

- a wire-format reader of the `spiece.model` protobuf (ModelProto: pieces
  = 1, trainer_spec = 2, normalizer_spec = 3);
- the normaliser: the precompiled charsmap (a Darts double-array trie over
  UTF-8 prefixes into a replacement pool) where the model has one, NFKC
  otherwise, then remove-extra-whitespaces, add-dummy-prefix and
  escape-whitespaces to U+2581;
- unigram inference: Viterbi over a piece trie with unknown nodes at
  min_score - 10, consecutive unknowns fused into one (sentencepiece's
  semantics) and byte fallback; the Viterbi runs in
  native/sp_unigram.cpp where data/fast_sp.py can build it, in Python
  otherwise;
- BPE inference: adjacent merges by score, then position;
- SentencePieceTokenizer, T5Tokenizer (100 `<extra_id_*>` sentinels after
  the pieces) and MT5Tokenizer on the port's PreTrainedTokenizer.
"""

import json
import os
import struct
import unicodedata

from easynlp_tpu_torch.modelzoo.tokenization_utils import (
    TOKENIZER_CONFIG_NAME,
    PreTrainedTokenizer,
)
from easynlp_tpu_torch.utils.io_utils import io

WS_PIECE = "▁"  # ▁
UNK_PENALTY = 10.0

# piece types (sentencepiece_model.proto SentencePiece.Type)
NORMAL = 1
UNKNOWN = 2
CONTROL = 3
USER_DEFINED = 4
UNUSED = 5
BYTE = 6


# -----------------------------------------------------------------------------
# protobuf wire-format parsing (varint/64-bit/length-delimited/32-bit)
# -----------------------------------------------------------------------------

def _read_varint(data, pos):
    result = 0
    shift = 0
    while True:
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7


def _skip_field(data, pos, wire_type):
    if wire_type == 0:
        _, pos = _read_varint(data, pos)
    elif wire_type == 1:
        pos += 8
    elif wire_type == 2:
        n, pos = _read_varint(data, pos)
        pos += n
    elif wire_type == 5:
        pos += 4
    else:
        raise ValueError("unsupported wire type %d" % wire_type)
    return pos


def _iter_fields(data):
    pos = 0
    n = len(data)
    while pos < n:
        tag, pos = _read_varint(data, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(data, pos)
        elif wire == 5:
            val = data[pos:pos + 4]
            pos += 4
        elif wire == 1:
            val = data[pos:pos + 8]
            pos += 8
        elif wire == 2:
            ln, pos = _read_varint(data, pos)
            val = data[pos:pos + ln]
            pos += ln
        else:
            pos = _skip_field(data, pos, wire)
            continue
        yield field, wire, val


class SentencePieceModel:
    """Parsed spiece.model: pieces, options, and encode/decode engines."""

    def __init__(self, pieces, model_type=1, unk_id=0, bos_id=1, eos_id=2,
                 pad_id=-1, add_dummy_prefix=True, remove_extra_whitespaces=True,
                 escape_whitespaces=True, precompiled_charsmap=b"",
                 byte_fallback=False, unk_surface=" ⁇ "):
        self.pieces = pieces  # list of (piece, score, type)
        self.model_type = model_type  # 1=unigram 2=bpe
        self.unk_id = unk_id
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.add_dummy_prefix = add_dummy_prefix
        self.remove_extra_whitespaces = remove_extra_whitespaces
        self.escape_whitespaces = escape_whitespaces
        self.byte_fallback = byte_fallback
        self.unk_surface = unk_surface
        self.piece_to_id = {}
        for i, (p, _, t) in enumerate(pieces):
            if t != UNUSED and p not in self.piece_to_id:
                self.piece_to_id[p] = i
        # detect unk piece id from type when trainer_spec said nothing
        for i, (_, _, t) in enumerate(pieces):
            if t == UNKNOWN:
                self.unk_id = i
                break
        self._min_score = min((s for _, s, t in pieces if t == NORMAL),
                              default=0.0)
        self._trie = _build_trie(
            (p, i) for p, i in self.piece_to_id.items()
            if pieces[i][2] in (NORMAL, USER_DEFINED))
        self._byte_ids = None
        if byte_fallback or any(t == BYTE for _, _, t in pieces):
            self._byte_ids = {}
            for i, (p, _, t) in enumerate(pieces):
                if t == BYTE and len(p) == 6 and p.startswith("<0x"):
                    self._byte_ids[int(p[3:5], 16)] = i
            if not self._byte_ids:
                self._byte_ids = None
        self._charsmap = (_Charsmap(precompiled_charsmap)
                          if precompiled_charsmap else None)
        self._fast = None  # native unigram engine, built lazily

    # ------------------------------------------------------------------ parse
    @classmethod
    def from_bytes(cls, data):
        pieces = []
        kw = {}
        for field, wire, val in _iter_fields(data):
            if field == 1 and wire == 2:  # SentencePiece
                piece, score, ptype = "", 0.0, NORMAL
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 1 and w2 == 2:
                        piece = v2.decode("utf-8")
                    elif f2 == 2 and w2 == 5:
                        score = struct.unpack("<f", v2)[0]
                    elif f2 == 3 and w2 == 0:
                        ptype = v2
                pieces.append((piece, score, ptype))
            elif field == 2 and wire == 2:  # TrainerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 3 and w2 == 0:
                        kw["model_type"] = v2
                    elif f2 == 35 and w2 == 0:
                        kw["byte_fallback"] = bool(v2)
                    elif f2 == 40 and w2 == 0:
                        kw["unk_id"] = _zigzagless_int(v2)
                    elif f2 == 41 and w2 == 0:
                        kw["bos_id"] = _zigzagless_int(v2)
                    elif f2 == 42 and w2 == 0:
                        kw["eos_id"] = _zigzagless_int(v2)
                    elif f2 == 43 and w2 == 0:
                        kw["pad_id"] = _zigzagless_int(v2)
                    elif f2 == 44 and w2 == 2:
                        kw["unk_surface"] = v2.decode("utf-8")
            elif field == 3 and wire == 2:  # NormalizerSpec
                for f2, w2, v2 in _iter_fields(val):
                    if f2 == 2 and w2 == 2:
                        kw["precompiled_charsmap"] = v2
                    elif f2 == 3 and w2 == 0:
                        kw["add_dummy_prefix"] = bool(v2)
                    elif f2 == 4 and w2 == 0:
                        kw["remove_extra_whitespaces"] = bool(v2)
                    elif f2 == 5 and w2 == 0:
                        kw["escape_whitespaces"] = bool(v2)
        return cls(pieces, **kw)

    @classmethod
    def from_file(cls, path):
        with open(path, "rb") as f:
            return cls.from_bytes(f.read())

    # -------------------------------------------------------------- normalize
    def normalize(self, text):
        if self._charsmap is not None:
            text = self._charsmap.normalize(text)
        else:
            text = unicodedata.normalize("NFKC", text)
        if self.remove_extra_whitespaces:
            text = " ".join(s for s in text.split(" ") if s)
        if not text:
            return text
        if self.add_dummy_prefix:
            text = " " + text
        if self.escape_whitespaces:
            text = text.replace(" ", WS_PIECE)
        return text

    # ----------------------------------------------------------------- encode
    def encode_as_pieces(self, text):
        return [self.pieces[i][0] if i >= 0 else None
                for i in self.encode(text)]

    def encode(self, text):
        text = self.normalize(text)
        if not text:
            return []
        if self.model_type == 2:
            ids = self._encode_bpe(text)
        else:
            ids = self._encode_unigram(text)
        return ids

    def _encode_unigram(self, text):
        """Viterbi over the piece trie. Unknown characters become unk nodes
        with min_score - UNK_PENALTY; consecutive unks fuse into one token
        (sentencepiece EncodeResult semantics); byte pieces, when present,
        replace unk entirely. A native C++ engine (native/sp_unigram.cpp)
        serves the hot loop when built; this Python path is the semantic
        reference and fallback."""
        if self._fast is None:
            from easynlp_tpu_torch.data.fast_sp import FastUnigram
            self._fast = FastUnigram.create(self) or False
        if self._fast:
            ids = self._fast.encode(text)
            if ids is not None:
                return ids
        n = len(text)
        # best[i]: (score, start, piece_id) ending at i
        NEG = -1e18
        best_score = [NEG] * (n + 1)
        best_prev = [-1] * (n + 1)
        best_id = [0] * (n + 1)
        best_score[0] = 0.0
        unk_score = self._min_score - UNK_PENALTY
        for i in range(n):
            if best_score[i] <= NEG:
                continue
            matched = _trie_prefix_matches(self._trie, text, i)
            for end, pid in matched:
                s = best_score[i] + self.pieces[pid][1]
                if s > best_score[end]:
                    best_score[end] = s
                    best_prev[end] = i
                    best_id[end] = pid
            # unknown single char (or byte fallback)
            end = i + 1
            s = best_score[i] + unk_score
            if s > best_score[end]:
                best_score[end] = s
                best_prev[end] = i
                best_id[end] = -1  # unk marker
        # backtrack
        out = []
        pos = n
        while pos > 0:
            prev = best_prev[pos]
            out.append((prev, pos, best_id[pos]))
            pos = prev
        out.reverse()
        ids = []
        i = 0
        while i < len(out):
            start, end, pid = out[i]
            if pid != -1:
                ids.append(pid)
                i += 1
                continue
            # merge consecutive unknowns into one surface
            j = i
            while j < len(out) and out[j][2] == -1:
                j += 1
            surface = text[out[i][0]:out[j - 1][1]]
            if self._byte_ids is not None:
                ids.extend(self._byte_ids.get(b, self.unk_id)
                           for b in surface.encode("utf-8"))
            else:
                ids.append(self.unk_id)
            i = j
        return ids

    def _encode_bpe(self, text):
        """Adjacent-pair merges by (score, position) priority over symbols."""
        import heapq
        chars = list(text)
        # doubly-linked symbol list
        nxt = list(range(1, len(chars) + 1))
        prv = list(range(-1, len(chars)))
        alive = [True] * len(chars)
        syms = chars[:]

        def piece_id(s):
            return self.piece_to_id.get(s, -1)

        heap = []
        counter = 0

        def push(i):
            j = nxt[i]
            if j >= len(syms) or not alive[i] or not alive[j]:
                return
            merged = syms[i] + syms[j]
            pid = piece_id(merged)
            if pid >= 0:
                nonlocal counter
                heapq.heappush(heap, (-self.pieces[pid][1], i, counter, merged))
                counter += 1

        for i in range(len(chars) - 1):
            push(i)
        while heap:
            _, i, _, merged = heapq.heappop(heap)
            j = nxt[i] if i < len(nxt) else len(syms)
            if not (i < len(syms) and alive[i] and j < len(syms)
                    and alive[j] and syms[i] + syms[j] == merged):
                continue
            syms[i] = merged
            alive[j] = False
            nxt[i] = nxt[j]
            if nxt[i] < len(syms):
                prv[nxt[i]] = i
            if prv[i] >= 0:
                push(prv[i])
            push(i)
        ids = []
        unk_run = False
        for i, s in enumerate(syms):
            if not alive[i]:
                continue
            pid = piece_id(s)
            if pid >= 0:
                ids.append(pid)
                unk_run = False
            elif self._byte_ids is not None:
                ids.extend(self._byte_ids.get(b, self.unk_id)
                           for b in s.encode("utf-8"))
                unk_run = False
            else:
                if not unk_run:
                    ids.append(self.unk_id)
                unk_run = True
        return ids

    # ----------------------------------------------------------------- decode
    def id_to_piece(self, i):
        return self.pieces[i][0]

    def decode(self, ids):
        parts = []
        for i in ids:
            piece, _, t = self.pieces[i]
            if t == CONTROL:
                continue
            if t == BYTE:
                parts.append(("byte", int(piece[3:5], 16)))
            elif t == UNKNOWN:
                parts.append(("text", self.unk_surface))
            else:
                parts.append(("text", piece))
        # merge byte runs into utf-8
        out = []
        i = 0
        while i < len(parts):
            kind, val = parts[i]
            if kind == "byte":
                run = bytearray()
                while i < len(parts) and parts[i][0] == "byte":
                    run.append(parts[i][1])
                    i += 1
                out.append(run.decode("utf-8", errors="replace"))
            else:
                out.append(val)
                i += 1
        text = "".join(out).replace(WS_PIECE, " ")
        if self.add_dummy_prefix and text.startswith(" "):
            text = text[1:]
        return text

    def __len__(self):
        return len(self.pieces)


def _zigzagless_int(v):
    """TrainerSpec ids are plain int32 varints; -1 arrives as 2^64-1."""
    return v - (1 << 64) if v >= (1 << 63) else v


# -----------------------------------------------------------------------------
# piece trie (dict-of-dicts; value key is None)
# -----------------------------------------------------------------------------

def _build_trie(items):
    root = {}
    for piece, pid in items:
        node = root
        for ch in piece:
            node = node.setdefault(ch, {})
        node[None] = pid
    return root


def _trie_prefix_matches(trie, text, start):
    """All (end, piece_id) whose piece == text[start:end]."""
    node = trie
    out = []
    i = start
    n = len(text)
    while i < n:
        node = node.get(text[i])
        if node is None:
            break
        i += 1
        pid = node.get(None)
        if pid is not None:
            out.append((i, pid))
    return out


# -----------------------------------------------------------------------------
# precompiled charsmap: Darts double-array over utf-8 prefixes → replacement
# pool (format: <uint32 trie_size><uint32 units...><null-separated strings>)
# -----------------------------------------------------------------------------

class _Charsmap:
    def __init__(self, blob):
        (trie_size,) = struct.unpack("<I", blob[:4])
        n_units = trie_size // 4
        self.units = struct.unpack("<%dI" % n_units, blob[4:4 + trie_size])
        self.pool = blob[4 + trie_size:]

    @staticmethod
    def _offset(unit):
        return (unit >> 10) << ((unit & 0x200) >> 6)

    @staticmethod
    def _label(unit):
        return unit & 0x800000FF

    @staticmethod
    def _value(unit):
        return unit & 0x7FFFFFFF

    @staticmethod
    def _has_leaf(unit):
        return (unit >> 8) & 1

    def longest_match(self, data):
        """Longest prefix of bytes `data` present in the trie → (length,
        replacement bytes) or (0, None)."""
        units = self.units
        node_pos = self._offset(units[0])
        best = (0, None)
        for i, c in enumerate(data):
            pos = node_pos ^ c
            if pos >= len(units):
                break
            unit = units[pos]
            if self._label(unit) != c:
                break
            node_pos = pos ^ self._offset(unit)
            if self._has_leaf(unit):
                idx = self._value(units[node_pos])
                end = self.pool.index(b"\0", idx)
                best = (i + 1, self.pool[idx:end])
        return best

    def normalize(self, text):
        data = text.encode("utf-8")
        out = []
        i = 0
        n = len(data)
        while i < n:
            ln, rep = self.longest_match(data[i:])
            if ln:
                out.append(rep)
                i += ln
            else:
                # copy one UTF-8 char unchanged
                c = data[i]
                step = 1
                if c >= 0xF0:
                    step = 4
                elif c >= 0xE0:
                    step = 3
                elif c >= 0xC0:
                    step = 2
                out.append(data[i:i + step])
                i += step
        return b"".join(out).decode("utf-8", errors="replace")


# -----------------------------------------------------------------------------
# framework tokenizer on top of the engine
# -----------------------------------------------------------------------------

SP_MODEL_NAMES = ("spiece.model", "sentencepiece.model", "sp.model",
                  "tokenizer.model")


def find_sp_model(model_dir):
    """The SentencePiece model file of model_dir (or model_dir itself where
    it names a .model file)."""
    if str(model_dir).endswith(".model"):
        return model_dir
    for name in SP_MODEL_NAMES:
        p = os.path.join(model_dir, name)
        if io.exists(p):
            return p
    raise FileNotFoundError("no sentencepiece model under %r "
                            "(tried %s)" % (model_dir, SP_MODEL_NAMES))


class SentencePieceTokenizer(PreTrainedTokenizer):
    """Tokenizer over a SentencePieceModel. `added_tokens` take the ids
    after the model's pieces, as in HF's convention (T5's <extra_id_*>)."""

    sp_file_name = "spiece.model"

    def __init__(self, sp_model_file, added_tokens=(), unk_token="<unk>",
                 eos_token="</s>", pad_token="<pad>", bos_token=None,
                 sep_token=None, cls_token=None, mask_token=None, **kwargs):
        super().__init__(unk_token=unk_token, sep_token=sep_token,
                         pad_token=pad_token, cls_token=cls_token,
                         mask_token=mask_token, bos_token=bos_token,
                         eos_token=eos_token, **kwargs)
        self.sp_model_file = sp_model_file
        self.sp = SentencePieceModel.from_file(sp_model_file)
        self.added_tokens = list(added_tokens)
        self._added_to_id = {t: len(self.sp) + i
                             for i, t in enumerate(self.added_tokens)}
        self._id_to_added = {i: t for t, i in self._added_to_id.items()}

    # core ---------------------------------------------------------------
    @property
    def vocab_size(self):
        return len(self.sp) + len(self.added_tokens)

    def get_vocab(self):
        v = {p: i for i, (p, _, _) in enumerate(self.sp.pieces)}
        v.update(self._added_to_id)
        return v

    def _tokenize(self, text):
        return [self.sp.id_to_piece(i) for i in self.sp.encode(text)]

    def _encode_core(self, text):
        return self.sp.encode(text)

    def _convert_token_to_id(self, token):
        if token in self._added_to_id:
            return self._added_to_id[token]
        return self.sp.piece_to_id.get(token, self.sp.unk_id)

    def _convert_id_to_token(self, index):
        if index in self._id_to_added:
            return self._id_to_added[index]
        if 0 <= index < len(self.sp):
            return self.sp.id_to_piece(index)
        return self.unk_token

    def convert_tokens_to_string(self, tokens):
        return "".join(tokens).replace(WS_PIECE, " ").strip()

    def _known(self, i):
        """i, or the unknown piece's id where i lies past the model's
        pieces: a model's head may be wider than its tokenizer (t5-base
        32128 rows over 32100 ids, mT5 250112 over 250100), and the JAX
        package's decode raises IndexError there (ROADMAP reference fault
        26), as HF's does not."""
        return i if 0 <= i < len(self.sp) else self.sp.unk_id

    def decode(self, ids, skip_special_tokens=True):
        specials = set(self.all_special_ids) if skip_special_tokens else set()
        core, out = [], []

        def flush_core():
            if core:
                out.append(self.sp.decode(core))
                core.clear()

        for i in ids:
            i = int(i)
            if i not in self._id_to_added:
                i = self._known(i)
            if i in specials:
                continue
            if i in self._id_to_added:
                flush_core()
                out.append(self._id_to_added[i])
            else:
                core.append(i)
        flush_core()
        return " ".join(s for s in out if s)

    # persistence ----------------------------------------------------------
    def save_vocabulary(self, save_directory):
        dst = os.path.join(save_directory, self.sp_file_name)
        if os.path.abspath(dst) != os.path.abspath(self.sp_model_file):
            with open(self.sp_model_file, "rb") as fsrc, \
                    io.open(dst, "wb") as fdst:
                fdst.write(fsrc.read())
        return (dst,)

    @classmethod
    def from_pretrained(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        model_dir = get_pretrain_model_path(model_dir)
        sp_file = find_sp_model(model_dir)
        cfg_file = os.path.join(str(model_dir), TOKENIZER_CONFIG_NAME)
        if io.exists(cfg_file):
            with io.open(cfg_file) as f:
                stored = json.load(f)
            stored.pop("tokenizer_class", None)
            stored.update(kwargs)
            kwargs = stored
        return cls(sp_file, **kwargs)


class T5Tokenizer(SentencePieceTokenizer):
    """T5/mT5 conventions (HF T5Tokenizer): <extra_id_K> sentinels after
    the pieces, with id vocab_size - 1 - K; sequences end with </s>."""

    def __init__(self, sp_model_file, extra_ids=100, **kwargs):
        extras = ["<extra_id_%d>" % i for i in range(extra_ids - 1, -1, -1)]
        kwargs.setdefault("added_tokens", extras)
        kwargs.pop("extra_ids", None)
        super().__init__(sp_model_file, **kwargs)
        self.extra_ids = extra_ids
        self.init_kwargs["extra_ids"] = extra_ids

    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        eos = [self.eos_token_id]
        if ids_b is None:
            return list(ids_a) + eos
        return list(ids_a) + eos + list(ids_b) + eos

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        return [0] * len(self.build_inputs_with_special_tokens(ids_a, ids_b))


MT5Tokenizer = T5Tokenizer


