"""The port's tokenizers of slice 10 against the JAX package's, on the CPU:
the SentencePiece engine (unigram Viterbi, BPE merges, byte fallback, the
precompiled-charsmap normaliser, unknown fusing, decode), T5's sentinels and
Pegasus's offset layout, each on the native path (native/sp_unigram.cpp
built by the port's data/native_lib.py) and the Python path; Randeng's
WordPiece (with and without jieba); the dialogue transformer's subword-nmt
BPE (codecs v0.1 and v0.2); and chip_smoke.py's own ModelProto writer
against protobuf's. Every comparison is exact: ids, pieces and decoded
text equal to JAX's.
"""

import os
import random
import sys

import pytest

from easynlp_tpu.modelzoo import tokenization_sentencepiece as jax_sp
from easynlp_tpu.modelzoo.models.pegasus import (
    PegasusTokenizer as JaxPegasusTokenizer,
)
from easynlp_tpu.modelzoo.models.t5 import T5Tokenizer as JaxT5Tokenizer
from test_sentencepiece import PIECES, write_model_proto

from easynlp_tpu_torch.modelzoo import tokenization_sentencepiece as port_sp
from easynlp_tpu_torch.modelzoo.models.pegasus import PegasusTokenizer
from easynlp_tpu_torch.modelzoo.models.t5 import T5Tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BYTES = [("<0x%02X>" % b, -6.0, jax_sp.BYTE) for b in range(256)]
BPE_PIECES = [("<unk>", 0.0, jax_sp.UNKNOWN), ("▁", -1.0, jax_sp.NORMAL),
              ("a", -2.0, jax_sp.NORMAL), ("b", -2.1, jax_sp.NORMAL),
              ("ab", -0.5, jax_sp.NORMAL), ("▁ab", -0.2, jax_sp.NORMAL),
              ("abb", -3.0, jax_sp.NORMAL), ("▁b", -2.5, jax_sp.NORMAL),
              ("ba", -1.5, jax_sp.NORMAL)]
# the charsmap's replacements: NFKC-like folds of single code points, a
# decomposed e + U+0301 composed to U+00E9, a longer key sharing that prefix
# (e + U+0301 + U+0301: sentencepiece takes the longest match), and a
# deletion (U+200B)
CHARSMAP = {"\uff21": "A", "\ufb01": "fi", "\u2460": "1", "\uff54": "t",
            "e\u0301": "\u00e9", "e\u0301\u0301": "E", "\u200b": ""}
TEXTS = ["the quick brown fox", "the ZZZ the", "thequick  quick", "",
         " ", "t h e", "\ufb01 \uff21 \u2460 \uff54he e\u0301",
         "e\u0301 e\u0301\u0301x", "the \u00e9 \u4e2d\u6587 quick",
         "ab abb ba bab", "a\u200bb \n\tthe"]


def darts_charsmap(mapping):
    """A precompiled charsmap blob: <uint32 trie bytes><Darts double-array
    units><NUL-terminated replacements>, the layout sentencepiece writes
    and tokenization_sentencepiece._Charsmap reads. Each node's children
    sit at base ^ byte and its value unit at base ^ 0; no two nodes share
    a base."""
    import struct
    pool, trie = bytearray(), {}
    for src, rep in mapping.items():
        node = trie
        for b in src.encode("utf-8"):
            node = node.setdefault(b, {})
        node[None] = len(pool)
        pool += rep.encode("utf-8") + b"\0"
    units, used, bases = {}, {0}, set()

    def place(node, pos, label):
        wanted = sorted(k for k in node if k is not None)
        slots = wanted + ([0] if None in node else [])
        base = 1
        while base in bases or any(base ^ c in used for c in slots):
            base += 1
        bases.add(base)
        used.update(base ^ c for c in slots)
        assert pos ^ base < 1 << 21
        units[pos] = ((pos ^ base) << 10) | (1 << 8 if None in node else 0) \
            | label
        if None in node:
            units[base] = (1 << 31) | node[None]
        for c in wanted:
            place(node[c], base ^ c, c)

    place(trie, 0, 0)
    n = max(units) + 1
    blob = struct.pack("<%dI" % n, *[units.get(i, 0) for i in range(n)])
    return struct.pack("<I", len(blob)) + blob + bytes(pool)


def write_charsmap_model(path, pieces):
    pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
    mp = pb.ModelProto()
    with open(write_model_proto(path, pieces), "rb") as f:
        mp.ParseFromString(f.read())
    mp.normalizer_spec.precompiled_charsmap = darts_charsmap(CHARSMAP)
    with open(path, "wb") as f:
        f.write(mp.SerializeToString())
    return path


MODELS = {
    "unigram": lambda p: write_model_proto(p, PIECES),
    "bytes": lambda p: write_model_proto(p, PIECES + BYTES,
                                         byte_fallback=True),
    "bpe": lambda p: write_model_proto(p, BPE_PIECES, model_type=2,
                                       unk_id=0),
    "charsmap": lambda p: write_charsmap_model(p, PIECES + BYTES),
}


@pytest.fixture(scope="module")
def sp_files(tmp_path_factory):
    base = tmp_path_factory.mktemp("torch_sp")
    return {name: make(str(base / ("%s.model" % name)))
            for name, make in MODELS.items()}


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("name", sorted(MODELS))
def test_sentencepiece_model_matches_jax(sp_files, name, native):
    """Ids, pieces, normalised text and decodes equal to the JAX engine's
    (which takes its Python path here) on every test text; the native
    path really ran where asked (unigram models only: BPE has none)."""
    want = jax_sp.SentencePieceModel.from_file(sp_files[name])
    want._fast = False
    got = port_sp.SentencePieceModel.from_file(sp_files[name])
    if not native:
        got._fast = False
    assert got.pieces == want.pieces
    for attr in ("unk_id", "bos_id", "eos_id", "pad_id", "model_type",
                 "add_dummy_prefix", "byte_fallback"):
        assert getattr(got, attr) == getattr(want, attr), attr
    for text in TEXTS:
        assert got.normalize(text) == want.normalize(text), text
        ids = got.encode(text)
        assert ids == want.encode(text), text
        assert got.encode_as_pieces(text) == want.encode_as_pieces(text)
        assert got.decode(ids) == want.decode(ids), text
    if native and name != "bpe":
        assert got._fast, "the native sp_unigram path did not load"


def test_charsmap_matches_the_tokenizers_library():
    """The charsmap blob normalises as the `tokenizers` library's
    Precompiled normaliser does, so the builder above writes what
    sentencepiece writes. The library applies a key that spans several
    code points per grapheme, not by sentencepiece's longest byte prefix,
    so that key (held to JAX's engine above) is left out here."""
    from tokenizers import normalizers
    single = {k: v for k, v in CHARSMAP.items() if len(k) == 1}
    blob = darts_charsmap(single)
    oracle = normalizers.Precompiled(blob)
    for text in TEXTS:
        assert port_sp._Charsmap(blob).normalize(text) == \
            oracle.normalize_str(text), text
    full = port_sp._Charsmap(darts_charsmap(CHARSMAP))
    assert full.normalize("\ufb01e\u0301\u0301e\u0301") == "fiE\u00e9"


def test_native_viterbi_matches_python_on_random_text(sp_files):
    """native/sp_unigram.cpp against the Python Viterbi on 200 random
    strings of pieces, CJK and Greek letters (unknowns), and bytes."""
    from easynlp_tpu_torch.data.fast_sp import FastUnigram
    rng = random.Random(0)
    for name in ("unigram", "bytes"):
        model = port_sp.SentencePieceModel.from_file(sp_files[name])
        fast = FastUnigram.create(model)
        assert fast is not None
        words = [p.replace("▁", "") for p, _, t in model.pieces
                 if t == port_sp.NORMAL]
        for _ in range(200):
            parts = [rng.choice(words) if rng.random() < 0.6
                     else chr(rng.choice([rng.randint(0x4e00, 0x4e50),
                                          rng.randint(0x391, 0x3a9)]))
                     for _ in range(rng.randint(1, 10))]
            text = model.normalize(" ".join(parts))
            model._fast = False
            want = model._encode_unigram(text)
            assert fast.encode(text) == want, text


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_t5_and_pegasus_tokenizers_match_jax(sp_files, tmp_path, native):
    """T5's 100 sentinels (<extra_id_0> the last id), one </s> per
    sequence, pairs, padding, decodes with and without specials; Pegasus's
    ids 0-3, <unk_2>..<unk_102> and offset 103; both saved and read back
    through from_pretrained."""
    path = sp_files["bytes"]
    pairs = ((T5Tokenizer(path), JaxT5Tokenizer(path)),
             (PegasusTokenizer(path), JaxPegasusTokenizer(path)))
    for got, want in pairs:
        if not native:
            got.sp._fast = False
        want.sp._fast = False
        assert got.vocab_size == want.vocab_size
        assert got.all_special_ids == want.all_special_ids
        assert got.get_vocab() == want.get_vocab()
        for token in ("<extra_id_0>", "<extra_id_99>", "<mask_1>",
                      "<mask_2>", "<unk_2>", "<unk_102>", "▁the", "zzz"):
            assert got._convert_token_to_id(token) == \
                want._convert_token_to_id(token), token
        for text in TEXTS:
            a = got(text, text_pair="the fox", max_length=16)
            b = want(text, text_pair="the fox", max_length=16)
            for key in b:
                assert list(a[key]) == list(b[key]), (text, key)
            ids = got.encode_plus(text, max_length=24)["input_ids"]
            ids = list(ids) + [got._convert_token_to_id("<extra_id_3>")]
            for skip in (True, False):
                assert got.decode(ids, skip_special_tokens=skip) == \
                    want.decode(ids, skip_special_tokens=skip), text
        out = str(tmp_path / type(got).__name__)
        got.save_pretrained(out)
        again = type(got).from_pretrained(out)
        assert again.vocab_size == got.vocab_size
        assert again._encode_core("the é") == want._encode_core("the é")
    t5 = pairs[0][0]
    assert t5._convert_token_to_id("<extra_id_0>") == t5.vocab_size - 1
    assert pairs[1][0]._convert_token_to_id("▁the") == 4 + 103


def test_ids_past_the_vocabulary_reference_fault_26(sp_files):
    """ROADMAP reference fault 26: a model's head can be wider than its
    tokenizer (t5-base: 32128 rows over 32100 ids; mT5: 250112 over
    250100), so generation can emit an id past the SentencePiece model's
    pieces. The JAX tokenizers' decode raises IndexError on it; the port's
    decodes it as the unknown piece, as its _convert_id_to_token (and
    JAX's) already maps it to <unk>."""
    path = sp_files["unigram"]
    for got, want in ((T5Tokenizer(path), JaxT5Tokenizer(path)),
                      (PegasusTokenizer(path), JaxPegasusTokenizer(path))):
        past = got.vocab_size + 3
        ids = list(got.encode_plus("the fox", max_length=6)["input_ids"])
        with pytest.raises(IndexError):
            want.decode(ids[:2] + [past])
        assert got.decode(ids[:2] + [past]) == \
            want.decode(ids[:2] + [want._convert_token_to_id("<unk>")])
        assert got._convert_id_to_token(past) == "<unk>"


def _cjk_vocab(path):
    words = ["中文", "模型", "生成", "摘要", "the", "model", "##s"]
    chars = list("中文模型生成摘要今天天气很好我们的是在了")
    tokens = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"] + words + chars
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(tokens) + "\n")
    return path


RANDENG_TEXTS = ["今天天气很好", "中文模型生成摘要", "我们的模型在生成了",
                 "the models 中文", "未知字 model"]


def test_randeng_tokenizer_matches_jax(tmp_path, monkeypatch):
    """RandengTokenizer is WordPiece: with jieba installed (here) the words
    jieba cuts and the vocab holds stay whole, as in JAX's; without jieba
    (neither the JAX image nor the card's machine has it) it is BERT's
    tokenizer, native path included, and still JAX's ids."""
    from easynlp_tpu.modelzoo.models.randeng import tokenization_randeng \
        as jax_randeng

    from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
    from easynlp_tpu_torch.modelzoo.models.randeng import (
        tokenization_randeng)
    vocab = _cjk_vocab(str(tmp_path / "vocab.txt"))
    if tokenization_randeng.jieba is not None:
        got = tokenization_randeng.RandengTokenizer(vocab)
        want = jax_randeng.RandengTokenizer(vocab)
        assert got._fast is None
        for text in RANDENG_TEXTS:
            assert got.tokenize(text) == want.tokenize(text), text
            assert list(got(text, max_length=16)["input_ids"]) == \
                list(want(text, max_length=16)["input_ids"])
        assert "中文" in got.tokenize("中文模型")
    monkeypatch.setattr(tokenization_randeng, "jieba", None)
    monkeypatch.setattr(jax_randeng, "_HAS_JIEBA", False)
    got = tokenization_randeng.RandengTokenizer(vocab)
    want = jax_randeng.RandengTokenizer(vocab)
    bert = BertTokenizer(vocab)
    for text in RANDENG_TEXTS:
        ids = list(got(text, max_length=16)["input_ids"])
        assert ids == list(want(text, max_length=16)["input_ids"]), text
        assert ids == list(bert(text, max_length=16)["input_ids"]), text


def write_transformer_tokenizer(model_dir, version="0.2"):
    """A ParlAI dictionary (vocab.txt, one token a line) and a subword-nmt
    codecs.txt of the given version."""
    os.makedirs(model_dir, exist_ok=True)
    merges = [("t", "h"), ("th", "e</w>"), ("e", "r"), ("o", "n"),
              ("m", "o"), ("mo", "d"), ("d", "e"), ("l", "</w>"),
              ("h", "e</w>"), ("a", "t"), ("at", "</w>")]
    if version == "0.1":
        merges = [("t", "h"), ("th", "e"), ("the", "</w>"), ("e", "r"),
                  ("o", "n"), ("m", "o"), ("mo", "d")]
    specials = ["__null__", "__start__", "__end__", "__unk__", "__newln__"]
    letters = list("abcdefghijklmnopqrstuvwxyz")
    pieces = sorted({a + b for a, b in merges} | set(letters))
    tokens = specials + [p.replace("</w>", "") for p in pieces]
    tokens += [t + "@@" for t in tokens[len(specials):]] + [",", "!", "?"]
    seen = []
    for t in tokens:
        if t not in seen:
            seen.append(t)
    with open(os.path.join(model_dir, "vocab.txt"), "w") as f:
        f.write("\n".join(seen) + "\n")
    with open(os.path.join(model_dir, "codecs.txt"), "w") as f:
        f.write("#version: %s\n" % version)
        f.write("".join("%s %s\n" % m for m in merges))
    return len(seen)


DIALOGUE_TEXTS = ["The model, then the other!", "hello there\nmodel",
                  "What is the ORDER?", "th the thethe", "zzz q"]


@pytest.mark.parametrize("version", ["0.1", "0.2"])
def test_transformer_tokenizer_matches_jax(tmp_path, version):
    """The dialogue transformer's subword-nmt BPE: pieces, ids with
    __start__/__end__, pairs, decodes and a save/load round trip equal to
    JAX's, for codecs of both versions."""
    from easynlp_tpu.modelzoo.models.transformer import (
        TransformerTokenizer as JaxTokenizer)

    from easynlp_tpu_torch.modelzoo.models.transformer import (
        TransformerTokenizer)
    write_transformer_tokenizer(str(tmp_path), version)
    got = TransformerTokenizer.from_pretrained(str(tmp_path))
    want = JaxTokenizer.from_pretrained(str(tmp_path))
    assert got.version == want.version == tuple(map(int, version.split(".")))
    for text in DIALOGUE_TEXTS:
        assert got.tokenize(text) == want.tokenize(text), text
        a = got(text, text_pair="the model", max_length=24)
        b = want(text, text_pair="the model", max_length=24)
        for key in b:
            assert list(a[key]) == list(b[key]), (text, key)
        ids = list(a["input_ids"])
        assert got.decode(ids) == want.decode(ids), text
    got.save_pretrained(str(tmp_path / "out"))
    again = TransformerTokenizer.from_pretrained(str(tmp_path / "out"))
    assert again.tokenize(DIALOGUE_TEXTS[0]) == got.tokenize(
        DIALOGUE_TEXTS[0])


def test_chip_smoke_sentencepiece_writer(tmp_path):
    """chip_smoke.py writes its SentencePiece models with its own ModelProto
    writer (the card's machine has neither transformers nor protobuf):
    protobuf parses its bytes into the same message the official schema
    writes, and both engines read them as the schema's bytes; its
    synthetic T5 model's pieces encode English words without unknowns."""
    pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
    sys.path.insert(0, REPO)
    import chip_smoke
    pieces = PIECES + BYTES
    blob = chip_smoke.sp_model_bytes(pieces, model_type=1, unk_id=2,
                                     bos_id=-1, eos_id=1, pad_id=0,
                                     byte_fallback=True)
    ref = pb.ModelProto()
    with open(write_model_proto(str(tmp_path / "ref.model"), pieces,
                                byte_fallback=True), "rb") as f:
        ref.ParseFromString(f.read())
    mine = pb.ModelProto()
    mine.ParseFromString(blob)
    assert [(p.piece, p.score, p.type) for p in mine.pieces] == \
        [(p.piece, p.score, p.type) for p in ref.pieces]
    for field in ("model_type", "unk_id", "bos_id", "eos_id", "pad_id",
                  "byte_fallback"):
        assert getattr(mine.trainer_spec, field) == \
            getattr(ref.trainer_spec, field), field
    want = jax_sp.SentencePieceModel.from_bytes(ref.SerializeToString())
    got = port_sp.SentencePieceModel.from_bytes(blob)
    assert got.pieces == want.pieces and got.unk_id == want.unk_id
    assert got.byte_fallback and got.pad_id == 0 and got.bos_id == -1
    t5_pieces = chip_smoke.t5_sp_pieces(random.Random(0))
    model = port_sp.SentencePieceModel(t5_pieces)
    assert len(t5_pieces) == chip_smoke.T5_SP_PIECES
    ids = model.encode(" ".join(chip_smoke.ENGLISH * 3))
    assert model.unk_id not in ids and len(ids) > 3 * len(chip_smoke.ENGLISH)
