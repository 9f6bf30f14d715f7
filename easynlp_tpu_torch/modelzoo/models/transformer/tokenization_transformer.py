"""subword-nmt BPE tokenizer of the `transformer` family for the PyTorch
port (the port's own copy of
easynlp_tpu/modelzoo/models/transformer/tokenization_transformer.py).

ParlAI's dictionary conventions: words split by the regex \\w+|[^\\w\\s],
lowercased, newlines written as __newln__; subword-nmt BPE from a codecs
file (version 0.1, or 0.2 with the word-final '</w>' fused to the last
character), '@@' marking a piece that continues; the specials __null__
(pad), __start__, __end__ and __unk__.
"""

import os
import re

from easynlp_tpu_torch.modelzoo.tokenization_utils import (
    PreTrainedTokenizer,
    load_vocab,
)
from easynlp_tpu_torch.utils.io_utils import io

CODECS_NAME = "codecs.txt"
SPLITTER = re.compile(r"\w+|[^\w\s]", re.UNICODE)


def load_codecs(codecs_file):
    """codecs file → ({pair: rank}, {merged: pair}, version)."""
    with io.open(codecs_file) as f:
        lines = f.read().rstrip("\n").split("\n")
    version = (0, 1)
    if lines and lines[0].startswith("#version:"):
        version = tuple(int(x) for x in
                        lines[0].split("#version:")[1].strip().split("."))
        lines = lines[1:]
    pairs = [tuple(ln.strip("\r\n ").split(" ")) for ln in lines if ln]
    codes = {pair: rank for rank, pair in reversed(list(enumerate(pairs)))}
    reverse = {a + b: (a, b) for (a, b) in codes}
    return codes, reverse, version


def bpe_encode_word(word, codes, version, cache):
    """Apply merge operations in rank order (subword-nmt `encode`)."""
    if word in cache:
        return cache[word]
    if len(word) == 1:
        return (word,)
    if version == (0, 1):
        symbols = list(word) + ["</w>"]
    else:  # (0, 2): word-final marker fused onto the last char
        symbols = list(word[:-1]) + [word[-1] + "</w>"]
    while len(symbols) > 1:
        ranked = [(codes[p], i, p) for i, p in
                  enumerate(zip(symbols, symbols[1:])) if p in codes]
        if not ranked:
            break
        bigram = min(ranked)[2]
        positions = [i for r, i, p in ranked if p == bigram]
        merged = "".join(bigram)
        out, i = [], 0
        for j in positions:
            if j < i:
                continue
            out.extend(symbols[i:j])
            out.append(merged)
            i = j + 2
        out.extend(symbols[i:])
        symbols = out
    if symbols[-1] == "</w>":
        symbols = symbols[:-1]
    elif symbols[-1].endswith("</w>"):
        symbols = symbols[:-1] + [symbols[-1][:-4]]
    result = tuple(symbols)
    cache[word] = result
    return result


class TransformerTokenizer(PreTrainedTokenizer):
    def __init__(self, vocab_file, codecs_file, do_lower_case=True,
                 null_token="__null__", bos_token="__start__",
                 eos_token="__end__", unk_token="__unk__", separator="@@",
                 **kwargs):
        super().__init__(unk_token=unk_token, pad_token=null_token,
                         bos_token=bos_token, eos_token=eos_token,
                         sep_token=None, cls_token=None, mask_token=None,
                         do_lower_case=do_lower_case, **kwargs)
        self.do_lower_case = do_lower_case
        self.separator = separator
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.codes, self.codes_reverse, self.version = load_codecs(codecs_file)
        self._cache = {}

    @property
    def vocab_size(self):
        return len(self.vocab)

    def get_vocab(self):
        return dict(self.vocab)

    def _tokenize(self, text):
        if self.do_lower_case:
            text = text.lower()
        text = text.replace("\n", " __newln__ ")
        out = []
        for word in SPLITTER.findall(text):
            if not word:
                continue
            pieces = bpe_encode_word(word, self.codes, self.version,
                                     self._cache)
            out.extend(p + self.separator for p in pieces[:-1])
            out.append(pieces[-1])
        return out

    def _convert_token_to_id(self, token):
        return self.vocab.get(token, self.vocab.get(self.unk_token))

    def _convert_id_to_token(self, index):
        return self.ids_to_tokens.get(index, self.unk_token)

    def convert_tokens_to_string(self, tokens):
        text = " ".join(tokens).replace(self.separator + " ", "")
        if text.endswith(self.separator):
            text = text[:-len(self.separator)]
        return text.replace("__newln__", "\n").strip()

    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        bos, eos = [self.bos_token_id], [self.eos_token_id]
        if ids_b is None:
            return bos + list(ids_a) + eos
        return bos + list(ids_a) + eos + list(ids_b) + eos

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        return [0] * len(self.build_inputs_with_special_tokens(ids_a, ids_b))

    def save_vocabulary(self, save_directory):
        vpath = os.path.join(save_directory, "vocab.txt")
        with io.open(vpath, "w") as f:
            for tok, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(tok + "\n")
        cpath = os.path.join(save_directory, CODECS_NAME)
        with io.open(cpath, "w") as f:
            f.write("#version: %d.%d\n" % self.version)
            for pair, _ in sorted(self.codes.items(), key=lambda kv: kv[1]):
                f.write("%s %s\n" % pair)
        return (vpath, cpath)

    @classmethod
    def from_pretrained(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        model_dir = get_pretrain_model_path(model_dir)
        return cls(os.path.join(model_dir, "vocab.txt"),
                   os.path.join(model_dir, CODECS_NAME), **kwargs)
