"""GPT-2 byte-level BPE tokenizer for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/gpt2/tokenization_gpt2.py. The
same vocab.json + merges.txt files, byte-to-unicode table, regex
pre-tokenisation and BPE merge loop on the port's tokenization_utils base,
so it gives the same ids. Its pad token is the EOS token, as there.
"""

import json
import os
import re

from easynlp_tpu_torch.modelzoo.tokenization_utils import PreTrainedTokenizer
from easynlp_tpu_torch.utils.io_utils import io

# GPT-2 pre-tokenisation pattern ('s, 't, numbers, letters, other, spaces)
_PAT = re.compile(
    r"'s|'t|'re|'ve|'m|'ll|'d| ?[^\W\d_]+| ?\d+| ?[^\s\w]+|\s+(?!\S)|\s+",
    re.UNICODE)


def bytes_to_unicode():
    """GPT-2's table from each byte to a printable unicode character."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


class GPT2Tokenizer(PreTrainedTokenizer):
    def __init__(self, vocab_file, merges_file, errors="replace",
                 unk_token="<|endoftext|>", bos_token="<|endoftext|>",
                 eos_token="<|endoftext|>", pad_token=None, cls_token=None,
                 sep_token=None, mask_token=None, **kwargs):
        super().__init__(unk_token=unk_token, bos_token=bos_token,
                         eos_token=eos_token,
                         pad_token=pad_token or eos_token,
                         cls_token=cls_token, sep_token=sep_token,
                         mask_token=mask_token, **kwargs)
        with io.open(vocab_file) as f:
            self.encoder = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        self.errors = errors
        self.byte_encoder = bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        with io.open(merges_file) as f:
            merges = f.read().split("\n")
        merges = [tuple(m.split()) for m in merges
                  if m and not m.startswith("#version")]
        self.bpe_ranks = {m: i for i, m in enumerate(merges)}
        self.cache = {}

    @property
    def vocab_size(self):
        return len(self.encoder)

    def get_vocab(self):
        return dict(self.encoder)

    def _bpe(self, token):
        if token in self.cache:
            return self.cache[token]
        word = tuple(token)
        while len(word) > 1:
            pairs = {(word[i], word[i + 1]) for i in range(len(word) - 1)}
            best = min(pairs,
                       key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if best not in self.bpe_ranks:
                break
            first, second = best
            new_word, i = [], 0
            while i < len(word):
                if (i < len(word) - 1 and word[i] == first
                        and word[i + 1] == second):
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
        out = list(word)
        self.cache[token] = out
        return out

    def _tokenize(self, text):
        tokens = []
        for chunk in _PAT.findall(text):
            mapped = "".join(self.byte_encoder[b]
                             for b in chunk.encode("utf-8"))
            tokens.extend(self._bpe(mapped))
        return tokens

    def _convert_token_to_id(self, token):
        return self.encoder.get(token, self.encoder.get(self.unk_token))

    def _convert_id_to_token(self, index):
        return self.decoder.get(index, self.unk_token)

    def convert_tokens_to_string(self, tokens):
        text = "".join(tokens)
        data = bytearray(self.byte_decoder[c] for c in text
                         if c in self.byte_decoder)
        return data.decode("utf-8", errors=self.errors)

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        return [0] * (len(ids_a) + (len(ids_b) if ids_b else 0))

    def save_vocabulary(self, save_directory):
        """vocab.json and merges.txt (save_pretrained also writes the
        special-token map and tokenizer_config.json)."""
        vocab_path = os.path.join(save_directory, "vocab.json")
        merges_path = os.path.join(save_directory, "merges.txt")
        with io.open(vocab_path, "w") as f:
            json.dump(self.encoder, f, ensure_ascii=False)
        with io.open(merges_path, "w") as f:
            f.write("#version: 0.2\n")
            for pair, _ in sorted(self.bpe_ranks.items(), key=lambda kv: kv[1]):
                f.write(" ".join(pair) + "\n")
        return vocab_path, merges_path

    @classmethod
    def from_pretrained(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        model_dir = get_pretrain_model_path(model_dir)
        return cls(os.path.join(model_dir, "vocab.json"),
                   os.path.join(model_dir, "merges.txt"), **kwargs)
