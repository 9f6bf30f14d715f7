"""BERT WordPiece tokenizer for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/bert/tokenization_bert.py, which
the port cannot import: that package's `__init__` pulls in the JAX model.
Built on the port's copies of the same pieces (tokenization_utils and the
native FastWordPiece), so it gives the same ids.
"""

import json
import os

from easynlp_tpu_torch.modelzoo.tokenization_utils import (
    VOCAB_NAME,
    BasicTokenizer,
    PreTrainedTokenizer,
    WordpieceTokenizer,
    load_vocab,
)
from easynlp_tpu_torch.utils.io_utils import io


class BertTokenizer(PreTrainedTokenizer):
    def __init__(self, vocab_file, do_lower_case=True, do_basic_tokenize=True,
                 never_split=None, tokenize_chinese_chars=True,
                 strip_accents=None, **kwargs):
        super().__init__(do_lower_case=do_lower_case, **kwargs)
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.do_basic_tokenize = do_basic_tokenize
        if do_basic_tokenize:
            self.basic_tokenizer = BasicTokenizer(
                do_lower_case=do_lower_case, never_split=never_split,
                tokenize_chinese_chars=tokenize_chinese_chars,
                strip_accents=strip_accents)
        self.wordpiece_tokenizer = WordpieceTokenizer(
            vocab=self.vocab, unk_token=self.unk_token)
        # native fast path (C++), exact-output; absent library -> pure Python
        self._fast = None
        if do_basic_tokenize and not never_split and \
                os.environ.get("EASYNLP_FAST_TOKENIZER", "1") != "0" and \
                str(vocab_file).endswith(".txt") and \
                os.path.exists(vocab_file):
            from easynlp_tpu_torch.data.fast_tokenizer import FastWordPiece, available
            if available():
                self._fast = FastWordPiece(
                    vocab_file, do_lower_case=do_lower_case,
                    unk_token=self.unk_token, strip_accents=strip_accents)

    def _encode_core(self, text):
        # the native path does not protect special tokens embedded in text
        if self._fast is not None and \
                not any(t in text for t in self.all_special_tokens):
            return self._fast.encode(text)
        return self.convert_tokens_to_ids(self.tokenize(text))

    @property
    def vocab_size(self):
        return len(self.vocab)

    def get_vocab(self):
        return dict(self.vocab)

    def _tokenize(self, text):
        if not self.do_basic_tokenize:
            return self.wordpiece_tokenizer.tokenize(text)
        out = []
        for token in self.basic_tokenizer.tokenize(
                text, never_split=self.all_special_tokens):
            if token in self.basic_tokenizer.never_split or \
                    token in self.all_special_tokens:
                out.append(token)
            else:
                out.extend(self.wordpiece_tokenizer.tokenize(token))
        return out

    def _convert_token_to_id(self, token):
        return self.vocab.get(token, self.vocab.get(self.unk_token))

    def _convert_id_to_token(self, index):
        return self.ids_to_tokens.get(index, self.unk_token)

    def convert_tokens_to_string(self, tokens):
        return " ".join(tokens).replace(" ##", "").strip()

    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        cls, sep = [self.cls_token_id], [self.sep_token_id]
        if ids_b is None:
            return cls + list(ids_a) + sep
        return cls + list(ids_a) + sep + list(ids_b) + sep

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        if ids_b is None:
            return [0] * (len(ids_a) + 2)
        return [0] * (len(ids_a) + 2) + [1] * (len(ids_b) + 1)

    def save_vocabulary(self, save_directory):
        """vocab.txt, one token per line in id order (save_pretrained also
        writes the special-token map and tokenizer_config.json)."""
        path = os.path.join(save_directory, VOCAB_NAME)
        with io.open(path, "w") as f:
            for token, _ in sorted(self.vocab.items(), key=lambda kv: kv[1]):
                f.write(token + "\n")
        return (path,)

    @classmethod
    def from_pretrained(cls, model_dir, **kwargs):
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        model_dir = get_pretrain_model_path(model_dir)
        vocab_file = (model_dir if str(model_dir).endswith(".txt")
                      else os.path.join(model_dir, VOCAB_NAME))
        cfg_file = os.path.join(model_dir, "tokenizer_config.json")
        if io.exists(cfg_file):
            with io.open(cfg_file) as f:
                stored = json.load(f)
            stored.pop("tokenizer_class", None)
            stored.update(kwargs)
            kwargs = stored
        return cls(vocab_file, **kwargs)
