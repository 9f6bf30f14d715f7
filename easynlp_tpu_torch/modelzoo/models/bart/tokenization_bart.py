"""BART's byte-level BPE tokenizer for the PyTorch port.

The same vocab.json + merges.txt, byte table, pre-tokenisation and merges as
the port's GPT2Tokenizer, with BART's own special tokens: <s> (BOS, CLS),
</s> (EOS, SEP), <pad>, <unk> and <mask>. A sequence is encoded as
`<s> A </s>`, a pair as `<s> A </s></s> B </s>`, every token type 0, as
transformers' BartTokenizer does.

The JAX package gives BART checkpoints the GPT-2 tokenizer, whose special
tokens are all <|endoftext|>; a real BART vocabulary has none of that
token, so its pad and EOS ids come out None there (ROADMAP C11).
`modelzoo/models/auto.py` routes a BART checkpoint here when its vocabulary
holds </s> at the config's EOS id, and to the GPT-2 tokenizer otherwise (as
JAX does). A special token written literally inside the text is tokenised
as text, not split out as transformers does.
"""

import json
import os

from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (
    GPT2Tokenizer,
)
from easynlp_tpu_torch.utils.io_utils import io


class BartTokenizer(GPT2Tokenizer):
    def __init__(self, vocab_file, merges_file, errors="replace",
                 bos_token="<s>", eos_token="</s>", sep_token="</s>",
                 cls_token="<s>", unk_token="<unk>", pad_token="<pad>",
                 mask_token="<mask>", **kwargs):
        super().__init__(vocab_file, merges_file, errors=errors,
                         unk_token=unk_token, bos_token=bos_token,
                         eos_token=eos_token, pad_token=pad_token,
                         cls_token=cls_token, sep_token=sep_token,
                         mask_token=mask_token, **kwargs)

    def build_inputs_with_special_tokens(self, ids_a, ids_b=None):
        out = [self.cls_token_id] + list(ids_a) + [self.sep_token_id]
        if ids_b is None:
            return out
        return out + [self.sep_token_id] + list(ids_b) + [self.sep_token_id]

    def create_token_type_ids_from_sequences(self, ids_a, ids_b=None):
        return [0] * len(self.build_inputs_with_special_tokens(ids_a, ids_b))

    @staticmethod
    def fits(model_dir, eos_token_id):
        """Whether model_dir's vocab.json holds </s> at eos_token_id."""
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        path = os.path.join(get_pretrain_model_path(model_dir), "vocab.json")
        if not io.exists(path):
            return False
        with io.open(path) as f:
            return json.load(f).get("</s>") == eos_token_id
