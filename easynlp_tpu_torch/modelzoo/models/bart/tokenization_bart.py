"""BART's byte-level BPE tokenizer for the PyTorch port.

RoBERTa's tokenizer (modelzoo/models/bert/tokenization_roberta.py): the
same vocab.json + merges.txt, byte table, pre-tokenisation and merges as
the port's GPT2Tokenizer, with the special tokens <s> (BOS, CLS), </s>
(EOS, SEP), <pad>, <unk> and <mask>. A sequence is encoded as `<s> A </s>`,
a pair as `<s> A </s></s> B </s>`, every token type 0, as transformers'
BartTokenizer does.

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

from easynlp_tpu_torch.modelzoo.models.bert.tokenization_roberta import (
    RobertaTokenizer,
)
from easynlp_tpu_torch.utils.io_utils import io


class BartTokenizer(RobertaTokenizer):
    """RoBERTa's tokenizer (as transformers' BartTokenizer is), and the test
    that routes a BART checkpoint to it."""

    @staticmethod
    def fits(model_dir, eos_token_id):
        """Whether model_dir's vocab.json holds </s> at eos_token_id."""
        from easynlp_tpu_torch.utils import get_pretrain_model_path
        path = os.path.join(get_pretrain_model_path(model_dir), "vocab.json")
        if not io.exists(path):
            return False
        with io.open(path) as f:
            return json.load(f).get("</s>") == eos_token_id
