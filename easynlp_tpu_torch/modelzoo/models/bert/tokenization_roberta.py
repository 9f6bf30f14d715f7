"""RoBERTa's byte-level BPE tokenizer for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/bert/tokenization_roberta.py:
the port's GPT2Tokenizer (the same vocab.json + merges.txt, byte table,
pre-tokenisation and merges) with RoBERTa's special tokens, <s> (BOS, CLS),
</s> (EOS, SEP), <pad>, <unk> and <mask>. A sequence is encoded as
`<s> A </s>`, a pair as `<s> A </s></s> B </s>`, every token type 0. A
special token written literally inside the text is tokenised as text.
"""

from easynlp_tpu_torch.modelzoo.models.gpt2.tokenization_gpt2 import (
    GPT2Tokenizer,
)


class RobertaTokenizer(GPT2Tokenizer):
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
