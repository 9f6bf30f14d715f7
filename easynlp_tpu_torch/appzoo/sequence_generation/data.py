"""Seq2seq generation dataset for the PyTorch port: the port's own copy of
easynlp_tpu/appzoo/sequence_generation/data.py, giving the same features.

Source text (first_sequence) and target text (second_sequence or
label_name) columns. The sources are tokenised once to max_seq_length
(padded); each target to at most max_target_length - 1 tokens plus EOS, with
teacher forcing: decoder_input_ids = [decoder_start_token_id] + target[:-1],
labels = target with -100 on the padding, decoder_attention_mask 1 on the
real positions.

EOS is the tokenizer's eos_token_id, else its sep_token_id, else none. A
BART checkpoint whose vocabulary holds BART's own specials gets the BART
tokenizer (</s> and <pad>; modelzoo/models/auto.py); any other gets the
GPT-2 tokenizer, as in the JAX package, whose EOS and pad token is
"<|endoftext|>". Where the tokenizer's pad token is missing from the
vocabulary its id is None: the JAX dataset fails while padding, the port
raises a ValueError that names the token. Both start the targets' decoder
inputs with decoder_start_token_id 0 while generation starts from the
config's (2 for BART): the JAX package's mismatch, kept (ROADMAP C11).
"""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset

IGNORE = -100


class SequenceGenerationDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 max_target_length=64, input_schema=None, first_sequence=None,
                 second_sequence=None, label_name=None,
                 decoder_start_token_id=0, **kwargs):
        for k in ("label_enumerate_values", "multi_label"):
            kwargs.pop(k, None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        if tokenizer.pad_token_id is None:
            raise ValueError(
                "the tokenizer's pad token %r is not in its vocabulary, so "
                "sources cannot be padded" % tokenizer.pad_token)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.max_target_length = max_target_length
        self.src_col = first_sequence
        self.tgt_col = second_sequence or label_name
        self.decoder_start_token_id = decoder_start_token_id
        self._build_features()

    def _build_features(self):
        tok = self.tokenizer
        srcs, tgts = [], []
        for row in self.rows:
            r = self.parse_row(row)
            srcs.append(str(r.get(self.src_col, "")))
            tgts.append(str(r.get(self.tgt_col, "")) if self.tgt_col else "")
        enc = tok(srcs, max_length=self.max_seq_length)
        self.features = {
            "input_ids": np.asarray(enc["input_ids"], np.int32),
            "attention_mask": np.asarray(enc["attention_mask"], np.int32),
        }
        if self.tgt_col:
            t = self.max_target_length
            dec_in = np.full((len(tgts), t), tok.pad_token_id, np.int32)
            labels = np.full((len(tgts), t), IGNORE, np.int32)
            dec_mask = np.zeros((len(tgts), t), np.int32)
            eos = tok.eos_token_id if tok.eos_token_id is not None \
                else tok.sep_token_id
            for i, tgt in enumerate(tgts):
                ids = tok.convert_tokens_to_ids(tok.tokenize(tgt))[:t - 1]
                ids = ids + ([eos] if eos is not None else [])
                shifted = [self.decoder_start_token_id] + ids[:-1]
                n = len(ids)
                dec_in[i, :n] = shifted[:n]
                labels[i, :n] = ids
                dec_mask[i, :n] = 1
            self.features["decoder_input_ids"] = dec_in
            self.features["decoder_attention_mask"] = dec_mask
            self.features["labels"] = labels

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}
