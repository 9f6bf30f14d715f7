"""Machine reading comprehension dataset for the PyTorch port (its own copy
of easynlp_tpu/appzoo/machine_reading_comprehension/data.py).

Rows hold a question, a context and an answer text. Each is encoded as
`[CLS] question [SEP] context [SEP]`, the context cut to
max_seq_length - 3 - len(question) tokens, token types 0 then 1. The answer
span is the first place where the answer's tokens appear among the
context's (token match); where they do not, the span is [CLS]'s (0, 0).
"""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset


def encode_pair(tok, question, context, max_len):
    """(question ids, context ids cut to fit, input ids, token types) of
    `[CLS] question [SEP] context [SEP]`, unpadded."""
    q_ids = tok.convert_tokens_to_ids(tok.tokenize(question))
    c_ids = tok.convert_tokens_to_ids(tok.tokenize(context))
    c_ids = c_ids[:max(max_len - 3 - len(q_ids), 0)]
    ids = [tok.cls_token_id] + q_ids + [tok.sep_token_id] + c_ids \
        + [tok.sep_token_id]
    types = [0] * (len(q_ids) + 2) + [1] * (len(c_ids) + 1)
    return q_ids, c_ids, ids, types


def find_span(context_ids, answer_ids):
    """Start of the first occurrence of answer_ids in context_ids, or -1."""
    n, m = len(context_ids), len(answer_ids)
    if m == 0 or m > n:
        return -1
    for i in range(n - m + 1):
        if context_ids[i:i + m] == answer_ids:
            return i
    return -1


class MRCDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=384,
                 input_schema=None, first_sequence="question",
                 second_sequence="context", label_name="answer",
                 answer_name=None, qas_id_name="qas_id", **kwargs):
        kwargs.pop("label_enumerate_values", None)
        kwargs.pop("multi_label", None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.question_col = first_sequence
        self.context_col = second_sequence
        self.answer_col = answer_name or label_name
        self.qas_id_name = qas_id_name
        self._build_features()

    def _build_features(self):
        tok = self.tokenizer
        max_len = self.max_seq_length
        feats = {"input_ids": [], "attention_mask": [], "token_type_ids": [],
                 "start_positions": [], "end_positions": []}
        for row in self.rows:
            r = self.parse_row(row)
            answer = str(r.get(self.answer_col, ""))
            q_ids, c_ids, ids, types = encode_pair(
                tok, str(r.get(self.question_col, "")),
                str(r.get(self.context_col, "")), max_len)
            a_ids = (tok.convert_tokens_to_ids(tok.tokenize(answer))
                     if answer else [])
            span = find_span(c_ids, a_ids)
            if span >= 0:
                start = len(q_ids) + 2 + span
                end = start + len(a_ids) - 1
            else:
                start = end = 0
            pad = max_len - len(ids)
            feats["input_ids"].append(ids + [tok.pad_token_id] * pad)
            feats["attention_mask"].append([1] * len(ids) + [0] * pad)
            feats["token_type_ids"].append(types + [0] * pad)
            feats["start_positions"].append(start)
            feats["end_positions"].append(end)
        self.features = {k: np.asarray(v, np.int32) for k, v in feats.items()}

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}
