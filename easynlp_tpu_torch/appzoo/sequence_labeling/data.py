"""Sequence labeling dataset for the PyTorch port (its own copy of
easynlp_tpu/appzoo/sequence_labeling/data.py).

A row holds a content column and a space-separated label column, one label
per source token. The tokens are the content split on spaces, or its
characters where it has no space (Chinese). Each token is WordPiece-
tokenised; its first piece carries its label and the continuation pieces
-100, as do [CLS], [SEP] and the padding. The label set is sorted from the
data unless label_enumerate_values gives it.
"""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset, get_label_mapping

IGNORE = -100


def split_tokens(content):
    """The source tokens of a content string: space-separated words, or its
    characters where it holds no space."""
    return content.split(" ") if " " in content else list(content)


class SequenceLabelingDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None, label_name=None,
                 label_enumerate_values=None, **kwargs):
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence
        self.label_name = label_name
        if label_enumerate_values is None:
            values = set()
            for row in self.rows:
                r = self.parse_row(row)
                values.update(str(r.get(label_name, "")).split(" "))
            self._label_values = sorted(v for v in values if v)
        else:
            self._label_values = (label_enumerate_values.split(",")
                                  if isinstance(label_enumerate_values, str)
                                  else list(label_enumerate_values))
        self.label_mapping = get_label_mapping(self._label_values)
        self._build_features()

    @property
    def label_enumerate_values(self):
        return self._label_values

    def _encode_one(self, tokens, labels):
        tok = self.tokenizer
        max_len = self.max_seq_length
        ids = [tok.cls_token_id]
        label_ids = [IGNORE]
        for token, label in zip(tokens, labels):
            pieces = tok.tokenize(token) or [tok.unk_token]
            lid = self.label_mapping.get(label, IGNORE)
            for j, pid in enumerate(tok.convert_tokens_to_ids(pieces)):
                if len(ids) >= max_len - 1:
                    break
                ids.append(pid)
                label_ids.append(lid if j == 0 else IGNORE)
        ids.append(tok.sep_token_id)
        label_ids.append(IGNORE)
        pad = max_len - len(ids)
        mask = [1] * len(ids) + [0] * pad
        return (ids + [tok.pad_token_id] * pad, label_ids + [IGNORE] * pad,
                mask)

    def _build_features(self):
        all_ids, all_labels, all_mask = [], [], []
        for row in self.rows:
            r = self.parse_row(row)
            tokens = split_tokens(str(r.get(self.first_sequence, "")))
            labels = (str(r.get(self.label_name, "")).split(" ")
                      if self.label_name else ["O"] * len(tokens))
            ids, label_ids, mask = self._encode_one(tokens, labels)
            all_ids.append(ids)
            all_labels.append(label_ids)
            all_mask.append(mask)
        ids = np.asarray(all_ids, np.int32)
        self.features = {
            "input_ids": ids,
            "attention_mask": np.asarray(all_mask, np.int32),
            "token_type_ids": np.zeros_like(ids),
            "label_ids": np.asarray(all_labels, np.int32),
        }

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}
