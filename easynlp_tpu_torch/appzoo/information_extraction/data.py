"""Information extraction dataset for the PyTorch port (its own copy of
easynlp_tpu/appzoo/information_extraction/data.py): rows of text and
`start,end,type;...` character-span annotations. The text is tokenised
character by character, so token i + 1 is character i ([CLS] first), and
each row's spans become a [T, S, S] int8 indicator over (start, end)
token pairs."""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset, get_label_mapping


class InformationExtractionDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence="content",
                 label_name="entities", label_enumerate_values=None,
                 **kwargs):
        kwargs.pop("multi_label", None)
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence
        self.label_name = label_name
        if label_enumerate_values is None:
            types = {ann[2] for row in self.rows
                     for ann in self._annotations(self.parse_row(row))}
            self._label_values = sorted(types) or ["ENT"]
        else:
            self._label_values = (label_enumerate_values.split(",")
                                  if isinstance(label_enumerate_values, str)
                                  else list(label_enumerate_values))
        self.label_mapping = get_label_mapping(self._label_values)
        self._build_features()

    @property
    def label_enumerate_values(self):
        return self._label_values

    def _annotations(self, r):
        """[(start, end, type), ...] of a parsed row's annotation column;
        parts with fewer than three fields are skipped."""
        out = []
        for part in str(r.get(self.label_name, "") or "").split(";"):
            bits = part.split(",")
            if len(bits) >= 3:
                out.append((int(bits[0]), int(bits[1]), bits[2]))
        return out

    def _build_features(self):
        max_len = self.max_seq_length
        n = len(self.rows)
        ids = np.full((n, max_len), self.tokenizer.pad_token_id, np.int32)
        mask = np.zeros((n, max_len), np.int32)
        labels = np.zeros((n, len(self._label_values), max_len, max_len),
                          np.int8)
        for i, row in enumerate(self.rows):
            r = self.parse_row(row)
            row_ids = encode_chars(self.tokenizer,
                                   str(r.get(self.first_sequence, "")),
                                   max_len)
            ids[i, :len(row_ids)] = row_ids
            mask[i, :len(row_ids)] = 1
            for start, end, etype in self._annotations(r):
                t = self.label_mapping.get(etype)
                s_pos, e_pos = start + 1, end + 1  # the [CLS] shift
                if t is not None and e_pos < max_len - 1 and s_pos <= e_pos:
                    labels[i, t, s_pos, e_pos] = 1
        self.features = {"input_ids": ids, "attention_mask": mask,
                         "token_type_ids": np.zeros_like(ids),
                         "span_labels": labels}

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}


def encode_chars(tokenizer, text, max_len):
    """[CLS] + one id per character of text (cut to max_len - 2) + [SEP]."""
    return ([tokenizer.cls_token_id]
            + tokenizer.convert_tokens_to_ids(list(text)[:max_len - 2])
            + [tokenizer.sep_token_id])
