"""Few-shot PET dataset for the PyTorch port (counterpart of
easynlp_tpu/fewshot_learning/fewshot_dataset.py): a `pattern` turns each
classification row into a cloze ("{sent1},{mask}" by default; {sent2} for
pairs), and the verbalizer (`label_desc`, one word a class, in label
order; the label names by default) maps each class to the first token id
of its word. Each example carries `mask_positions`, the index of [MASK],
and `verbalizer_ids`, the class token ids."""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset, get_label_mapping


def cloze_ids(tok, parts, max_len):
    """[CLS] left [MASK] right [SEP] of the pattern's two halves, cut to
    max_len as the JAX dataset cuts them; (ids, mask position)."""
    left = tok.convert_tokens_to_ids(tok.tokenize(parts[0]))
    right = tok.convert_tokens_to_ids(tok.tokenize(parts[1])) \
        if len(parts) > 1 else []
    budget = max_len - 3  # CLS, MASK, SEP
    if len(left) + len(right) > budget:
        left = left[:budget - len(right)] if len(right) < budget \
            else left[:budget // 2]
        right = right[:budget - len(left)]
    ids = [tok.cls_token_id] + left + [tok.mask_token_id] + right \
        + [tok.sep_token_id]
    return ids, 1 + len(left)


def verbalizer_ids(tok, words):
    """The first token id of each class word."""
    return np.asarray([tok.convert_tokens_to_ids(
        tok.tokenize(w) or [tok.unk_token])[0] for w in words], np.int32)


class FewshotDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None, second_sequence=None,
                 label_name=None, label_enumerate_values=None, pattern=None,
                 label_desc=None, user_defined_parameters=None, **kwargs):
        kwargs.pop("multi_label", None)
        udp = user_defined_parameters or {}
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence
        self.second_sequence = second_sequence
        self.label_name = label_name
        self.pattern = pattern or udp.get("pattern") or "{sent1},{mask}"
        label_desc = label_desc or udp.get("label_desc")
        if label_enumerate_values is None:
            values = sorted({str(self.parse_row(r).get(label_name, ""))
                             for r in self.rows})
        else:
            values = (label_enumerate_values.split(",")
                      if isinstance(label_enumerate_values, str)
                      else list(label_enumerate_values))
        self._label_values = values
        self.label_mapping = get_label_mapping(values)
        self.verbalizer_ids = verbalizer_ids(
            tokenizer, label_desc.split(",") if label_desc else values)
        self._build_features()

    @property
    def label_enumerate_values(self):
        return self._label_values

    def _apply_pattern(self, r):
        text = self.pattern.replace("{sent1}",
                                    str(r.get(self.first_sequence, "")))
        if self.second_sequence:
            text = text.replace("{sent2}",
                                str(r.get(self.second_sequence, "")))
        return text.split("{mask}")

    def _build_features(self):
        tok = self.tokenizer
        max_len = self.max_seq_length
        feats = {"input_ids": [], "attention_mask": [], "token_type_ids": [],
                 "mask_positions": [], "label_ids": []}
        for row in self.rows:
            r = self.parse_row(row)
            ids, mask_pos = cloze_ids(tok, self._apply_pattern(r), max_len)
            feats["input_ids"].append(
                ids + [tok.pad_token_id] * (max_len - len(ids)))
            feats["attention_mask"].append(
                [1] * len(ids) + [0] * (max_len - len(ids)))
            feats["token_type_ids"].append([0] * max_len)
            feats["mask_positions"].append(mask_pos)
            feats["label_ids"].append(self.label_mapping.get(
                str(r.get(self.label_name, "")), 0))
        self.features = {k: np.asarray(v, np.int32) for k, v in feats.items()}
        self.features["verbalizer_ids"] = np.broadcast_to(
            self.verbalizer_ids, (len(self.rows),) + self.verbalizer_ids.shape
        ).copy()

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}
