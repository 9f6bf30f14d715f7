"""Classification dataset for the PyTorch port (its own copy of
easynlp_tpu/appzoo/sequence_classification/data.py): single or pair sentence
rows, the label mapping from label_enumerate_values, the whole table
tokenised once into fixed-shape int32 arrays."""

import numpy as np

from easynlp_tpu_torch.data.dataset import BaseDataset, get_label_mapping


class ClassificationDataset(BaseDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None, second_sequence=None,
                 label_name=None, label_enumerate_values=None, multi_label=False,
                 **kwargs):
        super().__init__(data_file, input_schema=input_schema, **kwargs)
        self.tokenizer = tokenizer
        self.max_seq_length = max_seq_length
        self.first_sequence = first_sequence
        self.second_sequence = second_sequence
        self.label_name = label_name
        self.multi_label = multi_label
        if label_enumerate_values is None:
            self._label_values = self._infer_labels()
        else:
            self._label_values = (label_enumerate_values.split(",")
                                  if isinstance(label_enumerate_values, str)
                                  else list(label_enumerate_values))
        self.label_mapping = get_label_mapping(self._label_values)
        self._build_features()

    def _infer_labels(self):
        if not self.label_name:
            return []
        values = sorted({str(self.parse_row(r).get(self.label_name, ""))
                         for r in self.rows})
        if self.multi_label:
            flat = sorted({v for vs in values for v in vs.split(" ") if v})
            return flat
        return values

    @property
    def label_enumerate_values(self):
        return self._label_values

    def _build_features(self):
        texts_a, texts_b, labels = [], [], []
        for row in self.rows:
            r = self.parse_row(row)
            texts_a.append(str(r.get(self.first_sequence, "")))
            if self.second_sequence:
                texts_b.append(str(r.get(self.second_sequence, "")))
            labels.append(str(r.get(self.label_name, "")) if self.label_name
                          else None)
        enc = self.tokenizer(texts_a, texts_b if texts_b else None,
                             max_length=self.max_seq_length)
        self.features = {k: np.asarray(v, np.int32) for k, v in enc.items()}
        if self.label_name and self.label_mapping:
            if self.multi_label:
                mat = np.zeros((len(labels), len(self.label_mapping)), np.int32)
                for i, lab in enumerate(labels):
                    for part in (lab or "").split(" "):
                        if part in self.label_mapping:
                            mat[i, self.label_mapping[part]] = 1
                self.features["label_ids"] = mat
            else:
                self.features["label_ids"] = np.asarray(
                    [self.label_mapping.get(l, 0) for l in labels], np.int32)

    def __getitem__(self, idx):
        return {k: v[idx] for k, v in self.features.items()}
