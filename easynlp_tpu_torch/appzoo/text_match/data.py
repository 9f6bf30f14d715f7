"""Text match datasets for the PyTorch port (its own copy of
easynlp_tpu/appzoo/text_match/data.py): the cross-encoder featurises a pair
as pair classification does; the two-tower (and siamese) variant encodes the
two sequences separately, the second under `*_b` keys."""

import numpy as np

from easynlp_tpu_torch.appzoo.sequence_classification.data import (
    ClassificationDataset,
)


class TextMatchDataset(ClassificationDataset):
    """Cross-encoder: the features of pair classification."""


class TwoTowerDataset(ClassificationDataset):
    """first_sequence and second_sequence each tokenised alone; the second
    one's features under input_ids_b, attention_mask_b, token_type_ids_b."""

    def _build_features(self):
        texts_a, texts_b, labels = [], [], []
        for row in self.rows:
            r = self.parse_row(row)
            texts_a.append(str(r.get(self.first_sequence, "")))
            texts_b.append(str(r.get(self.second_sequence, "")))
            labels.append(str(r.get(self.label_name, "")) if self.label_name
                          else None)
        enc_a = self.tokenizer(texts_a, max_length=self.max_seq_length)
        enc_b = self.tokenizer(texts_b, max_length=self.max_seq_length)
        self.features = {k: np.asarray(v, np.int32) for k, v in enc_a.items()}
        self.features.update({k + "_b": np.asarray(v, np.int32)
                              for k, v in enc_b.items()})
        if self.label_name and self.label_mapping:
            self.features["label_ids"] = np.asarray(
                [self.label_mapping.get(l, 0) for l in labels], np.int32)
