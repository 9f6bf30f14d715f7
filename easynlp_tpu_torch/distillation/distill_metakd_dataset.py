"""MetaKD dataset for the PyTorch port (counterpart of
easynlp_tpu/distillation/distill_metakd_dataset.py): classification rows
with a `domain` column and a precomputed `weight` column, featurised with
`domain_ids` (user_defined_parameters domain_label, a comma list; the
default four Amazon-review domains) and `sample_weights`. genre=<domain>
keeps only that domain's rows; skip_first_line drops the header before the
filter runs, so the first data row survives."""

import numpy as np

from easynlp_tpu_torch.appzoo.sequence_classification.data import (
    ClassificationDataset,
)

DEFAULT_DOMAINS = ["books", "dvd", "electronics", "kitchen"]


class MetaKDClassificationDataset(ClassificationDataset):
    def __init__(self, data_file, tokenizer, max_seq_length=128,
                 input_schema=None, first_sequence=None, second_sequence=None,
                 label_name=None, label_enumerate_values=None,
                 user_defined_parameters=None, domain_name="domain",
                 weight_name="weight", **kwargs):
        udp = user_defined_parameters or {}
        self.domain_list = str(udp.get("domain_label",
                                       ",".join(DEFAULT_DOMAINS))).split(",")
        self.domain_idx_mapping = {d: i for i, d in
                                   enumerate(self.domain_list)}
        self.genre = udp.get("genre")
        self._domain_name = domain_name
        self._weight_name = weight_name
        self._skip_first_line = bool(kwargs.pop("skip_first_line", False))
        kwargs.pop("multi_label", None)
        super().__init__(
            data_file, tokenizer, max_seq_length=max_seq_length,
            input_schema=input_schema, first_sequence=first_sequence,
            second_sequence=second_sequence, label_name=label_name,
            label_enumerate_values=label_enumerate_values, **kwargs)

    def read_rows(self, data_file):
        rows = super().read_rows(data_file)
        if self._skip_first_line and len(rows):
            rows = rows[1:]
        if self.genre and self.genre in self.domain_list:
            rows = [row for row in rows
                    if str(self.parse_row(row).get(self._domain_name, ""))
                    == self.genre]
        return rows

    def _build_features(self):
        super()._build_features()
        domains, weights = [], []
        for row in self.rows:
            r = self.parse_row(row)
            domains.append(self.domain_idx_mapping.get(
                str(r.get(self._domain_name, "")), 0))
            try:
                weights.append(float(r.get(self._weight_name, 1.0)))
            except (TypeError, ValueError):
                weights.append(1.0)
        self.features["domain_ids"] = np.asarray(domains, np.int32)
        self.features["sample_weights"] = np.asarray(weights, np.float32)
