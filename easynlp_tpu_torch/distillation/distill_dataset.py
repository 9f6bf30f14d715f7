"""Distillation dataset for the PyTorch port (counterpart of
easynlp_tpu/distillation/distill_dataset.py): the classification rows, with
a saved teacher-logits file joined row by row into `teacher_logits`, on the
training table only (user_defined_parameters logits_saved_path: one row of
space-separated floats a line, as --mode=predict's `logits` column writes
them, or a .npy array)."""

import numpy as np

from easynlp_tpu_torch.appzoo.sequence_classification.data import (
    ClassificationDataset,
)
from easynlp_tpu_torch.utils.io_utils import io


class DistillatoryClassificationDataset(ClassificationDataset):
    def __init__(self, data_file, tokenizer, logits_saved_path=None,
                 logits_name=None, is_training=False, **kwargs):
        udp = kwargs.pop("user_defined_parameters", None) or {}
        logits_saved_path = logits_saved_path or udp.get("logits_saved_path")
        super().__init__(data_file, tokenizer, **kwargs)
        if logits_saved_path and is_training:
            self._join_teacher_logits(logits_saved_path)

    def _join_teacher_logits(self, path):
        if str(path).endswith(".npy"):
            logits = np.load(path)
        else:
            with io.open(path) as f:
                logits = np.asarray([[float(x) for x in line.split()]
                                     for line in f if line.strip()],
                                    np.float32)
        if len(logits) != len(self.rows):
            raise ValueError("teacher logits rows (%d) != dataset rows (%d)"
                             % (len(logits), len(self.rows)))
        self.features["teacher_logits"] = logits.astype(np.float32)
