"""Few-shot predictor for the PyTorch port (counterpart of
easynlp_tpu/fewshot_learning/fewshot_predictor.py): the pattern applied to
each row, the MLM logits read at [MASK] and gathered at the verbalizer's
token ids into class probabilities. The pattern and label_desc come from
user_defined_parameters, or else from the checkpoint's train_config.json,
where training left them."""

import json
import os

import numpy as np

from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.fewshot_learning.fewshot_dataset import (
    cloze_ids,
    verbalizer_ids,
)
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
from easynlp_tpu_torch.utils.global_vars import parse_user_defined_parameters
from easynlp_tpu_torch.utils.io_utils import io


class FewshotPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 second_sequence=None, sequence_length=128, batch_size=32,
                 user_defined_parameters=None, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.first_sequence = first_sequence
        self.second_sequence = second_sequence
        self.sequence_length = sequence_length
        udp = user_defined_parameters or {}
        saved = {}
        tc = os.path.join(model_dir, "train_config.json")
        if io.exists(tc):
            with io.open(tc) as f:
                saved = parse_user_defined_parameters(
                    json.load(f).get("user_defined_parameters"))
        self.pattern = udp.get("pattern") or saved.get("pattern",
                                                       "{sent1},{mask}")
        label_desc = udp.get("label_desc") or saved.get("label_desc")
        mapping = {}
        label_path = os.path.join(model_dir, "label_mapping.json")
        if io.exists(label_path):
            with io.open(label_path) as f:
                mapping = json.load(f)
        self.labels = [k for k, _ in sorted(mapping.items(),
                                            key=lambda kv: kv[1])]
        self.verbalizer_ids = verbalizer_ids(
            self.tokenizer, label_desc.split(",") if label_desc
            else self.labels)
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[("input_ids", np.int32), ("attention_mask", np.int32),
                        ("token_type_ids", np.int32),
                        ("mask_positions", np.int32),
                        ("verbalizer_ids", np.int32)],
            output_keys=["logits", "probabilities"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        max_len = self.sequence_length
        pad = self.tokenizer.pad_token_id
        ids_all, mask_all, pos_all = [], [], []
        for i, text in enumerate(in_data[self.first_sequence]):
            filled = self.pattern.replace("{sent1}", str(text))
            if self.second_sequence and self.second_sequence in in_data:
                filled = filled.replace(
                    "{sent2}", str(in_data[self.second_sequence][i]))
            ids, pos = cloze_ids(self.tokenizer, filled.split("{mask}"),
                                 max_len)
            pos_all.append(pos)
            mask_all.append([1] * len(ids) + [0] * (max_len - len(ids)))
            ids_all.append(ids + [pad] * (max_len - len(ids)))
        out = dict(in_data)
        out["input_ids"] = np.asarray(ids_all, np.int32)
        out["attention_mask"] = np.asarray(mask_all, np.int32)
        out["token_type_ids"] = np.zeros_like(out["input_ids"])
        out["mask_positions"] = np.asarray(pos_all, np.int32)
        out["verbalizer_ids"] = np.broadcast_to(
            self.verbalizer_ids,
            (len(ids_all),) + self.verbalizer_ids.shape).copy()
        return out

    def predict(self, in_data):
        return self.model_predictor.predict(in_data)

    def postprocess(self, result):
        result = dict(result)
        probs = np.asarray(result["probabilities"], np.float32)
        logits = np.asarray(result["logits"], np.float32)
        result["predictions"] = [
            self.labels[int(p.argmax())] if self.labels
            else str(int(p.argmax())) for p in probs]
        result["probabilities"] = [" ".join("%.6f" % x for x in p)
                                   for p in probs]
        result["logits"] = [" ".join("%.6f" % x for x in row)
                            for row in logits]
        return result
