"""Sequence labeling predictor for the PyTorch port (counterpart of
easynlp_tpu/appzoo/sequence_labeling/predictor.py): each row's tokens
(split as the dataset splits them) are WordPiece-tokenised, whole tokens
only up to the sequence length; the predicted id at each token's first
piece is read back through label_mapping.json, and `predictions` is the
space-joined tags."""

import json
import os

import numpy as np

from easynlp_tpu_torch.appzoo.sequence_labeling.data import split_tokens
from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
from easynlp_tpu_torch.utils.io_utils import io


class SequenceLabelingPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 sequence_length=128, batch_size=32, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.first_sequence = first_sequence
        self.sequence_length = sequence_length
        label_path = os.path.join(model_dir, "label_mapping.json")
        if io.exists(label_path):
            with io.open(label_path) as f:
                mapping = json.load(f)
        else:
            mapping = app.label_mapping or {}
        self.id_to_label = {int(v): k for k, v in mapping.items()}
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[("input_ids", np.int32), ("attention_mask", np.int32),
                        ("token_type_ids", np.int32)],
            output_keys=["predictions"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        tok = self.tokenizer
        max_len = self.sequence_length
        all_ids, all_mask, first_positions = [], [], []
        for text in in_data[self.first_sequence]:
            ids, firsts = [tok.cls_token_id], []
            for token in split_tokens(str(text)):
                pieces = tok.tokenize(token) or [tok.unk_token]
                piece_ids = tok.convert_tokens_to_ids(pieces)
                if len(ids) + len(piece_ids) >= max_len - 1:
                    break
                firsts.append(len(ids))
                ids.extend(piece_ids)
            ids.append(tok.sep_token_id)
            pad = max_len - len(ids)
            all_ids.append(ids + [tok.pad_token_id] * pad)
            all_mask.append([1] * len(ids) + [0] * pad)
            first_positions.append(firsts)
        out = dict(in_data)
        out["input_ids"] = np.asarray(all_ids, np.int32)
        out["attention_mask"] = np.asarray(all_mask, np.int32)
        out["token_type_ids"] = np.zeros_like(out["input_ids"])
        out["_first_positions"] = first_positions
        return out

    def predict(self, in_data):
        firsts = in_data.pop("_first_positions")
        result = self.model_predictor.predict(in_data)
        result["_first_positions"] = firsts
        return result

    def postprocess(self, result):
        preds = np.asarray(result["predictions"])
        tags = [" ".join(self.id_to_label.get(int(row[pos]), "O")
                         for pos in firsts)
                for row, firsts in zip(preds, result["_first_positions"])]
        out = {k: v for k, v in result.items() if not k.startswith("_")}
        out["predictions"] = tags
        return out
