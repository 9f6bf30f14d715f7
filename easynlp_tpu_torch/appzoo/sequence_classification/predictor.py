"""Classification predictor for the PyTorch port (counterpart of
easynlp_tpu/appzoo/sequence_classification/predictor.py: tokenise, forward,
label names and %.6f-formatted probabilities and logits).

Multi-label (multi_label=True) predicts every label whose logit is above 0,
as the evaluator scores them, and the argmax label where none is; its
`probabilities` column holds the per-label sigmoids. The JAX predictor
thresholds the softmax at 0.5 (easynlp_tpu sequence_classification/
predictor.py:55-59), so it never predicts two labels (ROADMAP C18)."""

import json
import os

import numpy as np

from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer
from easynlp_tpu_torch.utils.io_utils import io


class SequenceClassificationPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 second_sequence=None, sequence_length=128, batch_size=32,
                 multi_label=False, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.multi_label = multi_label
        self.first_sequence = first_sequence
        self.second_sequence = second_sequence
        self.sequence_length = sequence_length
        label_path = os.path.join(model_dir, "label_mapping.json")
        if io.exists(label_path):
            with io.open(label_path) as f:
                label_mapping = json.load(f)
        else:
            label_mapping = app.label_mapping or {}
        self.id_to_label = {int(v): k for k, v in label_mapping.items()}
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[("input_ids", np.int32),
                        ("attention_mask", np.int32),
                        ("token_type_ids", np.int32)],
            output_keys=["logits", "probabilities", "predictions"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        texts_a = [str(t) for t in in_data[self.first_sequence]]
        texts_b = None
        if self.second_sequence and self.second_sequence in in_data:
            texts_b = [str(t) for t in in_data[self.second_sequence]]
        enc = self.tokenizer(texts_a, texts_b, max_length=self.sequence_length)
        out = dict(in_data)
        out.update({k: np.asarray(v, np.int32) for k, v in enc.items()})
        return out

    def predict(self, in_data):
        return self.model_predictor.predict(in_data)

    def _name(self, index):
        return self.id_to_label.get(int(index), str(int(index)))

    def postprocess(self, result):
        probs = np.asarray(result["probabilities"])
        logits = np.asarray(result["logits"])
        if self.multi_label:
            probs = 1.0 / (1.0 + np.exp(-logits.astype(np.float64)))
            preds = [" ".join(self._name(j) for j in np.nonzero(row > 0)[0])
                     or self._name(row.argmax()) for row in logits]
        else:
            preds = [self._name(p.argmax()) for p in probs]
        result = dict(result)
        result["predictions"] = preds
        result["probabilities"] = [" ".join("%.6f" % x for x in p)
                                   for p in probs]
        result["logits"] = [" ".join("%.6f" % x for x in row)
                            for row in logits]
        return result
