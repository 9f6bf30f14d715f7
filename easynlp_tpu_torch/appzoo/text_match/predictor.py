"""Text match predictors for the PyTorch port (counterpart of
easynlp_tpu/appzoo/text_match/predictor.py): the cross-encoder writes
classification's columns; the two-tower predictor encodes each side alone
and writes `similarity` ("%.6f"), `predictions` (1 where the similarity
exceeds 0.5, else 0) and the two embeddings."""

import numpy as np

from easynlp_tpu_torch.appzoo.sequence_classification.predictor import (
    SequenceClassificationPredictor,
)
from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer


class TextMatchPredictor(SequenceClassificationPredictor):
    pass


class TextMatchTwoTowerPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 second_sequence=None, sequence_length=128, batch_size=32,
                 **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.first_sequence = first_sequence
        self.second_sequence = second_sequence
        self.sequence_length = sequence_length
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[(k + side, np.int32) for side in ("", "_b")
                        for k in ("input_ids", "attention_mask",
                                  "token_type_ids")],
            output_keys=["similarity", "embeddings", "embeddings_b"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        out = dict(in_data)
        for side, col in (("", self.first_sequence),
                          ("_b", self.second_sequence)):
            enc = self.tokenizer([str(t) for t in in_data[col]],
                                 max_length=self.sequence_length)
            out.update({k + side: np.asarray(v, np.int32)
                        for k, v in enc.items()})
        return out

    def predict(self, in_data):
        return self.model_predictor.predict(in_data)

    def postprocess(self, result):
        result = dict(result)
        sims = np.asarray(result["similarity"])
        result["predictions"] = [int(s > 0.5) for s in sims]
        result["similarity"] = ["%.6f" % s for s in sims]
        return result
