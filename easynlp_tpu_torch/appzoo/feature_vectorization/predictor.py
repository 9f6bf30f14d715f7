"""Vectorization predictor for the PyTorch port (counterpart of
easynlp_tpu/appzoo/feature_vectorization/predictor.py): text -> its
embedding as space-separated "%.8f" values, in both `predictions` and
`embeddings`."""

import numpy as np

from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer


class FeatureVectorizationPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 sequence_length=128, batch_size=32, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.first_sequence = first_sequence
        self.sequence_length = sequence_length
        self.model_predictor = PyModelPredictor(
            app,
            input_keys=[("input_ids", np.int32), ("attention_mask", np.int32),
                        ("token_type_ids", np.int32)],
            output_keys=["embeddings"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        enc = self.tokenizer([str(t) for t in in_data[self.first_sequence]],
                             max_length=self.sequence_length)
        out = dict(in_data)
        out.update({k: np.asarray(v, np.int32) for k, v in enc.items()})
        return out

    def predict(self, in_data):
        return self.model_predictor.predict(in_data)

    def postprocess(self, result):
        result = dict(result)
        text = [" ".join("%.8f" % x for x in e)
                for e in np.asarray(result["embeddings"])]
        result["predictions"] = result["embeddings"] = text
        return result
