"""Sentence-embedding extraction for the PyTorch port (counterpart of
easynlp_tpu/appzoo/feature_vectorization/model.py; app name
`vectorization`): the two-tower module's encoder on one side, returning the
L2-normalised `embeddings`. Predict-only."""

from easynlp_tpu_torch.appzoo.text_match.model import TextMatchTwoTower


class FeatureVectorization(TextMatchTwoTower):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids")

    @staticmethod
    def loss_fn(outputs, batch):
        raise NotImplementedError("vectorization is a predict-only app")
