"""MLM data augmentation for the PyTorch port (counterpart of
easynlp_tpu/appzoo/data_augmentation/predictor.py; predict only).

Each input row is repeated `augment_count` times; in every copy each real,
non-special token is masked with probability `mask_proportion`, drawn from
the predictor's own RandomState(seed) over the whole slice, and the masked
tokens are refilled with the MLM head's argmax (taken on the device). The
copies are decoded with the WordPiece tokenizer, as the JAX predictor
does, and written tab-joined into `predictions` and `augmented`.
"""

import numpy as np

from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer


class _ArgmaxApp:
    """An MLM app whose forward gives the argmax of its logits, so that
    only token ids leave the device."""

    def __init__(self, app):
        self.app = app
        self.device = app.device

    def forward(self, batch):
        return {"predicted_ids": self.app.forward(batch)["logits"].argmax(-1)}


class DataAugmentationPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence=None,
                 sequence_length=128, batch_size=32,
                 augment_count=2, mask_proportion=0.15, seed=0, **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.first_sequence = first_sequence
        self.sequence_length = sequence_length
        self.augment_count = int(augment_count)
        self.mask_proportion = float(mask_proportion)
        self.rng = np.random.RandomState(seed)
        self.model_predictor = PyModelPredictor(
            _ArgmaxApp(app),
            input_keys=[("input_ids", np.int32), ("attention_mask", np.int32),
                        ("token_type_ids", np.int32)],
            output_keys=["predicted_ids"],
            batch_size=batch_size)

    def preprocess(self, in_data):
        texts = [str(t) for t in in_data[self.first_sequence]]
        enc = self.tokenizer(texts, max_length=self.sequence_length)
        ids = np.asarray(enc["input_ids"], np.int32)
        mask = np.asarray(enc["attention_mask"], np.int32)
        rep_ids = np.repeat(ids, self.augment_count, axis=0)
        rep_mask = np.repeat(mask, self.augment_count, axis=0)
        special = np.isin(rep_ids, np.asarray(self.tokenizer.all_special_ids))
        maskable = (rep_mask == 1) & ~special
        chosen = maskable & (self.rng.rand(*rep_ids.shape)
                             < self.mask_proportion)
        out = dict(in_data)
        out["input_ids"] = np.where(chosen, self.tokenizer.mask_token_id,
                                    rep_ids)
        out["attention_mask"] = rep_mask
        out["token_type_ids"] = np.zeros_like(rep_ids)
        out["_chosen"] = chosen
        out["_orig_ids"] = rep_ids
        return out

    def predict(self, in_data):
        chosen = in_data.pop("_chosen")
        orig = in_data.pop("_orig_ids")
        result = self.model_predictor.predict(in_data)
        result["_chosen"] = chosen
        result["_orig_ids"] = orig
        return result

    def postprocess(self, result):
        sampled = np.asarray(result["predicted_ids"]).astype(np.int32)
        new_ids = np.where(result["_chosen"], sampled, result["_orig_ids"])
        texts = [self.tokenizer.decode(row) for row in new_ids]
        k = self.augment_count
        grouped = ["\t".join(texts[i * k:(i + 1) * k])
                   for i in range(len(texts) // k)]
        out = {key: v for key, v in result.items()
               if not key.startswith("_") and key != "predicted_ids"}
        out["predictions"] = grouped
        out["augmented"] = grouped
        return out
