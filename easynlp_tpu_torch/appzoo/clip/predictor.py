"""CLIP predictor for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/clip/predictor.py: text (and, where
second_sequence names an image column, base64 images) in; the normalised
embeddings out as space-separated "%.8f" strings (`text_embeds`,
`image_embeds`; `predictions` is the text's). Images are decoded,
resized and normalised on the host with the checkpoint's
image_mean/image_std where its vision config sets them, as the device
path normalises uint8 pixels.
"""

import numpy as np

from easynlp_tpu_torch.core.predictor import Predictor, PyModelPredictor
from easynlp_tpu_torch.data.image_utils import preprocess_base64_batch
from easynlp_tpu_torch.modelzoo.models.bert import BertTokenizer


def embedding_strings(result, keys):
    """result with each of `keys` as "%.8f" rows, `predictions` the text's."""
    result = dict(result)
    for key in keys:
        if key in result:
            result[key] = [" ".join("%.8f" % x for x in row)
                           for row in np.asarray(result[key])]
    result["predictions"] = result.get("text_embeds", [])
    return result


class CLIPPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence="text",
                 second_sequence=None, sequence_length=32, batch_size=32,
                 **_):
        self.tokenizer = BertTokenizer.from_pretrained(model_dir)
        self.text_col = first_sequence or "text"
        self.image_col = second_sequence
        self.sequence_length = sequence_length
        vc = app.config.vision_config
        self.image_size = vc.image_size
        self.image_mean = getattr(vc, "image_mean", None)
        self.image_std = getattr(vc, "image_std", None)
        self.app = app
        self.batch_size = batch_size
        keys = [("input_ids", np.int32), ("attention_mask", np.int32),
                ("token_type_ids", np.int32)]
        outs = ["text_embeds"]
        if self.image_col:
            keys.append(("pixel_values", np.float32))
            outs.append("image_embeds")
        self.model_predictor = PyModelPredictor(app, input_keys=keys,
                                                output_keys=outs,
                                                batch_size=batch_size)

    def preprocess(self, in_data):
        out = dict(in_data)
        enc = self.tokenizer([str(t) for t in in_data[self.text_col]],
                             max_length=self.sequence_length)
        out.update({k: np.asarray(v, np.int32) for k, v in enc.items()})
        if self.image_col and self.image_col in in_data:
            out["pixel_values"] = preprocess_base64_batch(
                in_data[self.image_col], self.image_size,
                mean=self.image_mean, std=self.image_std).astype(np.float32)
        return out

    def predict(self, in_data):
        return self.model_predictor.predict(in_data)

    def postprocess(self, result):
        return embedding_strings(result, ("text_embeds", "image_embeds"))
