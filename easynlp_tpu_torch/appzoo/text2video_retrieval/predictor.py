"""Text-video retrieval predictor for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2video_retrieval/predictor.py:
text (and, where second_sequence names a video column, its frames) in;
`text_embeds` and `video_embeds` out as "%.8f" strings, `predictions`
the text's. The frame count is udp max_frames, else frame_num (12).
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.clip.predictor import embedding_strings
from easynlp_tpu_torch.appzoo.text2video_retrieval.data import (
    max_frames_of,
    video_pixels,
)
from easynlp_tpu_torch.core.predictor import Predictor
from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for

_KEYS = ("input_ids", "attention_mask", "token_type_ids", "pixel_values",
         "video_masks")


class Text2VideoRetrievalPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence="text",
                 second_sequence=None, sequence_length=32, batch_size=8,
                 user_defined_parameters=None, **_):
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer_for(model_dir)
        self.app = app
        self.text_col = first_sequence or "text"
        self.video_col = second_sequence
        self.sequence_length = sequence_length
        self.image_size = app.config.vision_config.image_size
        self.max_frames = max_frames_of(udp)
        self.batch_size = batch_size

    def preprocess(self, in_data):
        out = dict(in_data)
        enc = self.tokenizer([str(t) for t in in_data[self.text_col]],
                             max_length=self.sequence_length)
        out.update({k: np.asarray(v, np.int32) for k, v in enc.items()})
        if self.video_col and self.video_col in in_data:
            pixels, masks = zip(*(video_pixels(c, self.max_frames,
                                               self.image_size)
                                  for c in in_data[self.video_col]))
            out["pixel_values"] = np.stack(pixels)
            out["video_masks"] = np.stack(masks)
        return out

    def predict(self, in_data):
        keys = [k for k in _KEYS if k in in_data]
        n, bs = len(in_data["input_ids"]), self.batch_size
        outs = []
        with torch.inference_mode():
            for start in range(0, n, bs):
                batch = {k: torch.from_numpy(np.ascontiguousarray(
                    in_data[k][start:start + bs])).to(self.app.device)
                    for k in keys}
                res = self.app.forward(batch)
                outs.append({k: res[k].float().cpu().numpy() for k in
                             ("text_embeds", "video_embeds") if k in res})
        merged = {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        merged.update(in_data)
        return merged

    def postprocess(self, result):
        return embedding_strings(result, ("text_embeds", "video_embeds"))
