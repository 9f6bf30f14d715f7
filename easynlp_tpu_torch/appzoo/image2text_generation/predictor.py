"""Image-to-text predictor for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/image2text_generation/predictor.py:
base64 images (url-safe; video2text's subclass: frame lists) in, caption
ids generated after the visual prefix from [CLS] until [SEP] (greedy, or
udp num_beams, do_sample with top_k), then decoded with the WordPiece
vocabulary without [CLS], [SEP] and padding: `gen_text` (also
`predictions`) and the ids as text (`generated_ids`). udp: img_size (or
size; default the vision config's), text_len (default
--sequence_length), frame_num (3), seed (sampling).

A VQGAN app (enable_vqgan: a config with no vision tower) takes [-1, 1]
pixels, by default at VQGANImageTextDataset's size, 256. The JAX
predictor defaults to 2 ** (len(vq_channel_mult) - 1) * 4 pixels there
(64 at the f16 widths, so 16 codes where the model trained on 256), a
size its dataset never gives (ROADMAP reference fault 37).
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.image2text_generation.vqgan_model import (
    VQGAN_IMAGE_SIZE,
)
from easynlp_tpu_torch.core.predictor import Predictor
from easynlp_tpu_torch.data.image_utils import (
    decode_base64_image_urlsafe,
    preprocess_image,
    preprocess_image_pm1,
)
from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for


class ImageTextGenerationPredictor(Predictor):
    frame_input = False

    def __init__(self, model_dir, app, first_sequence="imgbase64",
                 second_sequence=None, sequence_length=32, batch_size=8,
                 user_defined_parameters=None, **_):
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer_for(model_dir)
        self.app = app
        self.image_col = first_sequence or "imgbase64"
        # VQGAN-variant apps (no vision tower) take [-1, 1] pixels
        self.pm1 = getattr(app.config, "vision_config", None) is None
        default_size = VQGAN_IMAGE_SIZE if self.pm1 else \
            app.config.vision_config.image_size
        self.image_size = int(udp.get("img_size", udp.get("size",
                                                          default_size)))
        self.text_len = int(udp.get("text_len", sequence_length or 32))
        self.frame_num = int(udp.get("frame_num", 3))
        self.num_beams = int(udp.get("num_beams", 1))
        self.do_sample = bool(int(udp.get("do_sample", 0)))
        self.top_k = int(udp.get("top_k", 0))
        self.batch_size = batch_size
        vocab = getattr(self.tokenizer, "vocab", {})
        self.bos_id = vocab.get("[CLS]", 101)
        self.eos_id = vocab.get("[SEP]", 102)
        self.generator = torch.Generator(device=app.device).manual_seed(
            int(udp.get("seed", 0)))
        self.batch_seconds = []

    def _decode_cell(self, cell):
        if self.frame_input:
            from easynlp_tpu_torch.appzoo.video2text_generation.data import (
                frame_pixels)
            return frame_pixels(cell, self.frame_num, self.image_size)
        pre = preprocess_image_pm1 if self.pm1 else preprocess_image
        return pre(decode_base64_image_urlsafe(cell), self.image_size)

    def preprocess(self, in_data):
        out = dict(in_data)
        out["pixel_values"] = np.stack(
            [self._decode_cell(str(c)) for c in in_data[self.image_col]]
        ).astype(np.float32)
        return out

    def predict(self, in_data):
        import time
        pv = in_data["pixel_values"]
        seqs = []
        for start in range(0, len(pv), self.batch_size):
            t0 = time.perf_counter()
            out = self.app.generate(
                pv[start:start + self.batch_size], max_length=self.text_len,
                bos_token_id=self.bos_id, eos_token_id=self.eos_id,
                num_beams=self.num_beams, do_sample=self.do_sample,
                top_k=self.top_k, generator=self.generator)
            seqs.append(out.cpu().numpy())
            self.batch_seconds.append(time.perf_counter() - t0)
        result = dict(in_data)
        result["generated_ids"] = np.concatenate(seqs)
        result.pop("pixel_values", None)
        return result

    def postprocess(self, result):
        texts = []
        for row in result["generated_ids"]:
            ids = [int(t) for t in row
                   if int(t) not in (self.bos_id, self.eos_id, 0)]
            texts.append(self.tokenizer.decode(ids))
        result["gen_text"] = texts
        result["predictions"] = texts
        result["generated_ids"] = [" ".join(str(int(x)) for x in row)
                                   for row in result["generated_ids"]]
        return result
