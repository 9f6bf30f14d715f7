"""Text-to-image predictor for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2image_generation/predictor.py:
prompts are tokenised to udp text_len (default --sequence_length) tokens,
image codes are sampled (top-k, udp top_k (100) and temperature (1.0);
top_k=1 is greedy) and decoded by the VQGAN, and each row's
max_generated_num images (udp, default 1) come out as base64 PNGs joined
by "\\x02" in `gen_imgbase64` (also `predictions`). Sampling draws from the
predictor's own torch.Generator seeded with udp seed (default 0), on the
app's device: the JAX package's jax.random stream differs (ROADMAP
reference fault 4), so sampled images are comparable within the port
only. Batches are not padded to a fixed shape (the JAX predictor pads the
last one for its static shapes; a padded row would draw from the stream
here).
"""

import numpy as np
import torch

from easynlp_tpu_torch.core.predictor import Predictor
from easynlp_tpu_torch.data.image_utils import encode_image_base64_png
from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for


class TextImageGenerationPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence="text",
                 second_sequence=None, sequence_length=32, batch_size=8,
                 user_defined_parameters=None, **_):
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer_for(model_dir)
        self.app = app
        self.text_col = first_sequence or "text"
        self.text_len = int(udp.get("text_len", sequence_length or 32))
        self.top_k = int(udp.get("top_k", 100))
        self.temperature = float(udp.get("temperature", 1.0))
        self.max_generated_num = int(udp.get("max_generated_num", 1))
        self.batch_size = batch_size
        self.generator = torch.Generator(device=app.device).manual_seed(
            int(udp.get("seed", 0)))
        self.batch_seconds = []

    def preprocess(self, in_data):
        enc = self.tokenizer([str(t) for t in in_data[self.text_col]],
                             max_length=self.text_len)
        out = dict(in_data)
        out["input_ids"] = np.asarray(enc["input_ids"], np.int32)
        out["attention_mask"] = np.asarray(enc["attention_mask"], np.int32)
        return out

    def predict(self, in_data):
        import time
        ids = in_data["input_ids"]
        mask = in_data["attention_mask"]
        images = [[] for _ in range(self.max_generated_num)]
        for start in range(0, len(ids), self.batch_size):
            sl = slice(start, start + self.batch_size)
            for g in range(self.max_generated_num):
                t0 = time.perf_counter()
                codes = self.app.generate(
                    ids[sl], mask[sl], do_sample=True, top_k=self.top_k,
                    temperature=self.temperature, generator=self.generator)
                pixels = self.app.decode_images(codes).float().cpu().numpy()
                self.batch_seconds.append(time.perf_counter() - t0)
                images[g].extend(list(pixels))
        result = dict(in_data)
        result["gen_images"] = images
        return result

    def postprocess(self, result):
        result = dict(result)
        images = result.pop("gen_images")
        b64 = ["\x02".join(encode_image_base64_png(images[g][i])
                           for g in range(len(images)))
               for i in range(len(images[0]))]
        result["gen_imgbase64"] = b64
        result["predictions"] = b64
        return result
