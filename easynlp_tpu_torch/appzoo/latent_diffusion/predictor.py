"""Latent diffusion predictor for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/latent_diffusion/predictor.py: prompts
in, base64 PNGs out (`gen_images`, and `predictions`/`gen_imgbase64`: a
row's n_samples PNGs joined by commas). user_defined_parameters:
n_samples (images per prompt), num_steps, guidance_scale,
negative_prompt, sampler (ddim|plms|dpm++), seed, text_len and
do_upscale. x_T comes from one CPU generator seeded with `seed`, drawn
batch by batch and sample by sample, so the first batch's first images
are the pipeline's for the same seed and prompts. do_upscale=true runs
the model directory's ESRGAN (the JAX package's
flax_params_esrgan.msgpack) 4x over each image; the JAX predictor
documents the knob but never reads it (ROADMAP reference fault 34).
Guidance's unconditioned branch reads the negative prompt, "" where none
is given, tokenized as the prompts are: the pipeline's and the reference
predictor's rule. The JAX predictor passes no negative prompt then, and
its app.sample conditions that branch on an all-PAD prompt (ROADMAP
reference fault 35).
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.latent_diffusion.model import (
    load_esrgan,
    upscale,
)
from easynlp_tpu_torch.core.predictor import Predictor
from easynlp_tpu_torch.data.image_utils import encode_image_base64_png
from easynlp_tpu_torch.modelzoo.models.auto import tokenizer_for


class LDMPredictor(Predictor):
    def __init__(self, model_dir, app, first_sequence="text",
                 second_sequence=None, sequence_length=32, batch_size=4,
                 user_defined_parameters=None, **_):
        udp = user_defined_parameters or {}
        self.tokenizer = tokenizer_for(model_dir)
        self.app = app
        self.text_col = first_sequence or "text"
        self.text_len = int(udp.get("text_len", sequence_length or 32))
        self.num_steps = int(udp.get("num_steps", 50))
        self.guidance_scale = float(udp.get("guidance_scale", 7.5))
        self.method = str(udp.get("sampler", "ddim"))
        self.n_samples = int(udp.get("n_samples", 1))
        self.negative_prompt = udp.get("negative_prompt") or None
        self.batch_size = batch_size
        self.generator = torch.Generator().manual_seed(int(udp.get("seed",
                                                                   0)))
        self.esrgan = None
        if str(udp.get("do_upscale", "")).lower() in ("1", "true"):
            self.esrgan = load_esrgan(model_dir, app.device)
            if self.esrgan is None:
                raise ValueError("do_upscale needs ESRGAN weights in %s"
                                 % model_dir)

    def preprocess(self, in_data):
        texts = [str(t) for t in in_data[self.text_col]]
        enc = self.tokenizer(texts, max_length=self.text_len)
        out = dict(in_data)
        out["input_ids"] = np.asarray(enc["input_ids"], np.int32)
        out["attention_mask"] = np.asarray(enc["attention_mask"], np.int32)
        neg = self.tokenizer([self.negative_prompt or ""] * len(texts),
                             max_length=self.text_len)
        out["negative_input_ids"] = np.asarray(neg["input_ids"], np.int32)
        return out

    def predict(self, in_data):
        ids = in_data["input_ids"]
        mask = in_data["attention_mask"]
        neg = in_data["negative_input_ids"]
        bs = self.batch_size
        images = [[] for _ in range(self.n_samples)]
        for start in range(0, len(ids), bs):
            sl = slice(start, start + bs)
            for g in range(self.n_samples):
                imgs = self.app.sample(
                    ids[sl], mask[sl], num_steps=self.num_steps,
                    guidance_scale=self.guidance_scale,
                    generator=self.generator, method=self.method,
                    negative_input_ids=neg[sl])
                if self.esrgan is not None:
                    imgs = upscale(self.esrgan, imgs)
                images[g].extend(list(imgs.float().cpu().numpy()))
        result = dict(in_data)
        result["gen_images"] = images
        return result

    def postprocess(self, result):
        result = dict(result)
        images = result.pop("gen_images")
        b64 = [",".join(encode_image_base64_png(images[g][i])
                        for g in range(self.n_samples))
               for i in range(len(images[0]))]
        result["predictions"] = b64
        result["gen_imgbase64"] = b64
        return result
