"""Text-to-image generation (ARTIST) for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2image_generation/model.py: a GPT
over [text tokens; VQGAN image codes] (modelzoo/models/artist/). Training
is the next-token loss from position text_len - 1 on (the image codes'
predictions) plus the VQ losses and the reconstruction's MSE; sampling
decodes image_token_length codes after the text prompt through
modelzoo/generation_utils.py, the sampling mask keeping only the image
codes (top-k sampling from an explicit torch.Generator, or greedy), then
the VQGAN decodes them to pixels in [-1, 1] [B, H, W, 3].
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.models.artist import ARTISTConfig, ARTISTModel
from easynlp_tpu_torch.modelzoo.models.artist.modeling_artist import (
    state_dict_from_jax,
)
from easynlp_tpu_torch.utils import losses


def _tensor(x, device, dtype=None):
    t = x if torch.is_tensor(x) else torch.from_numpy(np.asarray(x))
    return t.to(device=device, dtype=dtype)


class TextImageGeneration(Application):
    model_input_keys = ("input_ids", "pixel_values", "attention_mask")
    image_first = False

    @staticmethod
    def loss_fn(outputs, batch):
        """Next-token CE over the image-code positions (from text_len - 1
        on) + vq_loss."""
        logits = outputs["logits"][:, :-1]
        targets = outputs["sequence"][:, 1:].long()
        text_len = batch["input_ids"].shape[1]
        pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
        labels = torch.where(pos >= text_len - 1, targets, -100)
        lm = losses.cross_entropy(logits, labels, ignore_index=-100)
        return {"loss": lm + outputs["vq_loss"], "lm_loss": lm,
                "vq_loss": outputs["vq_loss"]}

    def generate(self, input_ids, attention_mask=None, do_sample=True,
                 top_k=100, temperature=1.0, num_beams=1, generator=None):
        """Image codes [B, image_token_length] (int64, in [0,
        image_vocab)) sampled after the text ids, only image codes
        allowed."""
        from easynlp_tpu_torch.modelzoo.generation_utils import generate
        from easynlp_tpu_torch.modelzoo.models.artist.generation import (
            make_artist_generation_fns)
        c = self.config
        ids = _tensor(input_ids, self.device, torch.int32)
        b, p = ids.shape
        mask = (torch.ones_like(ids) if attention_mask is None
                else _tensor(attention_mask, self.device, torch.int32))
        max_length = p + c.image_token_length
        prefill, decode = make_artist_generation_fns(self.module, max_length)
        bad = torch.ones((b * max(num_beams, 1), c.gpt_config.vocab_size),
                         dtype=torch.bool, device=self.device)
        bad[:, c.text_vocab_size:c.text_vocab_size + c.image_vocab_size] = \
            False
        with torch.inference_mode():
            seqs = generate(prefill, decode, ids, mask,
                            max_length=max_length, num_beams=num_beams,
                            do_sample=do_sample, top_k=top_k,
                            temperature=temperature, eos_token_id=None,
                            pad_token_id=0, bad_words_mask=bad,
                            generator=generator)
        codes = seqs[:, p:].long() - c.text_vocab_size
        return codes.clamp(0, c.image_vocab_size - 1)

    def decode_images(self, codes):
        """Image codes [B, L] -> pixels [B, H, W, 3] (f32, [-1, 1] up to
        the decoder's overshoot) through the VQGAN decoder."""
        codes = _tensor(codes, self.device)
        b, length = codes.shape
        side = int(round(length ** 0.5))
        with torch.inference_mode():
            return self.module.decode_codes(codes.view(b, side, side))

    def export_state_dict(self):
        return self.module.state_dict()

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return ARTISTConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return ARTISTModel(config, dtype=dtype, device=device,
                           image_first=cls.image_first)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        module.load_state_dict(state_dict, strict=True)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return state_dict_from_jax(params, config)
