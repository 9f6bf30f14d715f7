"""Image-to-text generation, the VQGAN variant (enable_vqgan), for the
PyTorch port.

Counterpart of easynlp_tpu/appzoo/image2text_generation/vqgan_model.py:
the ARTIST tower (modelzoo/models/artist/) with the sequence ordered
[image codes; caption]. The image is tokenised into VQGAN codes, the
loss is the next-token CE over the caption segment (real tokens only,
by attention_mask) plus the VQ losses, and captions decode after the
prompt [codes + text_vocab; BOS] with the image codes banned.
`VQGANImageTextDataset` reads the captioning rows with [-1, 1] pixels at
udp size (or img_size; default 256).
"""

import numpy as np
import torch

from easynlp_tpu_torch.appzoo.image2text_generation.data import (
    ImageTextDataset,
)
from easynlp_tpu_torch.appzoo.text2image_generation.model import (
    TextImageGeneration,
    _tensor,
)
from easynlp_tpu_torch.data.image_utils import (
    decode_base64_image_urlsafe,
    preprocess_image_pm1,
)
from easynlp_tpu_torch.utils import losses

# VQGANImageTextDataset's image size unless udp size or img_size is given
VQGAN_IMAGE_SIZE = 256


class VQGANGPTImageTextGeneration(TextImageGeneration):
    """ARTIST tower, [image codes; caption] order, caption-side loss."""

    image_first = True

    @staticmethod
    def loss_fn(outputs, batch):
        """Next-token CE over the caption segment of [codes; text], its
        padding left out, + vq_loss."""
        logits = outputs["logits"][:, :-1]
        targets = outputs["sequence"][:, 1:].long()
        img_len = outputs["sequence"].shape[1] - batch["input_ids"].shape[1]
        pos = torch.arange(targets.shape[1], device=targets.device)[None, :]
        labels = torch.where(pos >= img_len - 1, targets, -100)
        if "attention_mask" in batch:
            # the target at sequence position p >= img_len is text token
            # p - img_len; the image-segment targets stay as they are
            head = torch.ones((labels.shape[0], img_len - 1),
                              dtype=torch.bool, device=labels.device)
            keep = torch.cat([head, batch["attention_mask"].to(
                labels.device) > 0], dim=1)
            labels = torch.where(keep, labels, -100)
        lm = losses.cross_entropy(logits, labels, ignore_index=-100)
        return {"loss": lm + outputs["vq_loss"], "lm_loss": lm,
                "vq_loss": outputs["vq_loss"]}

    def tokenize_images(self, pixel_values):
        """[-1, 1] pixels [B, H, W, 3] -> image codes [B, L]."""
        pv = _tensor(pixel_values, self.device, torch.float32)
        with torch.inference_mode():
            codes, _, _ = self.module.tokenize_image(pv)
        return codes.reshape(pv.shape[0], -1)

    def generate(self, pixel_values, max_length=32, bos_token_id=101,
                 eos_token_id=102, pad_token_id=0, num_beams=1,
                 do_sample=False, top_k=0, temperature=1.0, generator=None):
        """Caption ids [B, 1 + max_length] from BOS after the image-code
        prefix, decoded over the text vocabulary only."""
        from easynlp_tpu_torch.modelzoo.generation_utils import generate
        from easynlp_tpu_torch.modelzoo.models.artist.generation import (
            make_artist_generation_fns)
        c = self.config
        codes = self.tokenize_images(pixel_values)
        b = codes.shape[0]
        prompt = torch.cat([
            (codes + c.text_vocab_size).to(torch.int32),
            torch.full((b, 1), bos_token_id, dtype=torch.int32,
                       device=self.device)], dim=1)
        mask = torch.ones_like(prompt)
        total = prompt.shape[1] + max_length
        prefill, decode = make_artist_generation_fns(self.module, total)
        bad = torch.zeros((b * max(num_beams, 1), c.gpt_config.vocab_size),
                          dtype=torch.bool, device=self.device)
        bad[:, c.text_vocab_size:] = True  # image codes are not words
        with torch.inference_mode():
            seqs = generate(prefill, decode, prompt, mask, max_length=total,
                            num_beams=num_beams, do_sample=do_sample,
                            top_k=top_k, temperature=temperature,
                            eos_token_id=eos_token_id,
                            pad_token_id=pad_token_id, bad_words_mask=bad,
                            generator=generator)
        return seqs[:, prompt.shape[1] - 1:]


class VQGANImageTextDataset(ImageTextDataset):
    """Captioning rows with [-1, 1] pixels at the VQGAN's input size."""

    def __init__(self, *args, user_defined_parameters=None, **kwargs):
        udp = dict(user_defined_parameters or {})
        self.vq_size = int(udp.get("size", udp.get("img_size",
                                                  VQGAN_IMAGE_SIZE)))
        super().__init__(*args, user_defined_parameters=udp, **kwargs)

    def decode_image(self, idx):
        return preprocess_image_pm1(
            decode_base64_image_urlsafe(self._image_b64(idx)),
            self.vq_size).astype(np.float32)
