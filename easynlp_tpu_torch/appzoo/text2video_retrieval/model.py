"""Text-video retrieval (CLIP4Clip) for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text2video_retrieval/model.py: each
video's frames [B, F, H, W, 3] fold into the batch of the vision tower
(B * F images), the normalised frame embeddings are averaged over the
real frames (`video_masks`, a divisor of at least 1), and the mean is
L2-normalised again; the loss is CLIP's on text against video. A 4-D
batch is one frame per row. `image_embeds` aliases `video_embeds` for the
evaluator.
"""

import torch

from easynlp_tpu_torch.appzoo.clip.model import CLIPApp
from easynlp_tpu_torch.modelzoo.models.clip.modeling_clip import (
    CLIPModel,
    l2_normalize,
)


class CLIP4ClipModule(CLIPModel):
    def get_video_features(self, pixel_values, video_masks=None):
        b, f = pixel_values.shape[:2]
        emb = self.get_image_features(
            pixel_values.reshape((b * f,) + pixel_values.shape[2:]))
        emb = emb.reshape(b, f, -1)
        if video_masks is not None:
            w = video_masks.to(emb.dtype)[:, :, None]
            emb = (emb * w).sum(dim=1) / torch.clamp(w.sum(dim=1), min=1.0)
        else:
            emb = emb.mean(dim=1)
        return l2_normalize(emb)

    def forward(self, input_ids=None, attention_mask=None,
                token_type_ids=None, pixel_values=None, video_masks=None):
        out = {}
        if input_ids is not None:
            out["text_embeds"] = self.get_text_features(
                input_ids, attention_mask, token_type_ids)
        if pixel_values is not None:
            out["video_embeds"] = (
                self.get_video_features(pixel_values, video_masks)
                if pixel_values.dim() == 5
                else self.get_image_features(pixel_values))
        if "text_embeds" in out and "video_embeds" in out:
            out["logits_per_text"] = torch.exp(self.logit_scale) * (
                out["text_embeds"] @ out["video_embeds"].t())
            out["image_embeds"] = out["video_embeds"]
        return out


class Text2VideoRetrieval(CLIPApp):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids",
                        "pixel_values", "video_masks")
    module_cls = CLIP4ClipModule
