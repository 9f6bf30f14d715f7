"""Video-to-text generation (frame captioning) for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/video2text_generation/model.py: the
frames [B, F, H, W, 3] fold into the ViT's batch, and each frame's CLS
row, through `visual_proj`, is one token of the GPT prefix [B, F, E];
a 4-D batch takes image2text's prefix. Everything else is
image2text_generation's.
"""

from easynlp_tpu_torch.appzoo.image2text_generation.model import (
    CLIPGPTImageTextGeneration,
    CLIPGPTImageTextModule,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import dense


class CLIPGPTFrameTextModule(CLIPGPTImageTextModule):
    def prefix_length(self, pixel_values):
        if pixel_values.dim() == 5:
            return pixel_values.shape[1]
        return super().prefix_length(pixel_values)

    def encode_image(self, pixel_values):
        if pixel_values.dim() == 5:
            b, f = pixel_values.shape[:2]
            out = self.vision(pixel_values.reshape(
                (b * f,) + pixel_values.shape[2:]))
            cls = out["pooler_output"].reshape(b, f, -1)
            return dense(self.visual_proj, cls, self.dtype)
        return super().encode_image(pixel_values)


class CLIPGPTFrameTextGeneration(CLIPGPTImageTextGeneration):
    module_cls = CLIPGPTFrameTextModule
