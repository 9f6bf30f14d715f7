"""CLIP retrieval application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/clip/model.py: the dual tower
(modelzoo/models/clip) trained with the symmetric in-batch contrastive
loss (utils/losses.py::clip_contrastive_loss) on logits_per_text. It reads
an HF Chinese-CLIP `pytorch_model.bin` (the port's own names) or the JAX
package's `flax_params.msgpack`, and writes the HF names back.
"""

import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.models.clip import CLIPConfig, CLIPModel
from easynlp_tpu_torch.modelzoo.models.clip import conversion
from easynlp_tpu_torch.utils import losses


class CLIPApp(Application):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids",
                        "pixel_values")
    module_cls = CLIPModel

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.clip_contrastive_loss(
            outputs["logits_per_text"])}

    def export_state_dict(self):
        return self.module.state_dict()

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return CLIPConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return cls.module_cls(config, dtype=dtype, device=device)

    @classmethod
    def convert_pytorch_state_dict(cls, state_dict, config):
        """An HF Chinese-CLIP state dict under the port's names."""
        return conversion.normalize_keys(state_dict)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        conversion.load_clip_state_dict(
            module, cls.convert_pytorch_state_dict(state_dict,
                                                   module.config))

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return conversion.state_dict_from_jax(params, config)
