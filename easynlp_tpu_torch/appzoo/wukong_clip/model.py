"""Wukong CLIP application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/wukong_clip/model.py: the CLIP dual
tower, reading the Wukong/OpenAI checkpoint dialect (`visual.*` ViT,
`bert.*` text tower, `text_projection`, `logit_scale`) through
modelzoo/models/clip/conversion.py::from_wukong; a checkpoint without
`text_projection` or `logit_scale` leaves them at their init, as the JAX
app does. The port's own checkpoints (HF names) read back as CLIP's.
"""

from easynlp_tpu_torch.appzoo.clip.model import CLIPApp
from easynlp_tpu_torch.modelzoo.models.clip import conversion

_OPTIONAL = ("text_projection.weight", "logit_scale")


class WukongCLIP(CLIPApp):
    @classmethod
    def convert_pytorch_state_dict(cls, state_dict, config):
        if "visual.conv1.weight" in state_dict:
            return conversion.from_wukong(state_dict, config)
        return conversion.normalize_keys(state_dict)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        conversion.load_clip_state_dict(
            module, cls.convert_pytorch_state_dict(state_dict,
                                                   module.config),
            optional=_OPTIONAL if "visual.conv1.weight" in state_dict
            else ())
