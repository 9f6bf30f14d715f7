"""CLIP configs for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/clip/configuration_clip.py:
a ViT vision config and a BERT text config under one dual-tower config
(the Chinese-CLIP layout), with the JAX package's defaults. A config.json
written by the JAX package or by HF's ChineseCLIPConfig (whose sub-configs
carry their own model_type) reads back unchanged.
"""

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig


def _sub(cls, value):
    """A sub-config from a dict (its model_type dropped), or as given."""
    if isinstance(value, PretrainedConfig):
        return value
    value = dict(value or {})
    value.pop("model_type", None)
    return cls(**value)


class CLIPVisionConfig(PretrainedConfig):
    model_type = "clip_vision_model"

    def __init__(self, image_size=224, patch_size=32, hidden_size=768,
                 num_hidden_layers=12, num_attention_heads=12,
                 intermediate_size=3072, hidden_act="gelu_new",
                 layer_norm_eps=1e-5, attention_dropout=0.0, dropout=0.0,
                 initializer_range=0.02, **kwargs):
        self.image_size = image_size
        self.patch_size = patch_size
        self.attention_dropout = attention_dropout
        self.dropout = dropout
        kwargs.setdefault("hidden_dropout_prob", dropout)
        kwargs.setdefault("attention_probs_dropout_prob", attention_dropout)
        super().__init__(hidden_size=hidden_size,
                         num_hidden_layers=num_hidden_layers,
                         num_attention_heads=num_attention_heads,
                         intermediate_size=intermediate_size,
                         hidden_act=hidden_act, layer_norm_eps=layer_norm_eps,
                         initializer_range=initializer_range, **kwargs)

    @property
    def num_patches(self):
        return (self.image_size // self.patch_size) ** 2


class CLIPConfig(PretrainedConfig):
    model_type = "clip"

    def __init__(self, text_config=None, vision_config=None,
                 projection_dim=512, logit_scale_init_value=2.6592, **kwargs):
        self.text_config = _sub(BertConfig, text_config)
        self.vision_config = _sub(CLIPVisionConfig, vision_config)
        self.projection_dim = projection_dim
        self.logit_scale_init_value = logit_scale_init_value
        super().__init__(**kwargs)

    def to_dict(self):
        out = super().to_dict()
        out["text_config"] = self.text_config.to_dict()
        out["vision_config"] = self.vision_config.to_dict()
        return out
