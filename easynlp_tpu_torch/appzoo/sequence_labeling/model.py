"""Sequence labeling (NER) application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_labeling/model.py: a BERT
backbone without pooler, dropout, and an f32 per-token linear head named
`classifier`; trained with cross-entropy that ignores the -100 positions
(continuation pieces, [CLS], [SEP], padding).
"""

import torch
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    app_state_dict_from_jax,
    export_app_state_dict,
    load_app_state_dict,
)
from easynlp_tpu_torch.utils import losses


class SequenceLabelingModule(nn.Module):
    def __init__(self, config, num_labels=2, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        self.backbone = BertModel(config, dtype=dtype, add_pooling_layer=False,
                                  device=device)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        self.classifier = nn.Linear(config.hidden_size, num_labels,
                                    device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        self.backbone.init_weights(generator)
        truncated_normal_(self.classifier.weight,
                          self.config.initializer_range, generator)
        self.classifier.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        out = self.backbone(input_ids, attention_mask=attention_mask,
                            token_type_ids=token_type_ids)
        hidden = self.dropout(out["last_hidden_state"])
        logits = self.classifier(hidden.float())
        return {"logits": logits, "predictions": logits.argmax(dim=-1)}


class SequenceLabeling(Application):
    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(
            outputs["logits"], batch["label_ids"], ignore_index=-100)}

    def export_state_dict(self):
        return export_app_state_dict(self.module, ("classifier",))

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, num_labels=None, **kwargs):
        n = num_labels or getattr(config, "num_labels", 2)
        return SequenceLabelingModule(config, num_labels=n, dtype=dtype,
                                      device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_app_state_dict(module, state_dict, ("classifier",))


def state_dict_from_jax(params, config):
    """SequenceLabelingModule's state dict from the JAX app's params."""
    return app_state_dict_from_jax(params, config, ("classifier",))
