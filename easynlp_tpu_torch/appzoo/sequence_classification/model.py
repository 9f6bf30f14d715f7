"""Text classification application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_classification/model.py: BERT
backbone -> pooled output -> dropout -> f32 linear head, trained with
cross-entropy; the multi-label variant (user_defined_parameters
multi_label=true) with a per-label sigmoid cross-entropy over multi-hot
labels.
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


class SequenceClassificationModule(nn.Module):
    def __init__(self, config, num_labels=2, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        self.backbone = BertModel(config, dtype=dtype, device=device)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)
        # head in f32: cheap, and keeps logits exact
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
        pooled = self.dropout(out["pooler_output"])
        logits = self.classifier(pooled.float())
        return {"logits": logits,
                "predictions": logits.argmax(dim=-1),
                "probabilities": logits.softmax(dim=-1)}


class SequenceClassification(Application):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids")

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["label_ids"])}

    def export_state_dict(self):
        """The module's weights under the reference/HF names: `bert.*` for
        the backbone, `classifier.*` for the head."""
        return export_app_state_dict(self.module, ("classifier",))

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, num_labels=None, **kwargs):
        n = num_labels or getattr(config, "num_labels", 2)
        return SequenceClassificationModule(config, num_labels=n, dtype=dtype,
                                            device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        """Backbone strictly (HF names after normalisation); the
        `classifier.*` head when the checkpoint has one (fine-tuned
        reference checkpoints do; a pretrained backbone keeps the init)."""
        load_app_state_dict(module, state_dict, ("classifier",))

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return state_dict_from_jax(params, config)


class SequenceMultiLabelClassification(SequenceClassification):
    """The multi-label variant (easynlp_tpu sequence_classification/model.py
    :80-87): the same module, a sigmoid cross-entropy per label over the
    multi-hot label matrix. The module's `probabilities` stay the softmax,
    as in the JAX package; the predictor reports per-label sigmoids."""

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.multi_label_sigmoid_ce(outputs["logits"],
                                                      batch["label_ids"])}


def state_dict_from_jax(params, config):
    """SequenceClassificationModule's state dict from the JAX app's params
    (backbone with pooler, classifier)."""
    return app_state_dict_from_jax(params, config, ("classifier",))
