"""Text classification application for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/sequence_classification/model.py: BERT
backbone -> pooled output -> dropout -> f32 linear head, trained with
cross-entropy. The multi-label variant is not ported yet (ROADMAP A5).
"""

import torch
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    normalize_keys,
    split_backbone,
)
from easynlp_tpu_torch.utils import losses
from easynlp_tpu_torch.utils.logger import logger


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
        out = {"bert." + k: v
               for k, v in self.module.backbone.state_dict().items()}
        out.update({"classifier." + k: v
                    for k, v in self.module.classifier.state_dict().items()})
        return out

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
        backbone, other = split_backbone(normalize_keys(state_dict))
        module.backbone.load_state_dict(backbone, strict=True)
        head = {k[len("classifier."):]: v for k, v in other.items()
                if k.startswith("classifier.")}
        if head:
            module.classifier.load_state_dict(head, strict=True)
        else:
            logger.info("classifier initialised from scratch (not in "
                        "checkpoint)")
        unused = sorted(k for k in other if not k.startswith("classifier."))
        if unused:
            logger.info("checkpoint params unused by model: %s",
                        unused[:12] + (["..."] if len(unused) > 12 else []))
