"""Text match applications for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/text_match/model.py:
- `TextMatch`, the cross-encoder: the pair through one BERT and the
  classification head (SequenceClassification);
- `TextMatchTwoTower`, the bi-encoder (also the siamese variant): one shared
  BERT without pooler encodes each side; the f32 [CLS] hidden state (or the
  masked mean, udp two_tower_pooling=avg) is L2-normalised (+1e-8), and
  the similarity is the dot product of the two embeddings. Trained with the
  in-batch hinge loss (margin 0.3), or circle loss in
  `TextMatchTwoTowerCircleLoss`.
"""

import torch
from torch import nn

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.appzoo.sequence_classification.model import (
    SequenceClassification,
)
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertModel
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    app_state_dict_from_jax,
    export_app_state_dict,
    load_app_state_dict,
)
from easynlp_tpu_torch.utils import losses

HINGE_MARGIN = 0.3


class TextMatch(SequenceClassification):
    """Cross-encoder: sentence pair through one BERT, then match / no
    match."""


class TwoTowerModule(nn.Module):
    """Shared-backbone bi-encoder giving L2-normalised f32 embeddings."""

    def __init__(self, config, pooling="cls", dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        self.pooling = pooling
        self.backbone = BertModel(config, dtype=dtype, add_pooling_layer=False,
                                  device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        self.backbone.init_weights(generator)

    def encode(self, input_ids, attention_mask=None, token_type_ids=None):
        out = self.backbone(input_ids, attention_mask=attention_mask,
                            token_type_ids=token_type_ids)
        hidden = out["last_hidden_state"].float()
        if self.pooling == "avg":
            mask = (attention_mask if attention_mask is not None
                    else torch.ones_like(input_ids))
            mask = mask.float()[..., None]
            emb = (hidden * mask).sum(1) / torch.clamp(mask.sum(1), min=1.0)
        else:
            emb = hidden[:, 0]
        return emb / (torch.linalg.vector_norm(emb, dim=-1, keepdim=True)
                      + 1e-8)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                input_ids_b=None, attention_mask_b=None,
                token_type_ids_b=None):
        emb_a = self.encode(input_ids, attention_mask, token_type_ids)
        out = {"embeddings": emb_a}
        if input_ids_b is not None:
            emb_b = self.encode(input_ids_b, attention_mask_b,
                                token_type_ids_b)
            sim = (emb_a * emb_b).sum(-1)
            logits = torch.stack([-sim, sim], dim=-1)
            out.update(embeddings_b=emb_b, similarity=sim,
                       sim_matrix=emb_a @ emb_b.T, logits=logits,
                       predictions=(sim > 0.5).to(torch.int32),
                       probabilities=logits.softmax(dim=-1))
        return out


class TextMatchTwoTower(Application):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids",
                        "input_ids_b", "attention_mask_b", "token_type_ids_b")

    @staticmethod
    def loss_fn(outputs, batch):
        """Hinge with in-batch negatives: mean over i != j of
        max(0, margin - sim_ii + sim_ij)."""
        sim = outputs["sim_matrix"].float()
        neg_mask = 1.0 - torch.eye(sim.shape[0], device=sim.device)
        pos = torch.diagonal(sim)
        hinge = torch.clamp(HINGE_MARGIN - pos[:, None] + sim,
                            min=0.0) * neg_mask
        return {"loss": hinge.sum() / torch.clamp(neg_mask.sum(), min=1.0)}

    def export_state_dict(self):
        """The backbone under `bert.*` (no pooler, no head)."""
        return export_app_state_dict(self.module)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        udp = getattr(args, "user_defined_parameters_dict", {}) if args \
            else {}
        return TwoTowerModule(config, pooling=udp.get("two_tower_pooling",
                                                      "cls"),
                              dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_app_state_dict(module, state_dict)


class TextMatchTwoTowerCircleLoss(TextMatchTwoTower):
    @staticmethod
    def loss_fn(outputs, batch):
        sim = outputs["sim_matrix"]
        return {"loss": losses.circle_loss(
            sim, torch.eye(sim.shape[0], device=sim.device))}


def state_dict_from_jax(params, config):
    """TwoTowerModule's state dict from the JAX app's params (a backbone
    without pooler)."""
    return app_state_dict_from_jax(params, config)
