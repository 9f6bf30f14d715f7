"""CKBERT for the PyTorch port: contrastive knowledge-enhanced MLM
pretraining.

Counterpart of easynlp_tpu/modelzoo/models/ckbert.py. The knowledge-guided
masking is the MLM dataset's job; this module gives the two-view
contrastive forward: in training mode the backbone runs twice, so the two
[CLS] states come from two independent dropout samples (SimCSE), as the
two calls in one flax apply draw fresh dropout bits (JAX :39-54); in eval
mode it runs once and gives no `cls_view2`. `ckbert_pretrain_loss` is the
MLM CE plus `contrastive_weight` times the in-batch InfoNCE between the
L2-normalised views at `contrastive_temperature` (JAX :57-72). The
parameters keep BertForMaskedLM's names.
"""

import torch

from easynlp_tpu_torch.modelzoo.models.bert.configuration_bert import (
    BertConfig,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    BertForMaskedLM,
)
from easynlp_tpu_torch.utils import losses


class CKBertConfig(BertConfig):
    model_type = "ckbert"

    def __init__(self, contrastive_temperature=0.05, contrastive_weight=0.1,
                 **kwargs):
        self.contrastive_temperature = contrastive_temperature
        self.contrastive_weight = contrastive_weight
        super().__init__(**kwargs)


class CKBertForPreTraining(BertForMaskedLM):
    """Returns {'logits' [B,S,V], 'cls_view1' [B,E]} and, in training
    mode, 'cls_view2' [B,E] from a second run of the backbone."""

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        out = self.bert(input_ids, attention_mask, token_type_ids)
        logits = self.cls(out["last_hidden_state"],
                          self.bert.embeddings.word_embeddings)
        result = {"logits": logits,
                  "cls_view1": out["last_hidden_state"][:, 0]}
        if self.training:
            second = self.bert(input_ids, attention_mask, token_type_ids)
            result["cls_view2"] = second["last_hidden_state"][:, 0]
        return result


def ckbert_pretrain_loss(outputs, batch, temperature=0.05, weight=0.1):
    """MLM CE + weight x the in-batch InfoNCE between the two views."""
    mlm = losses.cross_entropy(outputs["logits"], batch["label_ids"],
                               ignore_index=-100)
    result = {"loss": mlm, "mlm_loss": mlm}
    if "cls_view2" in outputs:
        a = outputs["cls_view1"].float()
        b = outputs["cls_view2"].float()
        a = a / (torch.linalg.vector_norm(a, dim=-1, keepdim=True) + 1e-8)
        b = b / (torch.linalg.vector_norm(b, dim=-1, keepdim=True) + 1e-8)
        sim = a @ b.t() / temperature
        cl = losses.cross_entropy(sim, torch.arange(sim.shape[0],
                                                    device=sim.device))
        result["loss"] = mlm + weight * cl
        result["contrastive_loss"] = cl
    return result
