"""Few-shot PET / CPT applications for the PyTorch port (counterpart of
easynlp_tpu/fewshot_learning/fewshot_application.py): BertForMaskedLM read
at the [MASK] position, the class logits gathered there at the verbalizer's
token ids; FewshotClassification trains them with CE, CPTClassification
adds an in-batch contrastive loss over the normalised mask-position MLM
logits (same-label rows are positives, temperature 0.1, weight 0.1)."""

import torch

from easynlp_tpu_torch.appzoo.application import Application
from easynlp_tpu_torch.modelzoo.models.bert import BertConfig, BertForMaskedLM
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    export_mlm_state_dict,
    load_mlm_state_dict,
    mlm_state_dict_from_jax,
)
from easynlp_tpu_torch.utils import losses


class FewshotModule(BertForMaskedLM):
    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                mask_positions=None, verbalizer_ids=None):
        out = super().forward(input_ids, attention_mask, token_type_ids)
        if mask_positions is not None:
            rows = torch.arange(input_ids.shape[0], device=input_ids.device)
            at_mask = out["logits"][rows, mask_positions.long()]  # [B, V]
            out["mask_logits"] = at_mask
            if verbalizer_ids is not None:
                # f32 class logits, as the classifier heads give them
                logits = torch.gather(at_mask, -1,
                                      verbalizer_ids.long()).float()
                out.update(logits=logits, predictions=logits.argmax(-1),
                           probabilities=logits.softmax(-1))
        return out


class FewshotClassification(Application):
    model_input_keys = ("input_ids", "attention_mask", "token_type_ids",
                        "mask_positions", "verbalizer_ids")

    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": losses.cross_entropy(outputs["logits"],
                                             batch["label_ids"])}

    def export_state_dict(self):
        return export_mlm_state_dict(self.module)

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return FewshotModule(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_mlm_state_dict(module, state_dict)

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return mlm_state_dict_from_jax(params, config)


class CPTClassification(FewshotClassification):
    cl_weight = 0.1

    @staticmethod
    def loss_fn(outputs, batch):
        ce = losses.cross_entropy(outputs["logits"], batch["label_ids"])
        reps = outputs["mask_logits"].float()
        reps = reps / (torch.linalg.norm(reps, dim=-1, keepdim=True) + 1e-8)
        sim = reps @ reps.t() / 0.1
        labels = batch["label_ids"]
        eye = torch.eye(sim.shape[0], device=sim.device)
        pos = (labels[:, None] == labels[None, :]).float() * (1 - eye)
        logp = torch.log_softmax(sim.masked_fill(eye > 0, -1e30), dim=-1)
        denom = torch.clamp(pos.sum(-1), min=1.0)
        cl = -torch.mean((pos * logp).sum(-1) / denom)
        return {"loss": ce + CPTClassification.cl_weight * cl,
                "ce_loss": ce, "cl_loss": cl}
