"""Machine reading comprehension (SQuAD-style span extraction) for the
PyTorch port.

Counterpart of easynlp_tpu/appzoo/machine_reading_comprehension/model.py: a
BERT backbone without pooler and an f32 `qa_outputs` head of 2 logits per
token, split into start and end logits, -1e30 at the padding. The loss is
the mean of the start and end cross-entropies, the gold positions clamped to
[0, S-1].
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

NEG_INF = -1e30


class MRCModule(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.backbone = BertModel(config, dtype=dtype, add_pooling_layer=False,
                                  device=device)
        self.qa_outputs = nn.Linear(config.hidden_size, 2, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        self.backbone.init_weights(generator)
        truncated_normal_(self.qa_outputs.weight,
                          self.config.initializer_range, generator)
        self.qa_outputs.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        out = self.backbone(input_ids, attention_mask=attention_mask,
                            token_type_ids=token_type_ids)
        logits = self.qa_outputs(out["last_hidden_state"].float())
        start, end = logits[..., 0], logits[..., 1]
        if attention_mask is not None:  # padding is never an answer
            keep = attention_mask > 0
            start = torch.where(keep, start, NEG_INF)
            end = torch.where(keep, end, NEG_INF)
        return {"start_logits": start, "end_logits": end,
                "start_predictions": start.argmax(-1),
                "end_predictions": end.argmax(-1)}


class MachineReadingComprehension(Application):
    @staticmethod
    def loss_fn(outputs, batch):
        seq_len = outputs["start_logits"].shape[-1]
        start = torch.clamp(batch["start_positions"], 0, seq_len - 1)
        end = torch.clamp(batch["end_positions"], 0, seq_len - 1)
        return {"loss": 0.5 * (
            losses.cross_entropy(outputs["start_logits"], start)
            + losses.cross_entropy(outputs["end_logits"], end))}

    def export_state_dict(self):
        return export_app_state_dict(self.module, ("qa_outputs",))

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, **kwargs):
        return MRCModule(config, dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_app_state_dict(module, state_dict, ("qa_outputs",))


def state_dict_from_jax(params, config):
    """MRCModule's state dict from the JAX app's params."""
    return app_state_dict_from_jax(params, config, ("qa_outputs",))
