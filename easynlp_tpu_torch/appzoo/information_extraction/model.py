"""Information extraction (Global Pointer) for the PyTorch port.

Counterpart of easynlp_tpu/appzoo/information_extraction/model.py: a BERT
backbone without pooler; one f32 `pointer` projection of the last hidden
state to a query and a key of width 64 per entity type; rotary positions
on both (`rope`, the even and odd lanes paired as the JAX package pairs
them, not the half-split layout); and span scores q_i . k_j / sqrt(64) for
every (type, start i, end j), set to -1e30 at padding and where j < i.
The scores are a plain einsum, as in the JAX package, whose Pallas kernels
do not reach them. Trained with the global-pointer multilabel
cross-entropy.
"""

import math

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

HEAD_SIZE = 64
NEG = -1e30


def rope(x):
    """Rotary position embedding over the last dim of x [B, S, H, D] (f32):
    lanes 2i and 2i + 1 rotate together by position / 10000^(2i/D)."""
    b, s, h, d = x.shape
    pos = torch.arange(s, dtype=torch.float32, device=x.device)
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    freqs = pos[:, None] * inv[None, :]               # [S, D/2]
    cos = torch.cos(freqs)[None, :, None, :]
    sin = torch.sin(freqs)[None, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    return torch.stack([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                       dim=-1).reshape(b, s, h, d)


class GlobalPointerModule(nn.Module):
    def __init__(self, config, num_entity_types=1, dtype=torch.float32,
                 device=None):
        super().__init__()
        self.config = config
        self.num_entity_types = num_entity_types
        self.backbone = BertModel(config, dtype=dtype, add_pooling_layer=False,
                                  device=device)
        self.pointer = nn.Linear(config.hidden_size,
                                 num_entity_types * HEAD_SIZE * 2,
                                 device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        self.backbone.init_weights(generator)
        truncated_normal_(self.pointer.weight, self.config.initializer_range,
                          generator)
        self.pointer.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None):
        out = self.backbone(input_ids, attention_mask=attention_mask,
                            token_type_ids=token_type_ids)
        hidden = out["last_hidden_state"].float()
        b, s, _ = hidden.shape
        t, d = self.num_entity_types, HEAD_SIZE
        qk = self.pointer(hidden).view(b, s, t, 2, d)
        q, k = rope(qk[..., 0, :]), rope(qk[..., 1, :])
        # q [B, i, T, D], k [B, j, T, D] -> [B, T, i, j]
        scores = torch.einsum("bied,bjed->beij", q, k) / math.sqrt(d)
        if attention_mask is not None:
            m = attention_mask.bool()
            scores = torch.where(m[:, None, :, None] & m[:, None, None, :],
                                 scores, NEG)
        below = torch.ones((s, s), dtype=torch.bool,
                           device=scores.device).tril(-1)
        return {"span_scores": torch.where(below, NEG, scores)}


def global_pointer_loss(scores, labels):
    """log(1 + sum_neg e^s) + log(1 + sum_pos e^-s) per (row, type),
    averaged; spans at -1e30 (padding, end < start) take no part."""
    scores = scores.float()
    labels = labels.float()
    valid = scores > -1e29
    s_pos = torch.where((labels > 0) & valid, -scores, NEG)
    s_neg = torch.where((labels == 0) & valid, scores, NEG)
    zeros = scores.new_zeros(scores.shape[:2] + (1,))
    pos = torch.cat([s_pos.flatten(2), zeros], -1)
    neg = torch.cat([s_neg.flatten(2), zeros], -1)
    return (torch.logsumexp(pos, -1) + torch.logsumexp(neg, -1)).mean()


class InformationExtractionModel(Application):
    @staticmethod
    def loss_fn(outputs, batch):
        return {"loss": global_pointer_loss(outputs["span_scores"],
                                            batch["span_labels"])}

    def export_state_dict(self):
        return export_app_state_dict(self.module, ("pointer",))

    @classmethod
    def load_config(cls, model_dir, **kwargs):
        return BertConfig.from_pretrained(model_dir)

    @classmethod
    def build_module(cls, config, args=None, dtype=torch.float32,
                     device=None, num_entity_types=None, num_labels=None,
                     **kwargs):
        return GlobalPointerModule(
            config, num_entity_types=num_entity_types or num_labels or 1,
            dtype=dtype, device=device)

    @classmethod
    def load_state_dict(cls, module, state_dict):
        load_app_state_dict(module, state_dict, ("pointer",))

    @classmethod
    def state_dict_from_jax(cls, params, config):
        return state_dict_from_jax(params, config)


def state_dict_from_jax(params, config):
    """GlobalPointerModule's state dict from the JAX app's params (a
    backbone without pooler, `pointer`)."""
    return app_state_dict_from_jax(params, config, ("pointer",))
