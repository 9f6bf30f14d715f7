"""K-BERT for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/kbert/modeling_kbert.py.
Knowledge-graph triples are grafted into the token sequence as branches of
a sentence tree (the dataset's job); the model is post-LN BERT with (a)
caller-supplied soft position ids, which place branch tokens at their
anchor's position, and (b) a visible matrix [B, S, S] which, with the key
mask, becomes an additive attention bias (0 where visible, -1e30
elsewhere), so injected knowledge interacts only with its anchor.

A bias takes attention's plain path (ops/attention.py's
attention_reference), as the JAX module's does (its attention() sends any
bias to the XLA reference): no TPU kernel takes a bias, so K-BERT launches
no kernel (ROADMAP A13, open: a short kernel that takes a bias would serve
K-BERT and T5). The parameters keep BERT's HF names, as the reference
checkpoints do (the JAX package's convert_kbert reads a BERT checkpoint),
so a BERT `pytorch_model.bin` loads strictly.
"""

import torch

from easynlp_tpu_torch.modelzoo.models.bert.configuration_bert import (
    BertConfig,
)
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    state_dict_from_jax as bert_state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import BertModel
from easynlp_tpu_torch.ops.attention import NEG_INF


class KBertConfig(BertConfig):
    model_type = "kbert"


class KBertModel(BertModel):
    """BertModel whose forward also takes `visible_matrix` [B, S, S] (1 =
    visible); returns {'last_hidden_state', 'pooler_output'}."""

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, visible_matrix=None):
        b, s = input_ids.shape
        hidden, kv_mask = self.embed(input_ids, attention_mask,
                                     token_type_ids, position_ids)
        visible = (visible_matrix != 0 if visible_matrix is not None else
                   torch.ones((b, s, s), dtype=torch.bool,
                              device=input_ids.device))
        visible = visible & (kv_mask != 0)[:, None, :]
        bias = torch.zeros(visible.shape, device=input_ids.device) \
            .masked_fill(~visible, NEG_INF)[:, None]
        hidden, _, _ = self.encoder(hidden, None, bias=bias)
        out = {"last_hidden_state": hidden}
        if self.pooler is not None:
            out["pooler_output"] = self.pooler(hidden)
        return out


def state_dict_from_jax(params, config):
    """The port's KBertModel state dict from the JAX KBertModel's param
    tree (numpy leaves): the inverse of the JAX package's convert_kbert
    (its `encoder_layers` qkv / attn_output / attention_ln / intermediate /
    output / output_ln back under BERT's names)."""
    layers = dict(params["encoder_layers"])
    tree = {k: v for k, v in params.items() if k != "encoder_layers"}
    tree["encoder"] = {"layers": {
        "attention": {"qkv": layers["qkv"],
                      "output": layers["attn_output"]},
        **{k: layers[k] for k in ("attention_ln", "intermediate", "output",
                                  "output_ln")}}}
    return bert_state_dict_from_jax(tree, config)
