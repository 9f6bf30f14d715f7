"""MegatronBERT for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/megatron_bert.py: BERT in the
Megatron layout, pre-LN blocks and a final encoder LayerNorm, everything
else BERT (modeling_bert.py with pre_layer_norm=True). The parameters keep
HF MegatronBertModel's names (`embeddings.*` with no LayerNorm,
`encoder.layer.{i}.attention.ln`, `encoder.layer.{i}.ln`, `encoder.ln`,
`pooler.dense`), so an HF `pytorch_model.bin` loads strictly with no
converter (the JAX package's AutoModel has none for this family: ROADMAP
reference fault 22). HF's config.json says model_type `megatron-bert`; the
JAX package's `megatron_bert`; both load here.
"""

import torch

from easynlp_tpu_torch.modelzoo.models.bert.configuration_bert import (
    BertConfig,
)
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    state_dict_from_jax as bert_state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import BertModel


class MegatronBertConfig(BertConfig):
    model_type = "megatron_bert"


class MegatronBertModel(BertModel):
    """BertModel in the pre-LN layout; returns what BertModel returns."""

    def __init__(self, config, dtype=torch.float32, add_pooling_layer=True,
                 device=None, **kwargs):
        super().__init__(config, dtype=dtype,
                         add_pooling_layer=add_pooling_layer, device=device,
                         pre_layer_norm=True, **kwargs)


def state_dict_from_jax(params, config):
    """The port's MegatronBertModel state dict from the JAX module's param
    tree (numpy leaves): the inverse of the JAX package's
    convert_megatron_bert (stacked attention_ln / output_ln and final_ln
    to attention.ln / ln / encoder.ln)."""
    return bert_state_dict_from_jax(params, config)
