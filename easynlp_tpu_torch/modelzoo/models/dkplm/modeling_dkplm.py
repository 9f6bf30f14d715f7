"""DKPLM for the PyTorch port (decomposable knowledge-enhanced
pretraining).

Counterpart of easynlp_tpu/modelzoo/models/dkplm/modeling_dkplm.py: BERT
whose input embeddings get projected knowledge-graph entity embeddings
added at entity positions (`know_linear(insert_know_emb) *
insert_know_position_mask`, JAX :55-66), and whose pretraining loss adds a
decode-knowledge CE over `insert_know_labels` to the MLM CE, over the
same logits (`dkplm_pretrain_loss`, JAX :101-114). The encoder is the
port's BertEncoder, so --remat reaches it (set_remat), as the JAX
module's `remat` does. Parameter names: BERT's, with `know_linear` beside
the embeddings (`bert.know_linear.*` in DKPLMForPreTraining's
checkpoints).
"""

import numpy as np
import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.configuration_bert import (
    BertConfig,
)
from easynlp_tpu_torch.modelzoo.models.bert.conversion import (
    state_dict_from_jax as bert_state_dict_from_jax,
)
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    BertMLMHead,
    BertModel,
    dense,
)
from easynlp_tpu_torch.utils import losses


class DKPLMConfig(BertConfig):
    model_type = "dkplm"

    def __init__(self, knowledge_emb_size=200, **kwargs):
        self.knowledge_emb_size = knowledge_emb_size
        super().__init__(**kwargs)


class DKPLMModel(BertModel):
    """BertModel + additive projected knowledge embeddings at entity
    positions. insert_know_emb [B, S, knowledge_emb_size] f32,
    insert_know_position_mask [B, S] int."""

    def __init__(self, config, dtype=torch.float32, add_pooling_layer=True,
                 device=None):
        super().__init__(config, dtype=dtype,
                         add_pooling_layer=add_pooling_layer, device=device)
        self.dtype = dtype
        self.know_linear = nn.Linear(config.knowledge_emb_size,
                                     config.hidden_size, device=device)

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None, insert_know_emb=None,
                insert_know_position_mask=None):
        hidden, kv_mask = self.embed(input_ids, attention_mask,
                                     token_type_ids, position_ids)
        if insert_know_emb is not None:
            know = dense(self.know_linear, insert_know_emb, self.dtype)
            if insert_know_position_mask is not None:
                know = know * insert_know_position_mask[..., None].to(
                    self.dtype)
            hidden = hidden + know
        hidden, _, _ = self.encoder(hidden, kv_mask)
        out = {"last_hidden_state": hidden}
        if self.pooler is not None:
            out["pooler_output"] = self.pooler(hidden)
        return out


class DKPLMForPreTraining(nn.Module):
    """DKPLMModel without a pooler and BERT's MLM head tied to its word
    embeddings. Returns {'logits' [B,S,V], 'last_hidden_state' [B,S,E]}."""

    tensor_table = "bert"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.bert = DKPLMModel(config, dtype=dtype, add_pooling_layer=False,
                               device=device)
        self.cls = BertMLMHead(config, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """The backbone's init (know_linear included), then the head's, as
        BertForMaskedLM's."""
        self.bert.init_weights(generator)
        truncated_normal_(self.cls.dense.weight,
                          self.config.initializer_range, generator)
        self.cls.dense.bias.zero_()
        self.cls.LayerNorm.weight.fill_(1.0)
        self.cls.LayerNorm.bias.zero_()
        self.cls.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                insert_know_emb=None, insert_know_position_mask=None):
        out = self.bert(input_ids, attention_mask, token_type_ids,
                        insert_know_emb=insert_know_emb,
                        insert_know_position_mask=insert_know_position_mask)
        out["logits"] = self.cls(out["last_hidden_state"],
                                 self.bert.embeddings.word_embeddings)
        return out


def dkplm_pretrain_loss(outputs, batch):
    """MLM CE + decode-knowledge CE over the same logits (the JAX
    package's dkplm_pretrain_loss)."""
    mlm = losses.cross_entropy(outputs["logits"], batch["label_ids"],
                               ignore_index=-100)
    result = {"loss": mlm, "mlm_loss": mlm}
    if "insert_know_labels" in batch:
        decode = losses.cross_entropy(outputs["logits"],
                                      batch["insert_know_labels"],
                                      ignore_index=-100)
        result["loss"] = mlm + decode
        result["decode_know_loss"] = decode
    return result


def state_dict_from_jax(params, config):
    """A DKPLMModel state dict from the JAX DKPLMModel's param tree (numpy
    leaves): BERT's (bert/conversion.py) and know_linear's [in, out]
    kernel transposed."""
    state = bert_state_dict_from_jax(params, config)
    know = params["know_linear"]
    state["know_linear.weight"] = torch.tensor(
        np.asarray(know["kernel"], dtype=np.float32).T)
    state["know_linear.bias"] = torch.tensor(
        np.asarray(know["bias"], dtype=np.float32))
    return state
