"""BERT encoder for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/bert/modeling_bert.py (post-LN
BertEmbeddings, BertAttention, BertLayer, BertEncoder, BertPooler,
BertModel, BertMLMHead, BertForMaskedLM), with the same numerics:

- parameters are f32; the dense layers compute in `dtype` (bf16 by default)
  and LayerNorm in f32, casting back to `dtype`;
- attention goes through ops/attention.py, which launches the hand-written
  CUDA kernel on a card;
- erf-gelu, LayerNorm eps from the config, truncated-normal init;
- RoBERTa's position ids where the config asks for them
  (`position_ids_from_padding_idx`, RobertaConfig): the non-pad tokens
  count from pad + 1, pad positions stay at pad.

Unlike the JAX module it keeps one module per layer (an nn.ModuleList, not a
scan) and separate query/key/value projections, so parameter names are the
HF ones (`encoder.layer.{i}.attention.self.query.weight`, ...) and a
reference `pytorch_model.bin` loads with `load_state_dict(strict=True)` after
key normalisation (conversion.py). Not ported yet: output_scores /
output_attentions, output_hidden_states and pre-LN (ROADMAP A3, A13).
"""

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.ops.attention import attention

ACT2FN = {
    "gelu": lambda x: F.gelu(x, approximate="none"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "quick_gelu": lambda x: x * torch.sigmoid(1.702 * x),
    "relu": F.relu,
    "swish": F.silu,
    "silu": F.silu,
    "tanh": torch.tanh,
}


def dense(layer, x, dtype):
    """`layer` (an f32 nn.Linear) applied in `dtype`, as flax Dense with
    dtype=`dtype` and f32 params does."""
    return F.linear(x.to(dtype), layer.weight.to(dtype),
                    layer.bias.to(dtype))


def layer_norm(layer, x, dtype):
    """f32 LayerNorm whatever the compute dtype, cast back to `dtype`."""
    return layer(x.float()).to(dtype)


class BertEmbeddings(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        c = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(c.vocab_size, c.hidden_size,
                                            device=device)
        self.position_embeddings = nn.Embedding(
            c.max_position_embeddings, c.hidden_size, device=device)
        self.token_type_embeddings = (
            nn.Embedding(c.type_vocab_size, c.hidden_size, device=device)
            if c.type_vocab_size else None)
        self.LayerNorm = nn.LayerNorm(c.hidden_size, eps=c.layer_norm_eps,
                                      device=device)
        self.dropout = nn.Dropout(c.hidden_dropout_prob)

    def forward(self, input_ids, token_type_ids, position_ids):
        emb = self.word_embeddings(input_ids) \
            + self.position_embeddings(position_ids)
        if self.token_type_embeddings is not None:
            emb = emb + self.token_types(token_type_ids)
        # f32 LayerNorm: the sum is bf16 when serving casts the tables
        emb = self.LayerNorm(emb.float())
        return self.dropout(emb).to(self.dtype)


    def token_types(self, token_type_ids):
        """The token-type rows of the ids, selected type by type with
        torch.where: exact, and its gradient is a sum over each type's
        positions in a fixed order. (nn.Embedding's CUDA backward sums a row
        that thousands of positions share, as type 0 is, in an order that
        changes from run to run, so two runs of one training step would
        not give the same bits.)"""
        table = self.token_type_embeddings.weight
        out = table[0].expand(*token_type_ids.shape, table.shape[1])
        for t in range(1, table.shape[0]):
            out = torch.where((token_type_ids == t)[..., None], table[t], out)
        return out


class BertSelfAttention(nn.Module):
    """The q/k/v projections (HF's `attention.self`)."""

    def __init__(self, config, device=None):
        super().__init__()
        e = config.hidden_size
        self.query = nn.Linear(e, e, device=device)
        self.key = nn.Linear(e, e, device=device)
        self.value = nn.Linear(e, e, device=device)


class BertSelfOutput(nn.Module):
    """Output projection + post-LN (HF's `attention.output`)."""

    def __init__(self, config, device=None):
        super().__init__()
        e = config.hidden_size
        self.dense = nn.Linear(e, e, device=device)
        self.LayerNorm = nn.LayerNorm(e, eps=config.layer_norm_eps,
                                      device=device)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)


class BertAttention(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.num_heads = config.num_attention_heads
        self.self = BertSelfAttention(config, device=device)
        self.output = BertSelfOutput(config, device=device)

    def forward(self, hidden, kv_mask):
        """hidden [B,S,E] in dtype, kv_mask [B,S] int32 → LN(hidden +
        attention) [B,S,E] in dtype."""
        b, s, e = hidden.shape
        h, dt = self.num_heads, self.dtype
        q = dense(self.self.query, hidden, dt).view(b, s, h, e // h)
        k = dense(self.self.key, hidden, dt).view(b, s, h, e // h)
        v = dense(self.self.value, hidden, dt).view(b, s, h, e // h)
        ctx = attention(q, k, v, kv_mask=kv_mask).reshape(b, s, e)
        out = self.output.dropout(dense(self.output.dense, ctx, dt))
        return layer_norm(self.output.LayerNorm, hidden + out, dt)


class BertIntermediate(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        self.dense = nn.Linear(config.hidden_size, config.intermediate_size,
                               device=device)


class BertOutput(nn.Module):
    def __init__(self, config, device=None):
        super().__init__()
        self.dense = nn.Linear(config.intermediate_size, config.hidden_size,
                               device=device)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps,
                                      device=device)
        self.dropout = nn.Dropout(config.hidden_dropout_prob)


class BertLayer(nn.Module):
    """One post-LN transformer block."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.act = ACT2FN[config.hidden_act]
        self.attention = BertAttention(config, dtype=dtype, device=device)
        self.intermediate = BertIntermediate(config, device=device)
        self.output = BertOutput(config, device=device)

    def forward(self, hidden, kv_mask):
        dt = self.dtype
        hidden = self.attention(hidden, kv_mask)
        mlp = self.act(dense(self.intermediate.dense, hidden, dt))
        mlp = self.output.dropout(dense(self.output.dense, mlp, dt))
        return layer_norm(self.output.LayerNorm, hidden + mlp, dt)


class BertEncoder(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.layer = nn.ModuleList(
            BertLayer(config, dtype=dtype, device=device)
            for _ in range(config.num_hidden_layers))

    def forward(self, hidden, kv_mask):
        for layer in self.layer:
            hidden = layer(hidden, kv_mask)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=device)

    def forward(self, hidden):
        return torch.tanh(dense(self.dense, hidden[:, 0], self.dtype))


class BertModel(nn.Module):
    """Returns {'last_hidden_state': [B,S,E], 'pooler_output': [B,E]}, both
    in `dtype`."""

    def __init__(self, config, dtype=torch.float32, add_pooling_layer=True,
                 device=None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, dtype=dtype, device=device)
        self.encoder = BertEncoder(config, dtype=dtype, device=device)
        self.pooler = (BertPooler(config, dtype=dtype, device=device)
                       if add_pooling_layer else None)

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal(initializer_range) kernels and embeddings, zero
        biases, unit LayerNorm scales, drawn from `generator` in module
        order."""
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                truncated_normal_(module.weight, std, generator)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        b, s = input_ids.shape
        device = input_ids.device
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=device)
        if token_type_ids is None:
            token_type_ids = torch.zeros((b, s), dtype=torch.int32,
                                         device=device)
        if position_ids is None:
            if getattr(self.config, "position_ids_from_padding_idx", False):
                pad = self.config.pad_token_id
                not_pad = (input_ids != pad).to(torch.int64)
                position_ids = torch.cumsum(not_pad, dim=1) * not_pad + pad
            else:
                position_ids = torch.arange(s, device=device)[None, :] \
                    .expand(b, s)
        # int32 once here, so no layer converts the mask again
        kv_mask = attention_mask.to(torch.int32).contiguous()
        hidden = self.embeddings(input_ids, token_type_ids, position_ids)
        hidden = self.encoder(hidden, kv_mask)
        out = {"last_hidden_state": hidden}
        if self.pooler is not None:
            out["pooler_output"] = self.pooler(hidden)
        return out


class BertMLMHead(nn.Module):
    """The MLM head: dense -> activation -> f32 LayerNorm, then the decoder
    tied to the word embeddings (a plain matmul with their [V, E] table in
    `dtype`) plus a vocab bias, both in `dtype`, as the JAX head computes
    them."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.act = ACT2FN[config.hidden_act]
        self.dense = nn.Linear(config.hidden_size, config.hidden_size,
                               device=device)
        self.LayerNorm = nn.LayerNorm(config.hidden_size,
                                      eps=config.layer_norm_eps,
                                      device=device)
        self.bias = nn.Parameter(torch.zeros(config.vocab_size,
                                             device=device))

    def forward(self, hidden, word_embeddings):
        dt = self.dtype
        h = layer_norm(self.LayerNorm, self.act(dense(self.dense, hidden,
                                                      dt)), dt)
        return torch.matmul(h, word_embeddings.to(dt).t()) + self.bias.to(dt)


class BertForMaskedLM(nn.Module):
    """BertModel without a pooler and the tied MLM head. Returns {'logits':
    [B,S,V], 'last_hidden_state': [B,S,E]}, both in `dtype`."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.bert = BertModel(config, dtype=dtype, add_pooling_layer=False,
                              device=device)
        self.cls = BertMLMHead(config, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """The backbone's init, then the head's: truncated-normal dense,
        unit LayerNorm, zero biases."""
        self.bert.init_weights(generator)
        truncated_normal_(self.cls.dense.weight,
                          self.config.initializer_range, generator)
        self.cls.dense.bias.zero_()
        self.cls.LayerNorm.weight.fill_(1.0)
        self.cls.LayerNorm.bias.zero_()
        self.cls.bias.zero_()

    def forward(self, input_ids, attention_mask=None, token_type_ids=None,
                position_ids=None):
        out = self.bert(input_ids, attention_mask, token_type_ids,
                        position_ids)
        logits = self.cls(out["last_hidden_state"],
                          self.bert.embeddings.word_embeddings.weight)
        return {"logits": logits, **out}
