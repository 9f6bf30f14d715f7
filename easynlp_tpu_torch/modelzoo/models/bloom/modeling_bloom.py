"""BLOOM for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/bloom/modeling_bloom.py: a
decoder LM with ALiBi biases (no position embeddings), a LayerNorm on the
embeddings, pre-LN blocks with a fused per-head `query_key_value`, and a
head tied to the embeddings. The numerics are the JAX module's: f32
parameters, projections in the compute dtype, LayerNorms in f32 and cast
back, residual adds in the compute dtype, logits in the compute dtype.

ALiBi is an additive bias [B, H, 1, S] (each key's masked position times
its head's slope), so attention takes ops/attention.py's plain path, as
JAX sends it to XLA: BLOOM launches no kernel.

The MLP's activation is BLOOM's tanh-approximate GELU (HF's
`bloom_gelu_forward`), `BLOOM_ACT` below, read when a block is built; the
JAX module uses the exact erf GELU there (ROADMAP reference fault 38).

Modules carry HF's names (`word_embeddings`,
`word_embeddings_layernorm`, `h.{i}.self_attention.query_key_value`,
`h.{i}.mlp.dense_h_to_4h`, `ln_f`; BloomForCausalLM's under
`transformer.`), so an HF `pytorch_model.bin` loads through
`normalize_keys` with no converter.
"""

import math

import numpy as np
import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    dense,
    init_bert_weights,
    layer_norm,
)
from easynlp_tpu_torch.ops.attention import attention
from easynlp_tpu_torch.parallel.sharding import tied_logits

# the MLP's activation (ACT2FN key): BLOOM's tanh GELU; "gelu" gives the
# JAX module's (reference fault 38)
BLOOM_ACT = "gelu_new"


class BloomConfig(PretrainedConfig):
    model_type = "bloom"

    def __init__(self, vocab_size=250880, hidden_size=1024, n_layer=24,
                 n_head=16, layer_norm_epsilon=1e-5, hidden_dropout=0.0,
                 attention_dropout=0.0, initializer_range=0.02,
                 bos_token_id=1, eos_token_id=2, **kwargs):
        self.n_layer = n_layer
        self.n_head = n_head
        self.layer_norm_epsilon = layer_norm_epsilon
        self.hidden_dropout = hidden_dropout
        self.attention_dropout = attention_dropout
        kwargs.setdefault("num_hidden_layers", n_layer)
        kwargs.setdefault("num_attention_heads", n_head)
        kwargs.setdefault("is_decoder", True)
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         initializer_range=initializer_range,
                         bos_token_id=bos_token_id, eos_token_id=eos_token_id,
                         **kwargs)


def alibi_slopes(n_heads):
    """HF BLOOM's slope schedule, f32 [H]."""
    closest = 2 ** math.floor(math.log2(n_heads))
    base = 2.0 ** (-(2.0 ** -(math.log2(closest) - 3)))
    slopes = [base ** (i + 1) for i in range(closest)]
    if closest != n_heads:
        extra_base = 2.0 ** (-(2.0 ** -(math.log2(2 * closest) - 3)))
        slopes += [extra_base ** (2 * i + 1)
                   for i in range(n_heads - closest)]
    return np.asarray(slopes, np.float32)


def alibi_bias(attention_mask, n_heads, heads=None):
    """ALiBi's additive bias [B, H, 1, S], f32: each key's position among
    the row's real tokens (0 at padding) times the head's slope, whatever
    the query (HF's formulation). `heads` (start, count) takes the slopes
    of those heads of the n_heads (a tensor rank's own)."""
    slopes = alibi_slopes(n_heads)
    if heads is not None:
        slopes = slopes[heads[0]:heads[0] + heads[1]]
    slopes = torch.from_numpy(slopes).to(attention_mask.device)
    mask = attention_mask.long()
    positions = ((mask.cumsum(-1) - 1) * mask).float()
    return slopes[None, :, None, None] * positions[:, None, None, :]


class BloomAttention(nn.Module):
    """HF's fused query_key_value ([H, 3, D] over its output features),
    the causal attention under the ALiBi bias, and dense; over a tensor
    axis it holds num_heads / tp heads (whole groups of 3D rows)."""

    tensor_parallel_heads = True

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e = config.hidden_size
        self.dtype = dtype
        self.num_heads = config.n_head
        self.query_key_value = nn.Linear(e, 3 * e, device=device)
        self.dense = nn.Linear(e, e, device=device)

    def forward(self, hidden, bias, kv_mask):
        b, s, _ = hidden.shape
        h = self.num_heads
        # HF's fused layout: [..., H, 3, D] over the output features
        qkv = dense(self.query_key_value, hidden, self.dtype).view(
            b, s, h, 3, -1)
        ctx = attention(qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :],
                        kv_mask=kv_mask, causal=True, bias=bias)
        return dense(self.dense, ctx.reshape(b, s, -1), self.dtype)


class BloomMLP(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e = config.hidden_size
        self.dtype = dtype
        self.act = ACT2FN[BLOOM_ACT]
        self.dense_h_to_4h = nn.Linear(e, 4 * e, device=device)
        self.dense_4h_to_h = nn.Linear(4 * e, e, device=device)

    def forward(self, x):
        return dense(self.dense_4h_to_h, self.act(
            dense(self.dense_h_to_4h, x, self.dtype)), self.dtype)


class BloomBlock(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e, eps = config.hidden_size, config.layer_norm_epsilon
        self.dtype = dtype
        self.input_layernorm = nn.LayerNorm(e, eps=eps, device=device)
        self.self_attention = BloomAttention(config, dtype, device)
        self.post_attention_layernorm = nn.LayerNorm(e, eps=eps,
                                                     device=device)
        self.mlp = BloomMLP(config, dtype, device)
        self.dropout = nn.Dropout(config.hidden_dropout)

    def forward(self, hidden, bias, kv_mask):
        dt = self.dtype
        hidden = hidden + self.dropout(self.self_attention(
            layer_norm(self.input_layernorm, hidden, dt), bias, kv_mask))
        return hidden + self.dropout(self.mlp(
            layer_norm(self.post_attention_layernorm, hidden, dt)))


class BloomModel(nn.Module):
    """Returns {'last_hidden_state': [B, S, E] in the compute dtype}. Over
    a tensor axis word_embeddings is vocab-parallel and the ALiBi bias
    takes the slopes of the rank's own heads."""

    tensor_table = "bloom"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e, eps = config.hidden_size, config.layer_norm_epsilon
        self.config = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(config.vocab_size, e,
                                            device=device)
        self.word_embeddings_layernorm = nn.LayerNorm(e, eps=eps,
                                                      device=device)
        self.h = nn.ModuleList(BloomBlock(config, dtype, device)
                               for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(e, eps=eps, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        init_bert_weights(self, self.config.initializer_range, generator)

    def forward(self, input_ids, attention_mask=None):
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids)
        hidden = layer_norm(self.word_embeddings_layernorm,
                            self.word_embeddings(input_ids), self.dtype)
        attn = self.h[0].self_attention
        bias = alibi_bias(attention_mask, self.config.n_head,
                          (getattr(attn, "head_start", 0), attn.num_heads))
        kv_mask = attention_mask.to(torch.int32)
        for block in self.h:
            hidden = block(hidden, bias, kv_mask)
        return {"last_hidden_state": layer_norm(self.ln_f, hidden,
                                                self.dtype)}


class BloomForCausalLM(nn.Module):
    """BloomModel under `transformer` and the head tied to its
    word_embeddings (no parameter of its own)."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.transformer = BloomModel(config, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        self.transformer.init_weights(generator)

    def forward(self, input_ids, attention_mask=None):
        out = self.transformer(input_ids, attention_mask)
        out["logits"] = tied_logits(self.transformer.word_embeddings,
                                    out["last_hidden_state"], self.dtype)
        return out


def normalize_keys(state_dict):
    """BloomForCausalLM's state dict from an HF BLOOM checkpoint (keys with
    or without `transformer.`; the tied `lm_head.weight` dropped)."""
    out = {}
    for k, v in state_dict.items():
        if k == "lm_head.weight":
            continue
        out[k if k.startswith("transformer.") else "transformer." + k] = v
    return out


def state_dict_from_jax(params, config):
    """BloomForCausalLM's state dict from the JAX module's params: the
    scanned [L, ...] layers unstacked, Dense kernels transposed."""
    p = params["transformer"]

    def t(x):
        return torch.tensor(np.asarray(x, dtype=np.float32))
    state = {"transformer.word_embeddings.weight":
             t(p["word_embeddings"]["embedding"])}

    def ln(key, tree, i=None):
        pick = (lambda x: x) if i is None else (lambda x: x[i])
        state[key + ".weight"] = t(pick(tree["scale"]))
        state[key + ".bias"] = t(pick(tree["bias"]))
    ln("transformer.word_embeddings_layernorm",
       p["word_embeddings_layernorm"])
    ln("transformer.ln_f", p["ln_f"])
    h = p["h"]
    for i in range(config.n_layer):
        base = "transformer.h.%d." % i
        ln(base + "input_layernorm", h["input_layernorm"], i)
        ln(base + "post_attention_layernorm", h["post_attention_layernorm"],
           i)
        for key, name in (("self_attention.query_key_value",
                           "query_key_value"),
                          ("self_attention.dense", "dense"),
                          ("mlp.dense_h_to_4h", "dense_h_to_4h"),
                          ("mlp.dense_4h_to_h", "dense_4h_to_h")):
            state[base + key + ".weight"] = t(
                np.asarray(h[name]["kernel"][i]).T)
            state[base + key + ".bias"] = t(h[name]["bias"][i])
    return state
