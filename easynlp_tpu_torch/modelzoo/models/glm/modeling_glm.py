"""GLM (General Language Model, blank infilling) for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/glm/modeling_glm.py, with the
same numerics: GPT-2-style pre-LN blocks with a fused `query_key_value`
projection ([q|k|v] rows, Megatron's order) and gelu_new; learned absolute
positions plus, under block_position_encoding, learned within-span
positions (2-D positions); the LM head tied to `word_embeddings`.
Parameters are f32; projections compute in `dtype`, LayerNorm in f32 cast
back, the embedding sum in f32.

It keeps the reference's names (HF GLMForConditionalGeneration:
`glm.word_embeddings.weight`, `glm.transformer.layers.{i}.attention.
query_key_value.weight`, ...), so a reference `pytorch_model.bin` loads
strictly after conversion.normalize_keys.

Attention visibility, as in JAX (`glm_attention_bias`): key j is visible
from query i iff j < prefix_length (the bidirectional Part A) or j <= i
(the autoregressive Part B), and the key is a real token. The training
forward, the Transformer-XL `mems` forward and a cached prefill (Part A
bidirectional, the `sop` row alone seeing `sop`) carry that as an additive
bias, which takes the plain attention path (B1 takes one causal offset,
not per-row prefix lengths). A cached step whose bidirectional prefix
lies wholly before its first query (GLMCache.prefix_len <= index + 1:
every generation step after the prefill) needs only the cache mask and
causality at offset `index`, so it takes the kernels: a decode step over
all T slots under the mask, a chunk of s > 1 tokens (a speculative
verify round) causally over the first index + s slots. JAX sends both
through its bias (the reference path).

The decode cache is a `GLMCache` (per-layer [B,T,H,D] K and V written in
place at the shared index, the [B,T] mask). `mems` are the JAX layout:
{"h": [L, B, M, E] layer-input hiddens of earlier segments, "mask":
[B, M]}; each forward over mems returns the window slid by the segment.
"""

import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.configuration_utils import PretrainedConfig
from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    dense,
    layer_norm,
    remat_call,
)
from easynlp_tpu_torch.ops.attention import attention
from easynlp_tpu_torch.parallel.sharding import tied_logits

NEG_BIAS = -1e30


class GLMConfig(PretrainedConfig):
    """The JAX GLMConfig's defaults: glm-large-chinese's widths (vocab
    50048, hidden 1024, 24 layers, 16 heads) at 512 positions."""

    model_type = "glm"

    def __init__(self, vocab_size=50048, hidden_size=1024, num_layers=24,
                 num_attention_heads=16, max_sequence_length=512,
                 max_memory_length=0, embedding_dropout_prob=0.1,
                 attention_dropout_prob=0.1, output_dropout_prob=0.1,
                 layernorm_epsilon=1e-5, block_position_encoding=True,
                 initializer_range=0.02, **kwargs):
        self.num_layers = num_layers
        self.max_sequence_length = max_sequence_length
        self.max_memory_length = max_memory_length
        self.embedding_dropout_prob = embedding_dropout_prob
        self.attention_dropout_prob = attention_dropout_prob
        self.output_dropout_prob = output_dropout_prob
        self.layernorm_epsilon = layernorm_epsilon
        self.block_position_encoding = block_position_encoding
        kwargs.setdefault("num_hidden_layers", num_layers)
        kwargs.setdefault("hidden_dropout_prob", output_dropout_prob)
        kwargs.setdefault("is_decoder", True)
        super().__init__(vocab_size=vocab_size, hidden_size=hidden_size,
                         num_attention_heads=num_attention_heads,
                         initializer_range=initializer_range, **kwargs)


class GLMCache:
    """Decode cache: k[i], v[i] [B,T,H,D] per layer in the compute dtype,
    mask [B,T] int32, the shared write index (an int), and prefix_len: an
    int no row's bidirectional prefix exceeds (the prompt width minus one
    after GLM's prefill), which decides the kernel route."""

    def __init__(self, k, v, mask, index=0, prefix_len=None):
        self.k, self.v, self.mask, self.index = k, v, mask, index
        self.prefix_len = prefix_len

    def reindex(self, rows):
        """A cache of the given batch rows (beam search's gather)."""
        return GLMCache([t.index_select(0, rows) for t in self.k],
                        [t.index_select(0, rows) for t in self.v],
                        self.mask.index_select(0, rows), self.index,
                        self.prefix_len)


def glm_attention_bias(prefix_lengths, seq_len):
    """Block-infilling visibility as an additive f32 bias [B, 1, S, S]:
    key j visible from query i iff j < prefix_len or j <= i."""
    dev = prefix_lengths.device
    i = torch.arange(seq_len, device=dev)[:, None]
    j = torch.arange(seq_len, device=dev)[None, :]
    visible = (j <= i)[None] | (j[None] < prefix_lengths[:, None, None])
    return _bias(visible[:, None])


def _bias(visible):
    return torch.zeros(visible.shape, dtype=torch.float32,
                       device=visible.device).masked_fill_(~visible,
                                                           NEG_BIAS)


class GLMAttention(nn.Module):
    """The fused [q|k|v] projection and the output projection; over a
    tensor axis it holds num_heads / tp heads (parallel/sharding.py splits
    query_key_value by head inside each section)."""

    tensor_parallel_heads = True

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e = config.hidden_size
        self.dtype = dtype
        self.num_heads = config.num_attention_heads
        self.query_key_value = nn.Linear(e, 3 * e, device=device)
        self.dense = nn.Linear(e, e, device=device)

    def qkv(self, x):
        b, s, _ = x.shape
        qkv = dense(self.query_key_value, x, self.dtype).view(
            b, s, 3, self.num_heads, -1)
        return qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]


class GLMMLP(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e = config.hidden_size
        self.dtype = dtype
        self.dense_h_to_4h = nn.Linear(e, 4 * e, device=device)
        self.dense_4h_to_h = nn.Linear(4 * e, e, device=device)

    def forward(self, x):
        x = ACT2FN["gelu_new"](dense(self.dense_h_to_4h, x, self.dtype))
        return dense(self.dense_4h_to_h, x, self.dtype)


class GLMLayer(nn.Module):
    """One pre-LN block. `remat` (modeling_bert.set_remat) is its --remat
    policy while it trains without a cache or mems; the JAX block tags no
    activation, so 'selective' keeps every projection's output and
    'names' nothing."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e, eps = config.hidden_size, config.layernorm_epsilon
        self.dtype = dtype
        self.remat = "none"
        self.input_layernorm = nn.LayerNorm(e, eps=eps, device=device)
        self.attention = GLMAttention(config, dtype=dtype, device=device)
        self.post_attention_layernorm = nn.LayerNorm(e, eps=eps,
                                                     device=device)
        self.mlp = GLMMLP(config, dtype=dtype, device=device)
        self.dropout = nn.Dropout(config.output_dropout_prob)

    def forward(self, hidden, bias, cache=None, layer_idx=None, mem=None):
        if self.remat != "none" and cache is None and mem is None \
                and torch.is_grad_enabled():
            return remat_call(self.remat, self._block, hidden, bias)
        return self._block(hidden, bias, cache, layer_idx, mem)

    def _block(self, hidden, bias, cache=None, layer_idx=None, mem=None):
        dt = self.dtype
        b, s, e = hidden.shape
        normed = layer_norm(self.input_layernorm, hidden, dt)
        attn = self.attention
        if mem is not None:
            # Transformer-XL memories: the previous segments' layer-input
            # hiddens through this layer's input LN and qkv; queries cover
            # the current segment, keys [mem; current]
            cat = torch.cat([layer_norm(self.input_layernorm, mem, dt),
                             normed], dim=1)
            q, k, v = attn.qkv(cat)
            ctx = attention(q[:, -s:], k, v, bias=bias)
        else:
            q, k, v = attn.qkv(normed)
            if cache is None:
                ctx = attention(q, k, v, bias=bias)
            else:
                ctx = self._cached(q, k, v, bias, cache, layer_idx)
        out = self.dropout(dense(attn.dense, ctx.reshape(b, s, -1), dt))
        hidden = hidden + out
        mlp = self.mlp(layer_norm(self.post_attention_layernorm, hidden, dt))
        return hidden + self.dropout(mlp)

    @staticmethod
    def _cached(q, k, v, bias, cache, layer_idx):
        s = q.shape[1]
        index, end = cache.index, cache.index + q.shape[1]
        k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
        k_full[:, index:end] = k
        v_full[:, index:end] = v
        if bias is not None:  # the prefill: JAX's bias over all T slots
            return attention(q, k_full, v_full, bias=bias)
        if s == 1:  # a decode step: every written slot is visible
            return attention(q, k_full, v_full, kv_mask=cache.mask)
        return attention(q, k_full[:, :end], v_full[:, :end],
                         kv_mask=cache.mask[:, :end], causal=True)


class GLMStack(nn.Module):
    """The reference's `transformer`: position tables, layers, final LN."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        c = config
        self.position_embeddings = nn.Embedding(
            c.max_sequence_length + 1, c.hidden_size, device=device)
        if c.block_position_encoding:
            self.block_position_embeddings = nn.Embedding(
                c.max_sequence_length + 1, c.hidden_size, device=device)
        self.layers = nn.ModuleList(GLMLayer(c, dtype=dtype, device=device)
                                    for _ in range(c.num_layers))
        self.final_layernorm = nn.LayerNorm(c.hidden_size,
                                            eps=c.layernorm_epsilon,
                                            device=device)


class GLMModel(nn.Module):
    tensor_table = "glm"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(config.vocab_size,
                                            config.hidden_size,
                                            device=device)
        self.transformer = GLMStack(config, dtype=dtype, device=device)
        self.embedding_dropout = nn.Dropout(config.embedding_dropout_prob)

    def init_cache(self, batch_size, max_length, dtype=None):
        c = self.config
        h = c.num_attention_heads
        shape = (batch_size, max_length, h, c.hidden_size // h)
        device = self.word_embeddings.weight.device
        dtype = dtype or self.dtype
        return GLMCache(
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.num_layers)],
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.num_layers)],
            torch.zeros((batch_size, max_length), dtype=torch.int32,
                        device=device))

    def init_mems(self, batch_size, mem_length=None, dtype=None):
        """Empty Transformer-XL memories (the JAX layout, static shapes)."""
        c = self.config
        m = int(mem_length if mem_length is not None
                else c.max_memory_length)
        device = self.word_embeddings.weight.device
        return {"h": torch.zeros((c.num_layers, batch_size, m,
                                  c.hidden_size), dtype=dtype or self.dtype,
                                 device=device),
                "mask": torch.zeros((batch_size, m), dtype=torch.int32,
                                    device=device)}

    def forward(self, input_ids, position_ids=None, block_position_ids=None,
                prefix_lengths=None, attention_mask=None, cache=None,
                mems=None):
        c = self.config
        b, s = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(s, device=dev).expand(b, s)
        stack = self.transformer
        hidden = self.word_embeddings(input_ids) \
            + stack.position_embeddings(position_ids.long())
        if c.block_position_encoding:
            if block_position_ids is None:
                block_position_ids = torch.zeros_like(input_ids)
            hidden = hidden + stack.block_position_embeddings(
                block_position_ids.long())
        hidden = self.embedding_dropout(hidden).to(self.dtype)
        if prefix_lengths is None:
            prefix_lengths = torch.zeros((b,), dtype=torch.long, device=dev)
        prefix_lengths = prefix_lengths.to(dev)
        if cache is None:
            bias = glm_attention_bias(prefix_lengths, s)
            if attention_mask is not None:
                bias = bias.masked_fill(
                    ~attention_mask[:, None, None, :].bool(), NEG_BIAS)
            if mems is not None:
                # memory keys are visible wherever valid
                m_len = mems["h"].shape[2]
                mem_bias = _bias(mems["mask"][:, None, None, :].bool())
                bias = torch.cat([mem_bias.expand(b, 1, s, m_len), bias],
                                 dim=-1)
        elif cache.prefix_len is not None \
                and cache.prefix_len <= cache.index + 1:
            bias = None  # the kernel route (module docstring)
        else:
            t = cache.k[0].shape[1]
            q_pos = cache.index + torch.arange(s, device=dev)
            k_pos = torch.arange(t, device=dev)
            visible = (k_pos[None, None, :] < prefix_lengths[:, None, None]) \
                | (k_pos[None, None, :] <= q_pos[None, :, None])
            visible = visible & cache.mask[:, None, :].bool()
            bias = _bias(visible[:, None])
        h_in = []
        for i, layer in enumerate(stack.layers):
            mem = None
            if mems is not None:
                h_in.append(hidden)
                mem = mems["h"][i].to(self.dtype)
            hidden = layer(hidden, bias, cache, i, mem)
        out = {"last_hidden_state": layer_norm(stack.final_layernorm, hidden,
                                               self.dtype)}
        if cache is not None:
            cache.index += s
            out["cache"] = cache
        if mems is not None:
            # slide the window: the last M of [old mems; this segment's
            # layer inputs]
            m_len = mems["h"].shape[2]
            seg_mask = (attention_mask.to(torch.int32)
                        if attention_mask is not None
                        else torch.ones((b, s), dtype=torch.int32,
                                        device=dev))
            out["mems"] = mems if not m_len else {
                "h": torch.cat([mems["h"], torch.stack(h_in).to(
                    mems["h"].dtype)], dim=2)[:, :, -m_len:],
                "mask": torch.cat([mems["mask"], seg_mask],
                                  dim=-1)[:, -m_len:]}
        return out


class GLMForConditionalGeneration(nn.Module):
    """GLMModel under `glm`, the head tied to its word_embeddings."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.glm = GLMModel(config, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal(initializer_range) projections and embeddings,
        zero biases, unit LayerNorm scales, drawn from `generator` in module
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

    def init_cache(self, batch_size, max_length, dtype=None):
        return self.glm.init_cache(batch_size, max_length, dtype)

    def init_mems(self, batch_size, mem_length=None, dtype=None):
        return self.glm.init_mems(batch_size, mem_length, dtype)

    def logits(self, hidden):
        """The tied head in the compute dtype (gathered over the tensor
        axis when the table is vocab-parallel)."""
        return tied_logits(self.glm.word_embeddings, hidden, self.dtype)

    def forward(self, input_ids, position_ids=None, block_position_ids=None,
                prefix_lengths=None, attention_mask=None, cache=None,
                mems=None):
        out = self.glm(input_ids, position_ids, block_position_ids,
                       prefix_lengths, attention_mask, cache, mems)
        out["logits"] = self.logits(out["last_hidden_state"])
        return out
