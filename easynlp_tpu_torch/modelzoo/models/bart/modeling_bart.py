"""BART, Pegasus, Randeng and the dialogue `transformer` for the PyTorch
port.

Counterpart of easynlp_tpu/modelzoo/models/bart/modeling_bart.py: one
encoder-decoder stack whose layout the config's switches set, with the same
numerics.

- BART: post-LN blocks, learned positions with offset 2,
  `layernorm_embedding`, the LM head tied to the decoder's token embedding
  plus `final_logits_bias`.
- Pegasus and Randeng (`normalize_before`, `position_type='sinusoidal'`,
  `scale_embedding`, `final_layer_norm`, no `use_layernorm_embedding`):
  pre-LN blocks, the half-sin/half-cos position table with no offset
  (recomputed, never loaded: a non-persistent buffer), the embeddings
  scaled by sqrt(d_model), and a LayerNorm (`layer_norm`) after each
  stack's last block.
- The dialogue `transformer` (TransformerConfig): post-LN, learned
  positions with offset 0, the embedding LayerNorm and the sqrt(d) scale;
  pre-LN under variant='prelayernorm'.

Parameters are f32; projections compute in `dtype` (bf16 by default),
LayerNorm in f32 cast back to `dtype`, the embedding sum in f32. Attention
goes through ops/attention.py: the encoder's self-attention and the
decoder's cross-attention over a source longer than 512 tokens take the
flash kernels (forward and backward), the decoder's causal self-attention
over its short target the short kernels. The encoder and the decoder each
own their token embedding, as in the JAX model (an HF checkpoint's
`shared.weight` fills both), and the head reads the decoder's.

It keeps one module per layer with HF names
(`model.encoder.layers.{i}.self_attn.q_proj.weight`, ...), so a reference
`pytorch_model.bin` loads strictly after conversion.normalize_keys. The
decode cache is a `Seq2SeqCache`: one [B,T,H,D] self-attention K and V per
decoder layer, written in place at the write index, and the cross-attention
K/V of each layer computed once from the encoder output. It replaces the
JAX model's stacked [L,B,T,H,D] scan carry. A decode step (one token)
attends over all T slots under the mask of the slots below index + 1; a
chunk of s > 1 tokens (a speculative verify round) attends causally over
the first index + s slots, q_offset = index, which keeps it on the
kernels where JAX adds a bias.
"""

import math

import numpy as np
import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    dense,
    layer_norm,
    remat_call,
)
from easynlp_tpu_torch.ops.attention import attention
from easynlp_tpu_torch.parallel.sharding import tied_logits

LN_EPS = 1e-5


def sinusoidal_positions(n_pos, dim):
    """The Pegasus/Marian position table [n_pos, dim] in f32: the first
    dim/2 columns sin, the last dim/2 cos, not interleaved (the JAX
    package's sinusoidal_positions, computed the same way in numpy)."""
    pos = np.arange(n_pos)[:, None]
    div = np.exp(np.arange(0, dim, 2) * -(np.log(10000.0) / dim))
    table = np.zeros((n_pos, dim), np.float32)
    half = (dim + 1) // 2
    table[:, :half] = np.sin(pos * div)
    table[:, half:] = np.cos(pos * div)[:, : dim - half]
    return torch.from_numpy(table)


class Seq2SeqCache:
    """Decoder cache: self-attention k[i], v[i] [B,T,H,D] per layer in the
    compute dtype, the write index shared by every row, and the
    cross-attention K/V per layer ([B,S,H,D], from precompute_cross_kv)."""

    def __init__(self, k, v, index=0, cross_k=None, cross_v=None):
        self.k, self.v, self.index = k, v, index
        self.cross_k, self.cross_v = cross_k, cross_v

    def reindex(self, rows):
        """A cache of the given batch rows (beam search's gather)."""
        pick = (lambda ts: None if ts is None
                else [t.index_select(0, rows) for t in ts])
        return Seq2SeqCache(pick(self.k), pick(self.v), self.index,
                            pick(self.cross_k), pick(self.cross_v))


class BartAttention(nn.Module):
    """q/k/v, the attention and out_proj; over a tensor axis it holds
    num_heads / tp heads (q/k/v column-parallel, out_proj row-parallel:
    parallel/sharding.py)."""

    tensor_parallel_heads = True

    def __init__(self, config, num_heads, dtype=torch.float32, device=None):
        super().__init__()
        e = config.d_model
        self.dtype = dtype
        self.num_heads = num_heads
        self.q_proj = nn.Linear(e, e, device=device)
        self.k_proj = nn.Linear(e, e, device=device)
        self.v_proj = nn.Linear(e, e, device=device)
        self.out_proj = nn.Linear(e, e, device=device)
        self.dropout = nn.Dropout(config.dropout)

    def kv(self, kv_hidden):
        """K and V [B,S,H,D] of kv_hidden [B,S,E] in the compute dtype."""
        b, s, _ = kv_hidden.shape
        h = self.num_heads
        return (dense(self.k_proj, kv_hidden, self.dtype).view(b, s, h, -1),
                dense(self.v_proj, kv_hidden, self.dtype).view(b, s, h, -1))

    def forward(self, hidden, kv_hidden, kv_mask, causal=False, static_kv=None,
                cache=None, layer_idx=None):
        """hidden [B,S,E]; keys from kv_hidden, or static_kv (the cached
        cross K/V), or, with a cache, the layer's self cache after this
        step's K/V are written at the cache index (kv_mask then covers its
        T slots)."""
        b, s, _ = hidden.shape
        h = self.num_heads
        q = dense(self.q_proj, hidden, self.dtype).view(b, s, h, -1)
        k, v = static_kv if static_kv is not None else self.kv(kv_hidden)
        if cache is not None:
            end = cache.index + s
            k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
            k_full[:, cache.index:end] = k
            v_full[:, cache.index:end] = v
            k, v = k_full, v_full
            if s > 1:  # a chunk: causal over the first index + s slots
                k, v, kv_mask = k[:, :end], v[:, :end], kv_mask[:, :end]
            causal = s > 1
        ctx = attention(q, k, v, kv_mask=kv_mask, causal=causal)
        return self.dropout(dense(self.out_proj, ctx.reshape(b, s, -1),
                                  self.dtype))


class BartLayer(nn.Module):
    """One block: self-attention, cross-attention (decoder), FFN, each a
    residual with its LayerNorm after it (post-LN) or, under the config's
    normalize_before, before it (pre-LN).
    `remat` (modeling_bert.set_remat) is its --remat policy while it trains
    without a cache: the whole block is recomputed in the backward, its
    attention kernels included, but for what the policy keeps. As in the
    JAX model (modeling_bart.py:250-252, which tags no activation),
    'selective' keeps every projection's output and 'names' nothing."""

    def __init__(self, config, is_decoder, dtype=torch.float32, device=None):
        super().__init__()
        c = config
        e = c.d_model
        heads = c.decoder_attention_heads if is_decoder \
            else c.encoder_attention_heads
        ffn = c.decoder_ffn_dim if is_decoder else c.encoder_ffn_dim
        self.dtype = dtype
        self.is_decoder = is_decoder
        self.pre = c.normalize_before
        self.remat = "none"
        self.self_attn = BartAttention(c, heads, dtype=dtype, device=device)
        self.self_attn_layer_norm = nn.LayerNorm(e, eps=LN_EPS, device=device)
        if is_decoder:
            self.encoder_attn = BartAttention(c, heads, dtype=dtype,
                                              device=device)
            self.encoder_attn_layer_norm = nn.LayerNorm(e, eps=LN_EPS,
                                                        device=device)
        self.act = ACT2FN[c.activation_function]
        self.activation_dropout = nn.Dropout(c.activation_dropout)
        self.fc1 = nn.Linear(e, ffn, device=device)
        self.fc2 = nn.Linear(ffn, e, device=device)
        self.dropout = nn.Dropout(c.dropout)
        self.final_layer_norm = nn.LayerNorm(e, eps=LN_EPS, device=device)

    def forward(self, hidden, self_mask, enc_hidden=None, enc_mask=None,
                cache=None, layer_idx=None):
        if self.remat != "none" and cache is None and torch.is_grad_enabled():
            return remat_call(self.remat, self._block, hidden, self_mask,
                              enc_hidden, enc_mask)
        return self._block(hidden, self_mask, enc_hidden, enc_mask, cache,
                           layer_idx)

    def _block(self, hidden, self_mask, enc_hidden=None, enc_mask=None,
               cache=None, layer_idx=None):
        dt = self.dtype

        def residual(ln, sublayer, hidden):
            if self.pre:
                return hidden + sublayer(layer_norm(ln, hidden, dt))
            return layer_norm(ln, hidden + sublayer(hidden), dt)

        # with a cache, the self mask covers the cache's slots below
        # index + s (BartAttention adds causality within a chunk)
        hidden = residual(
            self.self_attn_layer_norm,
            lambda x: self.self_attn(x, x, self_mask,
                                     causal=self.is_decoder,
                                     cache=cache, layer_idx=layer_idx),
            hidden)
        if self.is_decoder:
            static = None
            if cache is not None and cache.cross_k is not None:
                static = (cache.cross_k[layer_idx], cache.cross_v[layer_idx])
            hidden = residual(
                self.encoder_attn_layer_norm,
                lambda x: self.encoder_attn(x, enc_hidden, enc_mask,
                                            static_kv=static),
                hidden)
        return residual(self.final_layer_norm, self._ffn, hidden)

    def _ffn(self, x):
        dt = self.dtype
        x = self.activation_dropout(self.act(dense(self.fc1, x, dt)))
        return self.dropout(dense(self.fc2, x, dt))


class BartStack(nn.Module):
    """Token embeddings (scaled by sqrt(d_model) under scale_embedding),
    learned or sinusoidal positions, layernorm_embedding (where
    config.use_layernorm_embedding is set), the layers, and the final
    `layer_norm` (where config.final_layer_norm is set)."""

    def __init__(self, config, is_decoder, dtype=torch.float32, device=None):
        super().__init__()
        c = config
        self.config = c
        self.dtype = dtype
        self.embed_tokens = nn.Embedding(c.vocab_size, c.d_model,
                                         device=device)
        if c.position_type == "learned":
            self.embed_positions = nn.Embedding(
                c.max_position_embeddings + c.position_offset, c.d_model,
                device=device)
        else:
            self.register_buffer(
                "sinusoidal", sinusoidal_positions(c.max_position_embeddings,
                                                   c.d_model).to(device),
                persistent=False)
        # as in the JAX model: only where the config asks for it
        self.layernorm_embedding = (
            nn.LayerNorm(c.d_model, eps=LN_EPS, device=device)
            if c.use_layernorm_embedding else None)
        self.dropout = nn.Dropout(c.dropout)
        n = c.decoder_layers if is_decoder else c.encoder_layers
        self.layers = nn.ModuleList(
            BartLayer(c, is_decoder, dtype=dtype, device=device)
            for _ in range(n))
        self.layer_norm = (nn.LayerNorm(c.d_model, eps=LN_EPS, device=device)
                           if c.final_layer_norm else None)

    def forward(self, input_ids, self_mask, positions, enc_hidden=None,
                enc_mask=None, cache=None):
        c = self.config
        x = self.embed_tokens(input_ids)
        if c.scale_embedding:
            x = x * math.sqrt(c.d_model)
        if c.position_type == "learned":
            x = x + self.embed_positions(positions + c.position_offset)
        else:
            x = x + self.sinusoidal[positions]
        if self.layernorm_embedding is not None:
            x = self.layernorm_embedding(x.float())  # f32, as elsewhere
        x = self.dropout(x).to(self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer(x, self_mask, enc_hidden, enc_mask, cache, i)
        if self.layer_norm is not None:
            x = layer_norm(self.layer_norm, x, self.dtype)
        return x


class BartModel(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.encoder = BartStack(config, False, dtype=dtype, device=device)
        self.decoder = BartStack(config, True, dtype=dtype, device=device)


class BartForConditionalGeneration(nn.Module):
    """BartModel under `model`, the head tied to the decoder's token
    embedding, and `final_logits_bias` [1,V] (HF's shape). Over a tensor
    axis the token embeddings are vocab-parallel, `final_logits_bias`
    splits with the vocabulary and the caches hold each rank's heads."""

    tensor_table = "bart"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.model = BartModel(config, dtype=dtype, device=device)
        self.final_logits_bias = nn.Parameter(
            torch.zeros(1, config.vocab_size, device=device))

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal(0.02) projections and embeddings, zero biases,
        unit LayerNorm scales, drawn from `generator` in module order."""
        for module in self.modules():
            if isinstance(module, (nn.Linear, nn.Embedding)):
                truncated_normal_(module.weight, 0.02, generator)
            if isinstance(module, nn.Linear):
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
        self.final_logits_bias.zero_()

    def encode(self, input_ids, attention_mask=None):
        """Encoder output [B,S,E] in the compute dtype."""
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=input_ids.device)
        positions = torch.arange(s, device=input_ids.device)
        return self.model.encoder(input_ids, attention_mask.to(torch.int32),
                                  positions)

    def logits(self, hidden):
        """The tied head: hidden @ decoder.embed_tokens^T + final_logits_bias,
        in the compute dtype."""
        return tied_logits(self.model.decoder.embed_tokens, hidden,
                           self.dtype, self.final_logits_bias)

    def decode(self, decoder_input_ids, enc_hidden, enc_mask,
               decoder_mask=None, cache=None):
        """(logits [B,S,V] in the compute dtype, cache). Without a cache
        the decoder attends causally under decoder_mask (teacher forcing);
        with one, the S new tokens are written at cache.index.., each sees
        the slots up to its own, and the index advances by S."""
        b, s = decoder_input_ids.shape
        device = decoder_input_ids.device
        if cache is None:
            positions = torch.arange(s, device=device)
            self_mask = (decoder_mask if decoder_mask is not None
                         else torch.ones((b, s), dtype=torch.int32,
                                         device=device)).to(torch.int32)
        else:
            t = cache.k[0].shape[1]
            positions = torch.arange(cache.index, cache.index + s,
                                     device=device)
            self_mask = (torch.arange(t, device=device) < cache.index + s) \
                .to(torch.int32)[None].expand(b, t)
        dec = self.model.decoder(decoder_input_ids, self_mask, positions,
                                 enc_hidden=enc_hidden,
                                 enc_mask=enc_mask.to(torch.int32),
                                 cache=cache)
        if cache is not None:
            cache.index += s
        return self.logits(dec), cache

    def init_cache(self, batch_size, max_length, dtype=None):
        """An empty Seq2SeqCache of max_length self-attention slots."""
        c = self.config
        # the rank's own heads over a tensor axis
        h = self.model.decoder.layers[0].self_attn.num_heads
        shape = (batch_size, max_length, h,
                 c.d_model // c.decoder_attention_heads)
        device = self.final_logits_bias.device
        dtype = dtype or self.dtype
        return Seq2SeqCache(
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.decoder_layers)],
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.decoder_layers)])

    def precompute_cross_kv(self, enc_hidden):
        """([K], [V]): each decoder layer's cross-attention K/V [B,S,H,D]."""
        pairs = [layer.encoder_attn.kv(enc_hidden)
                 for layer in self.model.decoder.layers]
        return [k for k, _ in pairs], [v for _, v in pairs]

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=input_ids.device)
        enc = self.encode(input_ids, attention_mask)
        if decoder_input_ids is None:
            decoder_input_ids = torch.full(
                (b, 1), self.config.decoder_start_token_id, dtype=torch.long,
                device=input_ids.device)
        logits, _ = self.decode(decoder_input_ids, enc, attention_mask,
                                decoder_mask=decoder_attention_mask)
        return {"logits": logits, "encoder_last_hidden_state": enc}
