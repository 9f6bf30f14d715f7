"""T5 / mT5 for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/t5/modeling_t5.py, with the same
numerics:

- `T5LayerNorm` is an RMS norm in f32 with a scale and no bias, cast back
  to the compute dtype; projections have no bias and compute in `dtype`
  (bf16 by default) on f32 parameters;
- the bucketed relative-position bias is computed once per stack from the
  table of its first block (`relative_attention_bias`, HF's place) and
  shared by every layer; the bucket ids come from f32 logarithms, as in the
  JAX model, computed on the host once per length and kept on the device;
- attention is unscaled (scale 1.0). The self-attentions carry the bias,
  which sends them to ops/attention.py's plain path (as in JAX, where an
  additive bias forces the reference path); the decoder's causal mask is
  folded into its bias as -1e30 while it trains. The cross-attention has
  no bias and takes the kernels: the short kernels over a source of at most
  512 tokens, the flash kernels above;
- the FFN is relu (`wi`, `wo`) or gated (`wi_0`, `wi_1`, `wo`: act(wi_0 x)
  * wi_1 x, mT5); dropout follows the JAX model (after each attention's
  output projection, the FFN's activation and output, and the final norm;
  none on the embeddings);
- the head is the shared embedding scaled by d_model ** -0.5 in the compute
  dtype where the embeddings are tied (T5), else `lm_head` in f32 (mT5).

The modules carry HF T5ForConditionalGeneration's names
(`encoder.block.{i}.layer.0.SelfAttention.q.weight`, `EncDecAttention`,
`DenseReluDense.wi`, `final_layer_norm`, ...), so an HF `pytorch_model.bin`
loads strictly after conversion.normalize_keys. The decode cache is BART's
`Seq2SeqCache` (modeling_bart.py): a self-attention K and V per decoder
layer written in place at the write index, and the cross-attention K/V of
each layer computed once from the encoder output.

`init_weights` follows HF T5's `_init_weights` (factor = the config's
initializer_factor): shared and lm_head N(0, factor), q N(0, factor
(d_model d_kv)^-1/2), k and v N(0, factor d_model^-1/2), o N(0, factor
(H d_kv)^-1/2), the bias table N(0, factor d_model^-1/2), wi (wi_0, wi_1)
N(0, factor d_model^-1/2), wo N(0, factor d_ff^-1/2), norms 1. The JAX
model draws every one of them from N(0, 1), which at full width saturates
every softmax; tests carry JAX's weights across, so parity does not depend
on the initialiser.
"""

import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import one_hot_rows
from easynlp_tpu_torch.modelzoo.models.bart.modeling_bart import Seq2SeqCache
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    remat_call,
)
from easynlp_tpu_torch.ops.attention import attention
from easynlp_tpu_torch.parallel import sharding

NEG_BIAS = -1e30
# the JAX model's activation for each of the config's dense_act_fn
_FFN_ACT = {"relu": "relu", "gelu": "gelu_new", "gelu_new": "gelu_new",
            "silu": "silu"}


def _linear(layer, x, dtype):
    """A bias-free f32 nn.Linear applied in `dtype` (with its collective
    where it is split over a tensor axis)."""
    return sharding.linear(layer, x, dtype)


class T5LayerNorm(nn.Module):
    """RMS norm in f32, a scale and no bias or mean, cast back to the input
    dtype."""

    def __init__(self, d, eps=1e-6, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(d, device=device))
        self.eps = eps

    def forward(self, x):
        h = x.float()
        h = h * torch.rsqrt((h * h).mean(-1, keepdim=True) + self.eps)
        return (h * self.weight).to(x.dtype)


def relative_position_buckets(rel, bidirectional, num_buckets=32,
                              max_distance=128):
    """T5's bucket of each relative position rel = kpos - qpos (an integer
    tensor), with the JAX model's f32 logarithm."""
    if bidirectional:
        num_buckets //= 2
        big = (rel > 0).to(rel.dtype) * num_buckets
        rel = rel.abs()
    else:
        big = torch.zeros_like(rel)
        rel = -torch.clamp(rel, max=0)
    max_exact = num_buckets // 2
    is_small = rel < max_exact
    denom = torch.log(torch.tensor(max_distance / max_exact,
                                   dtype=torch.float32, device=rel.device))
    log_ratio = torch.log(rel.float() / max_exact + 1e-6) / denom
    large = max_exact + (log_ratio * (num_buckets - max_exact)).to(rel.dtype)
    large = torch.clamp(large, max=num_buckets - 1)
    return big + torch.where(is_small, rel, large)


class T5RelativeBias(nn.Embedding):
    """The [buckets, H] bias table (HF's `relative_attention_bias`) and the
    additive bias [1, H, Sq, Skv] it gives queries at q_start + arange(Sq)
    over keys 0..Skv-1."""

    def __init__(self, config, bidirectional, device=None):
        super().__init__(config.relative_attention_num_buckets,
                         config.num_heads, device=device)
        self.bidirectional = bidirectional
        self.max_distance = config.relative_attention_max_distance
        self._luts = {}

    def _lut(self, n, device):
        """Bucket ids of rel = -(N-1) .. N-1 for an N >= n, computed on the
        CPU (the same f32 logarithm whatever the device) and kept on
        `device`; N doubles as longer sequences come."""
        lut = self._luts.get(device)
        if lut is None or (lut.shape[0] + 1) // 2 < n:
            size = 1 << max(n - 1, 1).bit_length()
            rel = torch.arange(-(size - 1), size, dtype=torch.long)
            lut = relative_position_buckets(rel, self.bidirectional,
                                            self.num_embeddings,
                                            self.max_distance).to(device)
            self._luts[device] = lut
        return lut

    def bias(self, q_start, sq, skv):
        device = self.weight.device
        lut = self._lut(max(q_start + sq, skv), device)
        n = (lut.shape[0] + 1) // 2
        rel = (torch.arange(skv, device=device)[None, :]
               - torch.arange(q_start, q_start + sq, device=device)[:, None])
        buckets = lut[rel + (n - 1)]
        # the lookup as a one-hot contraction: its backward sums each of
        # the 32 rows' ~Sq * Skv / 32 terms in a fixed order (C28)
        return one_hot_rows(buckets, self.weight).permute(2, 0, 1)[None]


class T5Attention(nn.Module):
    """q/k/v, the unscaled attention and o; over a tensor axis it holds
    num_heads / tp heads, and the relative table its heads' columns (JAX
    `(None, "heads")`)."""

    tensor_parallel_heads = True

    def __init__(self, config, has_relative_bias=False, bidirectional=True,
                 dtype=torch.float32, device=None):
        super().__init__()
        inner = config.num_heads * config.d_kv
        self.dtype = dtype
        self.num_heads, self.d_kv = config.num_heads, config.d_kv
        self.q = nn.Linear(config.d_model, inner, bias=False, device=device)
        self.k = nn.Linear(config.d_model, inner, bias=False, device=device)
        self.v = nn.Linear(config.d_model, inner, bias=False, device=device)
        self.o = nn.Linear(inner, config.d_model, bias=False, device=device)
        if has_relative_bias:
            self.relative_attention_bias = T5RelativeBias(
                config, bidirectional, device=device)
        self.dropout = nn.Dropout(config.dropout_rate)

    def kv(self, kv_hidden):
        """K and V [B,S,H,D] of kv_hidden [B,S,E] in the compute dtype."""
        b, s, _ = kv_hidden.shape
        h, d = self.num_heads, self.d_kv
        return (_linear(self.k, kv_hidden, self.dtype).view(b, s, h, d),
                _linear(self.v, kv_hidden, self.dtype).view(b, s, h, d))

    def forward(self, hidden, kv_hidden, kv_mask, bias=None, static_kv=None,
                cache=None, layer_idx=None):
        """As BartAttention.forward, unscaled, with an optional additive
        bias [1|B, H, Sq, Skv]."""
        b, s, _ = hidden.shape
        h, d = self.num_heads, self.d_kv
        q = _linear(self.q, hidden, self.dtype).view(b, s, h, d)
        k, v = static_kv if static_kv is not None else self.kv(kv_hidden)
        if cache is not None:
            k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
            k_full[:, cache.index:cache.index + s] = k
            v_full[:, cache.index:cache.index + s] = v
            k, v = k_full, v_full
        ctx = attention(q, k, v, kv_mask=kv_mask, scale=1.0, bias=bias)
        return self.dropout(_linear(self.o, ctx.reshape(b, s, h * d),
                                    self.dtype))


class T5DenseActDense(nn.Module):
    """HF's DenseReluDense: wi (or wi_0 and wi_1, gated), the activation,
    dropout, wo."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e, f = config.d_model, config.d_ff
        self.dtype = dtype
        self.gated = config.is_gated_act
        if self.gated:
            self.wi_0 = nn.Linear(e, f, bias=False, device=device)
            self.wi_1 = nn.Linear(e, f, bias=False, device=device)
        else:
            self.wi = nn.Linear(e, f, bias=False, device=device)
        self.wo = nn.Linear(f, e, bias=False, device=device)
        self.act = ACT2FN[_FFN_ACT[config.dense_act_fn]]
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, x):
        dt = self.dtype
        if self.gated:
            x = self.act(_linear(self.wi_0, x, dt)) * _linear(self.wi_1, x, dt)
        else:
            x = self.act(_linear(self.wi, x, dt))
        return _linear(self.wo, self.dropout(x), dt)


class T5LayerSelfAttention(nn.Module):
    def __init__(self, config, has_relative_bias, bidirectional, dtype,
                 device):
        super().__init__()
        self.SelfAttention = T5Attention(config, has_relative_bias,
                                         bidirectional, dtype=dtype,
                                         device=device)
        self.layer_norm = T5LayerNorm(config.d_model,
                                      config.layer_norm_epsilon, device)


class T5LayerCrossAttention(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.EncDecAttention = T5Attention(config, dtype=dtype, device=device)
        self.layer_norm = T5LayerNorm(config.d_model,
                                      config.layer_norm_epsilon, device)


class T5LayerFF(nn.Module):
    def __init__(self, config, dtype, device):
        super().__init__()
        self.DenseReluDense = T5DenseActDense(config, dtype=dtype,
                                              device=device)
        self.layer_norm = T5LayerNorm(config.d_model,
                                      config.layer_norm_epsilon, device)
        self.dropout = nn.Dropout(config.dropout_rate)


class T5Block(nn.Module):
    """One pre-norm block: self-attention, cross-attention (decoder), FFN,
    each a residual. `remat` is its --remat policy while it trains without
    a cache (modeling_bert.set_remat), as BartLayer's."""

    def __init__(self, config, is_decoder, has_relative_bias=False,
                 dtype=torch.float32, device=None):
        super().__init__()
        self.is_decoder = is_decoder
        self.remat = "none"
        parts = [T5LayerSelfAttention(config, has_relative_bias,
                                      not is_decoder, dtype, device)]
        if is_decoder:
            parts.append(T5LayerCrossAttention(config, dtype, device))
        parts.append(T5LayerFF(config, dtype, device))
        self.layer = nn.ModuleList(parts)

    def forward(self, hidden, self_mask, bias, enc_hidden=None, enc_mask=None,
                cache=None, layer_idx=None):
        if self.remat != "none" and cache is None and torch.is_grad_enabled():
            return remat_call(self.remat, self._block, hidden, self_mask,
                              bias, enc_hidden, enc_mask)
        return self._block(hidden, self_mask, bias, enc_hidden, enc_mask,
                           cache, layer_idx)

    def _block(self, hidden, self_mask, bias, enc_hidden=None, enc_mask=None,
               cache=None, layer_idx=None):
        sa = self.layer[0]
        normed = sa.layer_norm(hidden)
        hidden = hidden + sa.SelfAttention(normed, normed, self_mask,
                                           bias=bias, cache=cache,
                                           layer_idx=layer_idx)
        if self.is_decoder:
            ca = self.layer[1]
            static = None
            if cache is not None and cache.cross_k is not None:
                static = (cache.cross_k[layer_idx], cache.cross_v[layer_idx])
            hidden = hidden + ca.EncDecAttention(ca.layer_norm(hidden),
                                                 enc_hidden, enc_mask,
                                                 static_kv=static)
        ff = self.layer[-1]
        return hidden + ff.dropout(ff.DenseReluDense(ff.layer_norm(hidden)))


class T5Stack(nn.Module):
    def __init__(self, config, is_decoder, dtype=torch.float32, device=None):
        super().__init__()
        n = config.num_decoder_layers if is_decoder else config.num_layers
        self.is_decoder = is_decoder
        self.dtype = dtype
        self.block = nn.ModuleList(
            T5Block(config, is_decoder, has_relative_bias=i == 0,
                    dtype=dtype, device=device) for i in range(n))
        self.final_layer_norm = T5LayerNorm(config.d_model,
                                            config.layer_norm_epsilon, device)
        self.dropout = nn.Dropout(config.dropout_rate)

    def forward(self, hidden, self_mask, q_start=0, enc_hidden=None,
                enc_mask=None, cache=None):
        """hidden [B,S,E] in the compute dtype, its queries at positions
        q_start.. (the cache index while decoding); with a cache the keys
        are its slots."""
        s = hidden.shape[1]
        skv = s if cache is None else cache.k[0].shape[1]
        table = self.block[0].layer[0].SelfAttention.relative_attention_bias
        bias = table.bias(q_start, s, skv)
        if self.is_decoder and (cache is None or s > 1):
            # teacher forcing, or a cached chunk (a speculative verify
            # round): query q_start + i sees the keys up to its position
            causal = (torch.arange(skv, device=hidden.device)[None, :]
                      <= torch.arange(q_start, q_start + s,
                                      device=hidden.device)[:, None])
            bias = bias.masked_fill(~causal, NEG_BIAS)
        for i, block in enumerate(self.block):
            hidden = block(hidden, self_mask, bias, enc_hidden, enc_mask,
                           cache, i)
        return self.dropout(self.final_layer_norm(hidden)).to(self.dtype)


class T5ForConditionalGeneration(nn.Module):
    """Over a tensor axis `shared` is vocab-parallel, mT5's `lm_head`
    column-parallel over the vocabulary (its columns gathered) and the
    caches hold each rank's heads."""

    tensor_table = "t5"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.shared = nn.Embedding(config.vocab_size, config.d_model,
                                   device=device)
        self.encoder = T5Stack(config, False, dtype=dtype, device=device)
        self.decoder = T5Stack(config, True, dtype=dtype, device=device)
        if not config.tie_word_embeddings:
            self.lm_head = nn.Linear(config.d_model, config.vocab_size,
                                     bias=False, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """HF T5's initialisation (the module docstring), drawn from
        `generator` in module order."""
        c = self.config
        f = c.initializer_factor
        std = {"q": (c.d_model * c.d_kv) ** -0.5, "k": c.d_model ** -0.5,
               "v": c.d_model ** -0.5, "o": (c.num_heads * c.d_kv) ** -0.5,
               "wi": c.d_model ** -0.5, "wi_0": c.d_model ** -0.5,
               "wi_1": c.d_model ** -0.5, "wo": c.d_ff ** -0.5,
               "relative_attention_bias": c.d_model ** -0.5,
               "shared": 1.0, "lm_head": 1.0}
        for name, module in self.named_modules():
            if isinstance(module, T5LayerNorm):
                module.weight.fill_(f)
            elif isinstance(module, (nn.Linear, nn.Embedding)):
                module.weight.normal_(0.0, f * std[name.rsplit(".", 1)[-1]],
                                      generator=generator)

    def encode(self, input_ids, attention_mask=None):
        """Encoder output [B,S,E] in the compute dtype."""
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
        hidden = self.shared(input_ids).to(self.dtype)
        return self.encoder(hidden, attention_mask.to(torch.int32))

    def logits(self, hidden):
        """T5: hidden * d_model^-1/2 @ shared^T in the compute dtype; mT5:
        lm_head in f32."""
        if self.config.tie_word_embeddings:
            hidden = hidden * (self.config.d_model ** -0.5)
            return sharding.tied_logits(self.shared, hidden, self.dtype)
        return _linear(self.lm_head, hidden.float(), torch.float32)

    def decode(self, decoder_input_ids, enc_hidden, enc_mask,
               decoder_mask=None, cache=None):
        """(logits [B,S,V], cache), as BartForConditionalGeneration.decode:
        teacher forcing (causal, under decoder_mask) without a cache; with
        one, the S new tokens at cache.index.., each over the slots up to
        its own."""
        b, s = decoder_input_ids.shape
        device = decoder_input_ids.device
        if cache is None:
            q_start = 0
            self_mask = (decoder_mask if decoder_mask is not None
                         else torch.ones((b, s), dtype=torch.int32,
                                         device=device)).to(torch.int32)
        else:
            t = cache.k[0].shape[1]
            q_start = cache.index
            self_mask = (torch.arange(t, device=device) < cache.index + s) \
                .to(torch.int32)[None].expand(b, t)
        hidden = self.shared(decoder_input_ids).to(self.dtype)
        dec = self.decoder(hidden, self_mask, q_start, enc_hidden=enc_hidden,
                           enc_mask=enc_mask.to(torch.int32), cache=cache)
        if cache is not None:
            cache.index += s
        return self.logits(dec), cache

    def init_cache(self, batch_size, max_length, dtype=None):
        """An empty Seq2SeqCache of max_length self-attention slots."""
        c = self.config
        # the rank's own heads over a tensor axis
        heads = self.decoder.block[0].layer[0].SelfAttention.num_heads
        shape = (batch_size, max_length, heads, c.d_kv)
        device = self.shared.weight.device
        dtype = dtype or self.dtype
        return Seq2SeqCache(
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.num_decoder_layers)],
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.num_decoder_layers)])

    def precompute_cross_kv(self, enc_hidden):
        """([K], [V]): each decoder layer's cross-attention K/V [B,S,H,D]."""
        pairs = [block.layer[1].EncDecAttention.kv(enc_hidden)
                 for block in self.decoder.block]
        return [k for k, _ in pairs], [v for _, v in pairs]

    def forward(self, input_ids, attention_mask=None, decoder_input_ids=None,
                decoder_attention_mask=None):
        b = input_ids.shape[0]
        if attention_mask is None:
            attention_mask = torch.ones_like(input_ids, dtype=torch.int32)
        enc = self.encode(input_ids, attention_mask)
        if decoder_input_ids is None:
            decoder_input_ids = torch.full(
                (b, 1), self.config.decoder_start_token_id, dtype=torch.long,
                device=input_ids.device)
        logits, _ = self.decode(decoder_input_ids, enc, attention_mask,
                                decoder_mask=decoder_attention_mask)
        return {"logits": logits, "encoder_last_hidden_state": enc}
