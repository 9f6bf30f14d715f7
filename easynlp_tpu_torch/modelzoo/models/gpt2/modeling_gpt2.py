"""GPT-2 for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/gpt2/modeling_gpt2.py (pre-LN
causal transformer, learned positions, tied LM head), with the same
numerics:

- parameters are f32; the Conv1D projections compute in `dtype` (bf16 by
  default), the embedding sum in f32 and is then cast, LayerNorm runs in f32
  and is cast back, the residual adds happen in `dtype`, and the head
  multiplies by `wte` cast to `dtype`;
- attention goes through ops/attention.py: the short kernel up to 512 keys,
  the flash forward kernel past it (prefill and decode alike);
- position ids as the JAX model computes them: max(cumsum(mask) - 1, 0) for
  a (left-padded) prompt, the count of filled cache slots in decode.

Unlike the JAX module it keeps one module per layer (an nn.ModuleList, not a
scan) with HF names (`h.{i}.attn.c_attn.weight`, `h.{i}.mlp.c_fc.weight`,
...), so a reference `pytorch_model.bin` loads with
`load_state_dict(strict=True)` after conversion.normalize_keys. Conv1D
weights are [in, out] and compute x @ W + b, as HF's Conv1D (no transpose,
unlike BERT's nn.Linear).

The decode cache is a `KVCache`: one [B,T,H,D] K and V tensor per layer,
written in place at the cache's write index. It replaces the JAX model's
stacked [L,B,T,H,D] scan carry, which exists for the layer scan. A prefill
at index 0 attends causally over the prompt's own keys; a decode step
(s == 1) attends over all T slots under the cache mask, as the JAX model
does, so the kernel choice depends on T alone. Not ported: Switch-MoE
layers (ROADMAP A24), an int8 cache (A16), per-slot write indices for
continuous batching (A17) and chunks written past index 0 (speculative
decoding, A16).
"""

import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    layer_norm,
)
from easynlp_tpu_torch.ops.attention import attention


class Conv1D(nn.Module):
    """HF's GPT-2 projection: weight [in, out], y = x @ W + b."""

    def __init__(self, n_in, n_out, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x, dtype):
        """Applied in `dtype`, as flax Dense with dtype=`dtype` and f32
        params does."""
        return torch.addmm(self.bias.to(dtype), x.reshape(-1, x.shape[-1])
                           .to(dtype), self.weight.to(dtype)).view(
            *x.shape[:-1], self.weight.shape[1])


class KVCache:
    """Per-layer decode cache: k[i], v[i] [B,T,H,D] in the compute dtype,
    mask [B,T] int32 (1 where a slot holds a real token) and the write
    index shared by every row. Updated in place by GPT2Model.forward."""

    def __init__(self, k, v, mask, index=0):
        self.k, self.v, self.mask, self.index = k, v, mask, index

    def reindex(self, rows):
        """A cache of the given batch rows (beam search's gather)."""
        return KVCache([t.index_select(0, rows) for t in self.k],
                       [t.index_select(0, rows) for t in self.v],
                       self.mask.index_select(0, rows), self.index)


class GPT2Attention(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e = config.n_embd
        self.dtype = dtype
        self.num_heads = config.n_head
        self.c_attn = Conv1D(e, 3 * e, device=device)
        self.c_proj = Conv1D(e, e, device=device)
        self.resid_dropout = nn.Dropout(config.resid_pdrop)

    def forward(self, hidden, kv_mask, cache=None, layer_idx=None):
        b, s, e = hidden.shape
        h = self.num_heads
        qkv = self.c_attn(hidden, self.dtype).view(b, s, 3, h, e // h)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None:
            ctx = attention(q, k, v, kv_mask=kv_mask, causal=True)
        else:
            index = cache.index
            if not isinstance(index, int):
                raise NotImplementedError(
                    "a per-slot cache index (continuous batching) is not "
                    "ported yet (ROADMAP A17)")
            if s > 1 and index != 0:
                raise NotImplementedError(
                    "a chunk written past cache index 0 (speculative "
                    "decoding) is not ported yet (ROADMAP A16)")
            k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
            k_full[:, index:index + s] = k
            v_full[:, index:index + s] = v
            if s == 1:
                # single-token decode: every filled cache slot is visible
                ctx = attention(q, k_full, v_full, kv_mask=kv_mask)
            else:
                # prefill at index 0: causal over the prompt's own keys.
                # JAX masks the T - P empty slots with a bias instead; rows
                # with a real query see the same keys either way.
                ctx = attention(q, k, v, kv_mask=kv_mask[:, :s], causal=True)
        out = self.c_proj(ctx.reshape(b, s, e), self.dtype)
        return self.resid_dropout(out)


class GPT2MLP(nn.Module):
    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.dtype = dtype
        self.act = ACT2FN[config.activation_function]
        self.c_fc = Conv1D(config.n_embd, config.n_inner, device=device)
        self.c_proj = Conv1D(config.n_inner, config.n_embd, device=device)
        self.dropout = nn.Dropout(config.resid_pdrop)

    def forward(self, x):
        mlp = self.act(self.c_fc(x, self.dtype))
        return self.dropout(self.c_proj(mlp, self.dtype))


class GPT2Block(nn.Module):
    """One pre-LN block."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        eps = config.layer_norm_epsilon
        self.dtype = dtype
        self.ln_1 = nn.LayerNorm(config.n_embd, eps=eps, device=device)
        self.attn = GPT2Attention(config, dtype=dtype, device=device)
        self.ln_2 = nn.LayerNorm(config.n_embd, eps=eps, device=device)
        self.mlp = GPT2MLP(config, dtype=dtype, device=device)

    def forward(self, hidden, kv_mask, cache=None, layer_idx=None):
        dt = self.dtype
        hidden = hidden + self.attn(layer_norm(self.ln_1, hidden, dt),
                                    kv_mask, cache, layer_idx)
        return hidden + self.mlp(layer_norm(self.ln_2, hidden, dt))


class GPT2Model(nn.Module):
    """Returns {'last_hidden_state': [B,S,E] in `dtype`}, and 'cache' (the
    same KVCache, advanced by S) when a cache is given."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        if getattr(config, "num_experts", 0) > 1:
            raise NotImplementedError(
                "GPT-2 with Switch-MoE layers (num_experts=%d) is not ported "
                "yet (ROADMAP A24)" % config.num_experts)
        self.config = config
        self.dtype = dtype
        self.wte = nn.Embedding(config.vocab_size, config.n_embd,
                                device=device)
        self.wpe = nn.Embedding(config.n_positions, config.n_embd,
                                device=device)
        self.drop = nn.Dropout(config.embd_pdrop)
        self.h = nn.ModuleList(GPT2Block(config, dtype=dtype, device=device)
                               for _ in range(config.n_layer))
        self.ln_f = nn.LayerNorm(config.n_embd, eps=config.layer_norm_epsilon,
                                 device=device)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None):
        b, s = input_ids.shape
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=input_ids.device)
        if position_ids is None:
            position_ids = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
        hidden = self.wte(input_ids) + self.wpe(position_ids)
        hidden = self.drop(hidden).to(self.dtype)
        kv_mask = (attention_mask if cache is None else cache.mask)
        kv_mask = kv_mask.to(torch.int32)
        for i, block in enumerate(self.h):
            hidden = block(hidden, kv_mask, cache, i)
        out = {"last_hidden_state": layer_norm(self.ln_f, hidden, self.dtype)}
        if cache is not None:
            cache.index += s
            out["cache"] = cache
        return out


class GPT2LMHeadModel(nn.Module):
    """GPT2Model under `transformer` and the LM head tied to its `wte`
    (no parameter of its own)."""

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        self.config = config
        self.dtype = dtype
        self.transformer = GPT2Model(config, dtype=dtype, device=device)

    @torch.no_grad()
    def init_weights(self, generator):
        """Truncated-normal(initializer_range) projections and embeddings,
        zero biases, unit LayerNorm scales, drawn from `generator` in module
        order."""
        std = self.config.initializer_range
        for module in self.modules():
            if isinstance(module, (Conv1D, nn.Embedding)):
                truncated_normal_(module.weight, std, generator)
            if isinstance(module, Conv1D):
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()

    def init_cache(self, batch_size, max_length, dtype=None):
        """An empty KVCache of max_length slots (dtype: the compute dtype
        unless given)."""
        c = self.config
        device = self.transformer.wte.weight.device
        shape = (batch_size, max_length, c.n_head, c.n_embd // c.n_head)
        dtype = dtype or self.dtype
        return KVCache(
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.n_layer)],
            [torch.zeros(shape, dtype=dtype, device=device)
             for _ in range(c.n_layer)],
            torch.zeros((batch_size, max_length), dtype=torch.int32,
                        device=device))

    def logits(self, hidden):
        """The tied head: hidden [..., E] @ wte^T in the compute dtype."""
        wte = self.transformer.wte.weight.to(self.dtype)
        return torch.matmul(hidden, wte.t())

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None):
        out = self.transformer(input_ids, attention_mask=attention_mask,
                               position_ids=position_ids, cache=cache)
        out["logits"] = self.logits(out["last_hidden_state"])
        return out
