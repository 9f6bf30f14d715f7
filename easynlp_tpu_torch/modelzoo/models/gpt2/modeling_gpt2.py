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
stacked [L,B,T,H,D] scan carry, which exists for the layer scan. Three
cache paths, as the JAX model's:

- a chunk of s > 1 tokens at a scalar index (a prompt prefill at 0, a
  shared-prefix admit past it) is written at index..index+s-1 and attends
  causally over the first index + s slots under the cache mask. JAX masks
  the later slots with an additive bias; here causal=True with
  q_offset = (index + s) - s = index hides the same keys and keeps the call
  on the kernels (a bias would force the plain path);
- a single-token decode step (s == 1) attends over all T slots under the
  cache mask, as the JAX model does, so the kernel choice depends on T
  alone;
- a per-slot index ([B] LongTensor, continuous batching) scatters each
  row's s new tokens at its own index..index+s-1. A decode step (s == 1)
  sees what the mask shows; a chunk of s > 1 tokens (a speculative verify
  round, each row at its own offset) adds the JAX model's per-row causal
  bias [B,1,S,T] and so takes the plain path: B1 takes one query offset
  for the whole batch.

The int8 cache (`init_cache(..., quantize=True)`) holds int8 K and V with
f32 per-(token, head) scales, symmetric (scale = max(max|x| / 127, 1e-8)
over the head dim, computed in the compute dtype as the JAX model does);
reads dequantize the layer's slots in the compute dtype and then take the
same kernels. It takes a shared write index only, as in JAX.

With config.num_experts > 1 every block's MLP is a Switch-MoE FFN
(ops/moe.py, JAX modeling_gpt2.py:203-214) under the name `moe`, and the
model returns `moe_aux_loss`: router_aux_loss_coef times the mean of the
layers' load-balancing losses (:278-290). Over a sequence axis
parallelize makes the layers attend by the ring (:76): each rank runs its
S/n tokens and the output is gathered whole (parallel/sequence.py).

Over a tensor axis (parallel/sharding.py, JAX's logical axes at
:70/:175/:217-220/:245) each Conv1D becomes column- or row-parallel, the
attention keeps its rank's heads (`num_heads` is the local count; the head
dim stays n_embd // n_head), the decode caches hold those heads only, and
`wte` is vocab-parallel: the head gathers every rank's logit columns, so
each rank holds the whole row with the padding of an odd vocabulary cut.
"""

import torch
from torch import nn

from easynlp_tpu_torch.modelzoo.modeling_utils import truncated_normal_
from easynlp_tpu_torch.modelzoo.models.bert.modeling_bert import (
    ACT2FN,
    layer_norm,
)
from easynlp_tpu_torch.ops.attention import attention
from easynlp_tpu_torch.ops.moe import SwitchMoE
from easynlp_tpu_torch.parallel import comm
from easynlp_tpu_torch.parallel.sequence import (
    gather_tokens,
    local_tokens,
    sequence_group,
)
from easynlp_tpu_torch.parallel.sharding import tied_logits


class Conv1D(nn.Module):
    """HF's GPT-2 projection: weight [in, out], y = x @ W + b.

    Under a tensor group (`tensor_parallel` = ('column' | 'row', group),
    set by parallel/sharding.py) the weight holds this rank's output
    columns (its input's gradient is summed over the group) or its input
    rows (the partial products are summed over the group, then the bias is
    added once)."""

    # the weight is [in, out] (nn.Linear's is [out, in]): sharding reads it
    weight_in_out = True
    tensor_parallel = None

    def __init__(self, n_in, n_out, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(n_in, n_out, device=device))
        self.bias = nn.Parameter(torch.zeros(n_out, device=device))

    def forward(self, x, dtype):
        """Applied in `dtype`, as flax Dense with dtype=`dtype` and f32
        params does."""
        shape = (*x.shape[:-1], self.weight.shape[1])
        w, b = self.weight.to(dtype), self.bias.to(dtype)
        if self.tensor_parallel is None:
            return torch.addmm(b, x.reshape(-1, x.shape[-1]).to(dtype),
                               w).view(shape)
        kind, group = self.tensor_parallel
        if kind == "column":
            x = comm.copy_to_group(x, group)
            return torch.addmm(b, x.reshape(-1, x.shape[-1]).to(dtype),
                               w).view(shape)
        out = torch.mm(x.reshape(-1, x.shape[-1]).to(dtype), w).view(shape)
        return comm.reduce_from_group(out, group) + b


class KVCache:
    """Per-layer decode cache: k[i], v[i] [B,T,H,D] in the compute dtype
    (int8 where k_scale/v_scale, per layer [B,T,H] f32, are given), mask
    [B,T] int32 (1 where a slot holds a real token) and the write index:
    an int shared by every row, or a [B] LongTensor of per-row indices.
    Updated in place by GPT2Model.forward."""

    def __init__(self, k, v, mask, index=0, k_scale=None, v_scale=None):
        self.k, self.v, self.mask, self.index = k, v, mask, index
        self.k_scale, self.v_scale = k_scale, v_scale

    def reindex(self, rows):
        """A cache of the given batch rows (beam search's gather)."""
        pick = (lambda ts: None if ts is None
                else [t.index_select(0, rows) for t in ts])
        return KVCache(pick(self.k), pick(self.v),
                       self.mask.index_select(0, rows), self.index,
                       pick(self.k_scale), pick(self.v_scale))


def quantize_kv(x):
    """(int8 x, f32 scale [..., H]) of x [..., H, D], per (token, head), in
    x's dtype as the JAX model computes it."""
    absmax = x.abs().amax(dim=-1)
    # a tensor divisor (CUDA divides by a Python scalar through its
    # reciprocal, which rounds otherwise than JAX's division)
    scale = (absmax / torch.full_like(absmax, 127.0)).clamp(min=1e-8)
    q = torch.round(x / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale.float()


@torch.no_grad()
def init_gpt2_weights(module, std, generator):
    """Truncated-normal(std) projections and embeddings, zero biases, unit
    LayerNorm scales, drawn from `generator` in module order."""
    for m in module.modules():
        if isinstance(m, (Conv1D, nn.Embedding)):
            truncated_normal_(m.weight, std, generator)
        if isinstance(m, SwitchMoE):
            for p in (m.router, m.wi, m.wo):
                truncated_normal_(p, std, generator)
            m.bi.zero_()
            m.bo.zero_()
        if isinstance(m, Conv1D):
            m.bias.zero_()
        elif isinstance(m, nn.LayerNorm):
            m.weight.fill_(1.0)
            m.bias.zero_()


class GPT2Attention(nn.Module):
    # parallelize divides num_heads by the tensor group's size
    tensor_parallel_heads = True

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
        e = config.n_embd
        self.dtype = dtype
        self.num_heads = config.n_head
        self.head_dim = e // config.n_head
        self.impl = "auto"
        self.c_attn = Conv1D(e, 3 * e, device=device)
        self.c_proj = Conv1D(e, e, device=device)
        self.resid_dropout = nn.Dropout(config.resid_pdrop)

    def forward(self, hidden, kv_mask, cache=None, layer_idx=None):
        b, s = hidden.shape[:2]
        h, d = self.num_heads, self.head_dim
        qkv = self.c_attn(hidden, self.dtype).view(b, s, 3, h, d)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if cache is None:
            ctx = attention(q, k, v, kv_mask=kv_mask, causal=True,
                            impl=self.impl)
        elif torch.is_tensor(cache.index):
            ctx = self._per_slot(q, k, v, kv_mask, cache, layer_idx)
        else:
            index = cache.index
            # a decode step reads all T slots (the kernel choice then
            # depends on T alone), a chunk the first index + s
            end = index + s
            seen = cache.k[layer_idx].shape[1] if s == 1 \
                else end
            k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
            if cache.k_scale is None:
                k_full[:, index:end] = k
                v_full[:, index:end] = v
                k_read, v_read = k_full[:, :seen], v_full[:, :seen]
            else:
                ks_full = cache.k_scale[layer_idx]
                vs_full = cache.v_scale[layer_idx]
                k_full[:, index:end], ks_full[:, index:end] = quantize_kv(k)
                v_full[:, index:end], vs_full[:, index:end] = quantize_kv(v)
                dt = self.dtype
                k_read = k_full[:, :seen].to(dt) \
                    * ks_full[:, :seen, :, None].to(dt)
                v_read = v_full[:, :seen].to(dt) \
                    * vs_full[:, :seen, :, None].to(dt)
            if s == 1:
                # single-token decode: every filled cache slot is visible
                ctx = attention(q, k_read, v_read, kv_mask=kv_mask)
            else:
                # a chunk at `index`: causal over the first index + s slots,
                # so q_offset = index (the JAX model's bias k_pos <= q_pos)
                ctx = attention(q, k_read, v_read, kv_mask=kv_mask[:, :end],
                                causal=True)
        out = self.c_proj(ctx.reshape(b, s, h * d), self.dtype)
        return self.resid_dropout(out)

    def _per_slot(self, q, k, v, kv_mask, cache, layer_idx):
        """Each row's s tokens written at its own index..index+s-1; a
        decode step sees the mask, a chunk adds the per-row causal bias
        (keys at or before the query's slot)."""
        if cache.k_scale is not None:
            raise ValueError("the int8 KV cache takes a shared write index "
                             "(as in the JAX model), not a per-slot one")
        b, s = q.shape[:2]
        k_full, v_full = cache.k[layer_idx], cache.v[layer_idx]
        rows = torch.arange(b, device=q.device)[:, None]
        pos = cache.index[:, None] + torch.arange(s, device=q.device)
        k_full[rows, pos] = k.to(k_full.dtype)
        v_full[rows, pos] = v.to(v_full.dtype)
        if s == 1:
            return attention(q, k_full, v_full, kv_mask=kv_mask)
        t = k_full.shape[1]
        seen = torch.arange(t, device=q.device) <= pos[:, :, None]
        bias = torch.zeros(seen.shape, dtype=torch.float32,
                           device=q.device).masked_fill_(~seen, -1e30)
        return attention(q, k_full, v_full, kv_mask=kv_mask,
                         bias=bias[:, None])


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
        if getattr(config, "num_experts", 0) > 1:
            self.moe = SwitchMoE(
                config.n_embd, config.n_inner, config.num_experts,
                top_k=getattr(config, "moe_top_k", 1),
                capacity_factor=getattr(config, "expert_capacity_factor",
                                        1.25),
                activation=ACT2FN[config.activation_function], dtype=dtype,
                device=device)
            self.dropout = nn.Dropout(config.resid_pdrop)
        else:
            self.mlp = GPT2MLP(config, dtype=dtype, device=device)

    def forward(self, hidden, kv_mask, cache=None, layer_idx=None):
        """(the block's output, its MoE load-balancing loss or None)."""
        dt = self.dtype
        hidden = hidden + self.attn(layer_norm(self.ln_1, hidden, dt),
                                    kv_mask, cache, layer_idx)
        normed = layer_norm(self.ln_2, hidden, dt)
        if not hasattr(self, "moe"):
            return hidden + self.mlp(normed), None
        mlp, aux = self.moe(normed, deterministic=not self.training)
        return hidden + self.dropout(mlp), aux


class GPT2Model(nn.Module):
    """Returns {'last_hidden_state': [B,S,E] in `dtype`}, and 'cache' (the
    same KVCache, advanced by S) when a cache is given. `inputs_embeds`
    [B,S,E] takes the place of wte(input_ids), as in the JAX model (the
    captioning apps feed a visual prefix; their model sets `wte` to None
    and owns the token table)."""

    tensor_table = "gpt2"

    def __init__(self, config, dtype=torch.float32, device=None):
        super().__init__()
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

    def forward(self, input_ids=None, attention_mask=None, position_ids=None,
                cache=None, inputs_embeds=None):
        tokens = input_ids if inputs_embeds is None else inputs_embeds
        b, s = tokens.shape[:2]
        if attention_mask is None:
            attention_mask = torch.ones((b, s), dtype=torch.int32,
                                        device=tokens.device)
        if position_ids is None:
            position_ids = (attention_mask.long().cumsum(-1) - 1).clamp(min=0)
        group = None
        if cache is None and self.h:
            group = sequence_group(self.h[0].attn)
        if group is not None:
            tokens, attention_mask, position_ids = local_tokens(
                group, tokens, attention_mask, position_ids)
            if inputs_embeds is None:
                input_ids = tokens
            else:
                inputs_embeds = tokens
        if inputs_embeds is None:
            inputs_embeds = self.wte(input_ids)
        hidden = inputs_embeds + self.wpe(position_ids)
        hidden = self.drop(hidden).to(self.dtype)
        kv_mask = (attention_mask if cache is None else cache.mask)
        kv_mask = kv_mask.to(torch.int32)
        aux = []
        for i, block in enumerate(self.h):
            hidden, layer_aux = block(hidden, kv_mask, cache, i)
            if layer_aux is not None:
                aux.append(layer_aux)
        hidden = layer_norm(self.ln_f, hidden, self.dtype)
        if group is not None:
            hidden = gather_tokens(hidden, group)
        out = {"last_hidden_state": hidden}
        if aux:
            out["moe_aux_loss"] = (
                float(getattr(self.config, "router_aux_loss_coef", 0.01))
                * torch.stack(aux).mean())
        if cache is not None:
            # a new object for a per-slot index: the caller's tensor stays
            cache.index = cache.index + s
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
        init_gpt2_weights(self, self.config.initializer_range, generator)

    def cache_heads(self):
        """(heads, head dim) of one layer's K/V on this rank: the heads
        of its tensor-parallel share."""
        attn = self.transformer.h[0].attn
        return attn.num_heads, attn.head_dim

    def init_cache(self, batch_size, max_length, dtype=None,
                   quantize=False):
        """An empty KVCache of max_length slots (dtype: the compute dtype
        unless given); quantize=True: int8 K/V with f32 per-(token, head)
        scales. It holds this rank's heads (cache_heads)."""
        c = self.config
        device = self.transformer.wte.weight.device
        shape = (batch_size, max_length, *self.cache_heads())
        dtype = torch.int8 if quantize else dtype or self.dtype

        def per_layer(shape, dtype):
            return [torch.zeros(shape, dtype=dtype, device=device)
                    for _ in range(c.n_layer)]

        scales = ((per_layer(shape[:-1], torch.float32),
                   per_layer(shape[:-1], torch.float32)) if quantize
                  else (None, None))
        return KVCache(per_layer(shape, dtype), per_layer(shape, dtype),
                       torch.zeros((batch_size, max_length),
                                   dtype=torch.int32, device=device),
                       0, *scales)

    def logits(self, hidden):
        """The tied head: hidden [..., E] @ wte^T in the compute dtype
        (every rank's columns of a vocab-parallel wte, gathered)."""
        return tied_logits(self.transformer.wte, hidden, self.dtype)

    def forward(self, input_ids, attention_mask=None, position_ids=None,
                cache=None):
        out = self.transformer(input_ids, attention_mask=attention_mask,
                               position_ids=position_ids, cache=cache)
        out["logits"] = self.logits(out["last_hidden_state"])
        return out
