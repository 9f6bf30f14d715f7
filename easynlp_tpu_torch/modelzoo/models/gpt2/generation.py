"""GPT-2 prefill/decode adapters for generation_utils (decoder-only,
left-padded prompts).

Counterpart of easynlp_tpu/modelzoo/models/gpt2/generation.py. The module
owns its weights, so the closures take no params argument (an int8 model,
modelzoo/quantization.py, dequantizes its weights in each forward), and
the cache is a per-layer KVCache written in place (modeling_gpt2.py).
"""

import torch

from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import KVCache


def make_gpt2_generation_fns(model, max_length, cache_dtype=None,
                             cache_slack=0, kv_cache=None):
    """(prefill, decode) closures over a GPT2LMHeadModel.

    prefill(input_ids [B,P], attention_mask [B,P]) -> (f32 logits [B,V] of
    the last position, a KVCache of max_length + cache_slack slots holding
    the prompt); decode(token [B,1], cache) -> (f32 logits [B,V], the same
    cache, one slot further). `prefill.reindex_cache(cache, rows)` gathers
    beams. Speculative decoding (modelzoo/speculative.py) uses
    `decode.chunk(tokens [B,S], cache)` -> (f32 logits [B,S,V], cache S
    slots further), `decode.rollback(cache, drop)` and, where the cache
    is not int8, `decode.chunk_rowwise` (a [B] write index).

    cache_slack: KV slots past max_length, which a speculative verify
    chunk of K+1 tokens may fill before its rollback. kv_cache='int8': the
    int8 cache with per-(token, head) scales.

    A model that parallel/sharding.parallelize split carries its mesh
    (`parallel_mesh`); `prefill.mesh` hands it to generate(), which splits
    the batch's rows over the mesh's batch axes. The caches then hold the
    rank's heads (GPT2LMHeadModel.init_cache)."""
    if kv_cache not in (None, "int8"):
        raise ValueError("kv_cache must be None or 'int8' (got %r)"
                         % (kv_cache,))

    def prefill(input_ids, attention_mask):
        b, p = input_ids.shape
        cache = model.init_cache(b, max_length + cache_slack,
                                 dtype=cache_dtype,
                                 quantize=kv_cache == "int8")
        cache.mask[:, :p] = attention_mask
        out = model.transformer(input_ids, attention_mask=attention_mask,
                                cache=cache)
        return (model.logits(out["last_hidden_state"][:, -1]).float(),
                out["cache"])

    def decode(token, cache):
        # positions = the row's count of real tokens so far (left-padded
        # prompts), taken before the new slot is marked
        positions = cache.mask.sum(dim=-1, keepdim=True)
        cache.mask[:, cache.index] = 1
        out = model.transformer(token, position_ids=positions, cache=cache)
        return (model.logits(out["last_hidden_state"][:, -1]).float(),
                out["cache"])

    def decode_chunk(tokens, cache):
        """Verify forward: [B, S] tokens at the shared write index, logits
        of all S positions; the chunk attends causally at offset index."""
        s = tokens.shape[1]
        base = cache.mask.sum(dim=-1, keepdim=True)
        positions = base + torch.arange(s, device=tokens.device)
        cache.mask[:, cache.index:cache.index + s] = 1
        out = model.transformer(tokens, position_ids=positions, cache=cache)
        return model.logits(out["last_hidden_state"]).float(), out["cache"]

    def decode_chunk_rowwise(tokens, cache):
        """Per-row verify chunk: cache.index is [B], each row's S entries
        land at its own offset (the per-row causal bias in GPT2Attention).
        The caller re-masks rejected entries and advances the index."""
        b, s = tokens.shape
        base = cache.mask.sum(dim=-1, keepdim=True)
        positions = base + torch.arange(s, device=tokens.device)
        rows = torch.arange(b, device=tokens.device)[:, None]
        pos = cache.index[:, None] + torch.arange(s, device=tokens.device)
        cache.mask[rows, pos] = 1
        index = cache.index
        out = model.transformer(tokens, position_ids=positions, cache=cache)
        cache.index = index  # the caller advances it by the accepted count
        return model.logits(out["last_hidden_state"]).float(), out["cache"]

    def rollback(cache, drop):
        """Invalidate the last `drop` entries (rejected drafts): the write
        index moves back and the slots from it on are masked; the next
        chunk overwrites them. `drop` may be a 0-d tensor."""
        cache.index = cache.index - drop
        t = cache.mask.shape[1]
        cache.mask.masked_fill_(
            torch.arange(t, device=cache.mask.device)[None, :]
            >= cache.index, 0)
        return cache

    prefill.reindex_cache = KVCache.reindex
    prefill.mesh = getattr(model, "parallel_mesh", None)
    decode.chunk = decode_chunk
    decode.rollback = rollback
    if kv_cache is None:
        # the per-row scatter path takes (k, v) caches only; the int8 cache
        # keeps the batch-shared speculative variant, as in JAX
        decode.chunk_rowwise = decode_chunk_rowwise
    decode.cache_slack = cache_slack  # checked by the speculative path
    return prefill, decode
