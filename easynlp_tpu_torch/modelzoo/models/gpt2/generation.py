"""GPT-2 prefill/decode adapters for generation_utils (decoder-only,
left-padded prompts).

Counterpart of easynlp_tpu/modelzoo/models/gpt2/generation.py. The module
owns its weights, so the closures take no params argument, and the cache is
a per-layer KVCache written in place (modeling_gpt2.py).
"""

from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import KVCache


def make_gpt2_generation_fns(model, max_length, cache_dtype=None,
                             kv_cache=None):
    """(prefill, decode) closures over a GPT2LMHeadModel.

    prefill(input_ids [B,P], attention_mask [B,P]) -> (f32 logits [B,V] of
    the last position, a KVCache of max_length slots holding the prompt);
    decode(token [B,1], cache) -> (f32 logits [B,V], the same cache, one
    slot further). `prefill.reindex_cache(cache, rows)` gathers beams.
    kv_cache='int8' and speculative decoding's `decode.chunk` /
    `decode.rollback` are not ported yet (ROADMAP A16)."""
    if kv_cache is not None:
        raise NotImplementedError(
            "kv_cache=%r (an int8 KV cache) is not ported yet (ROADMAP A16)"
            % (kv_cache,))

    def prefill(input_ids, attention_mask):
        b, p = input_ids.shape
        cache = model.init_cache(b, max_length, dtype=cache_dtype)
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

    def speculative_only(*args, **kwargs):
        raise NotImplementedError(
            "speculative decoding (decode.chunk / decode.rollback) is not "
            "ported yet (ROADMAP A16)")

    prefill.reindex_cache = KVCache.reindex
    decode.chunk = speculative_only
    decode.rollback = speculative_only
    return prefill, decode
