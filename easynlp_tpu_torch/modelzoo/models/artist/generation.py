"""ARTIST prefill/decode adapters for generation_utils.

Counterpart of easynlp_tpu/modelzoo/models/artist/generation.py: the
closures run ARTISTModel.lm_step over a KVCache of max_length slots, as
the port's GPT-2 adapters do (modelzoo/models/gpt2/generation.py). The
module owns its weights, so the closures take no params argument; the
cache is written in place.
"""

from easynlp_tpu_torch.modelzoo.models.gpt2.modeling_gpt2 import KVCache


def make_artist_generation_fns(module, max_length):
    """(prefill, decode) over an ARTISTModel: prefill(input_ids [B,P],
    attention_mask [B,P]) -> (f32 logits [B,V] of the last position, the
    cache holding the prompt); decode(token [B,1], cache) -> (f32 logits
    [B,V], the cache one slot further). `prefill.reindex_cache` gathers
    beams."""

    def prefill(input_ids, attention_mask):
        b, p = input_ids.shape
        cache = module.init_lm_cache(b, max_length)
        cache.mask[:, :p] = attention_mask
        out = module.lm_step(input_ids, attention_mask=attention_mask,
                             cache=cache)
        return out["logits"][:, -1].float(), out["cache"]

    def decode(token, cache):
        # the row's count of real tokens so far, before the new slot
        positions = cache.mask.sum(dim=-1, keepdim=True)
        cache.mask[:, cache.index] = 1
        out = module.lm_step(token, position_ids=positions, cache=cache)
        return out["logits"][:, -1].float(), out["cache"]

    prefill.reindex_cache = KVCache.reindex
    return prefill, decode
