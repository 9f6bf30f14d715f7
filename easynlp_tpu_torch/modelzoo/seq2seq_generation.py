"""Encoder-decoder prefill/decode adapters (BART, Pegasus, Randeng, the
dialogue transformer, T5, mT5) for generation_utils.

Counterpart of easynlp_tpu/modelzoo/seq2seq_generation.py. The "prompt"
handed to generation_utils is the decoder start token [B,1]; the source is
closed over, encoded once in prefill, and repeated across beams there
(prefill sees [B*K, 1] ids under beam search). The module owns its weights,
so the closures take no params argument, and the state is a dict of the
model's Seq2SeqCache (per-layer self K/V written in place, and the
cross-attention K/V computed once from the encoder output) with the encoder
output and mask.
"""

import torch

from easynlp_tpu_torch.modelzoo import generation_utils


def make_encoder_decoder_fns(model, max_length, src_ids, src_mask,
                             cache_dtype=None, cache_slack=0):
    """(prefill, decode) closures over an encoder-decoder model.

    prefill(decoder_start_ids [B*K,1], mask) -> (f32 logits [B*K,V], state);
    decode(token [B*K,1], state) -> (f32 logits, state one slot further).
    `prefill.reindex_cache(state, rows)` gathers beams (self and cross K/V,
    encoder output and mask). Speculative decoding: `decode.chunk(tokens
    [B,S], state)` -> (f32 logits [B,S,V], state S slots further) and
    `decode.rollback(state, drop)`; cache_slack adds the decoder cache
    slots a verify chunk may fill past max_length before its rollback."""

    def prefill(decoder_start_ids, decoder_start_mask):
        bk = decoder_start_ids.shape[0]
        k = bk // src_ids.shape[0]
        enc = model.encode(src_ids, src_mask)
        enc_mask = src_mask
        if k > 1:
            enc = enc.repeat_interleave(k, dim=0)
            enc_mask = src_mask.repeat_interleave(k, dim=0)
        cache = model.init_cache(bk, max_length + cache_slack,
                                 dtype=cache_dtype)
        cache.cross_k, cache.cross_v = model.precompute_cross_kv(enc)
        logits, cache = model.decode(decoder_start_ids, enc, enc_mask,
                                     cache=cache)
        return logits[:, -1].float(), {"cache": cache, "enc": enc,
                                       "enc_mask": enc_mask}

    def decode(token, state):
        logits, cache = model.decode(token, state["enc"], state["enc_mask"],
                                     cache=state["cache"])
        return logits[:, -1].float(), dict(state, cache=cache)

    def decode_chunk(tokens, state):
        """Verify forward: [B, S] tokens at the decoder cache index, the
        logits of all S positions (the decoder adds causality within the
        chunk)."""
        logits, cache = model.decode(tokens, state["enc"], state["enc_mask"],
                                     cache=state["cache"])
        return logits.float(), dict(state, cache=cache)

    def rollback(state, drop):
        # decoder visibility follows the index (slots below index + s), so
        # pulling the index back is the whole rollback
        state["cache"].index -= drop
        return state

    def reindex_cache(state, rows):
        return {"cache": state["cache"].reindex(rows),
                "enc": state["enc"].index_select(0, rows),
                "enc_mask": state["enc_mask"].index_select(0, rows)}

    prefill.reindex_cache = reindex_cache
    decode.chunk = decode_chunk
    decode.rollback = rollback
    decode.cache_slack = cache_slack  # checked by the speculative path
    return prefill, decode


def encoder_decoder_generate(model, src_ids, src_mask, max_length=64,
                             num_beams=1, do_sample=False, **kwargs):
    """Source [B,S] -> generated decoder ids [B, max_length], the first
    column the decoder start token (or [B, N, max_length] for N returned
    beams). eos/pad ids default to the config's."""
    b = src_ids.shape[0]
    device = src_ids.device
    start = torch.full((b, 1), model.config.decoder_start_token_id,
                       dtype=torch.long, device=device)
    start_mask = torch.ones((b, 1), dtype=torch.int32, device=device)
    slack = (kwargs.get("num_draft_tokens", 8) + 1
             if kwargs.get("speculative") else 0)
    prefill, decode = make_encoder_decoder_fns(model, max_length, src_ids,
                                               src_mask, cache_slack=slack)
    kwargs.setdefault("eos_token_id", model.config.eos_token_id)
    kwargs.setdefault("pad_token_id", model.config.pad_token_id)
    return generation_utils.generate(prefill, decode, start, start_mask,
                                     max_length=max_length,
                                     num_beams=num_beams, do_sample=do_sample,
                                     **kwargs)
