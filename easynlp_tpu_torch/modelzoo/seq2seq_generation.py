"""Encoder-decoder prefill/decode adapters (BART) for generation_utils.

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
                             cache_dtype=None):
    """(prefill, decode) closures over a BartForConditionalGeneration.

    prefill(decoder_start_ids [B*K,1], mask) -> (f32 logits [B*K,V], state);
    decode(token [B*K,1], state) -> (f32 logits, state one slot further).
    `prefill.reindex_cache(state, rows)` gathers beams (self and cross K/V,
    encoder output and mask). Speculative decoding's `decode.chunk` and
    `decode.rollback` are not ported yet (ROADMAP A16)."""

    def prefill(decoder_start_ids, decoder_start_mask):
        bk = decoder_start_ids.shape[0]
        k = bk // src_ids.shape[0]
        enc = model.encode(src_ids, src_mask)
        enc_mask = src_mask
        if k > 1:
            enc = enc.repeat_interleave(k, dim=0)
            enc_mask = src_mask.repeat_interleave(k, dim=0)
        cache = model.init_cache(bk, max_length, dtype=cache_dtype)
        cache.cross_k, cache.cross_v = model.precompute_cross_kv(enc)
        logits, cache = model.decode(decoder_start_ids, enc, enc_mask,
                                     cache=cache)
        return logits[:, -1].float(), {"cache": cache, "enc": enc,
                                       "enc_mask": enc_mask}

    def decode(token, state):
        logits, cache = model.decode(token, state["enc"], state["enc_mask"],
                                     cache=state["cache"])
        return logits[:, -1].float(), dict(state, cache=cache)

    def reindex_cache(state, rows):
        return {"cache": state["cache"].reindex(rows),
                "enc": state["enc"].index_select(0, rows),
                "enc_mask": state["enc_mask"].index_select(0, rows)}

    def speculative_only(*args, **kwargs):
        raise NotImplementedError(
            "speculative decoding (decode.chunk / decode.rollback) is not "
            "ported yet (ROADMAP A16)")

    prefill.reindex_cache = reindex_cache
    decode.chunk = speculative_only
    decode.rollback = speculative_only
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
    prefill, decode = make_encoder_decoder_fns(model, max_length, src_ids,
                                               src_mask)
    kwargs.setdefault("eos_token_id", model.config.eos_token_id)
    kwargs.setdefault("pad_token_id", model.config.pad_token_id)
    return generation_utils.generate(prefill, decode, start, start_mask,
                                     max_length=max_length,
                                     num_beams=num_beams, do_sample=do_sample,
                                     **kwargs)
