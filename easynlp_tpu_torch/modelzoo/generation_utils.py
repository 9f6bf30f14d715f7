"""Text generation for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/generation_utils.py, with the same
algorithms and the same f32 arithmetic, so greedy and beam search give the
JAX package's tokens:

- the logits processors (temperature, top-k, top-p, repetition penalty,
  min length, no-repeat-ngram, a bad-words vocab mask) are the same pure
  (logits, sequences, cur_len) -> logits functions;
- greedy/sampling and beam search run over a fixed [B, T] token buffer, as
  the JAX `lax.while_loop`s do, but as eager Python loops: PyTorch needs no
  static shapes. Each loop stops where the JAX loop's `cond` does, and it
  skips the final decode step whose logits nothing reads;
- top-k selections break ties towards the lower index, as `lax.top_k`
  does (a stable sort), and argmax takes the first maximum in both.

Sampling draws from an explicit `torch.Generator` on the model's device;
its stream differs from `jax.random`'s, so sampled tokens are not
comparable across the packages. The serving paths' per-row sampling
(`rowwise_warp_and_sample`) draws from a counter-based stream instead, a
pure function of (seed, position) as JAX's per-request stream is.
`generate(speculative='prompt_lookup')` dispatches to
modelzoo/speculative.py as the JAX generate does. `row_seeds` ([B]) makes
greedy_or_sample draw from that counter-based stream too (row i's token at
generated position n a pure function of (its logits, row_seeds[i], n)), so
a row's draws do not depend on the batch it shares.

On a mesh (the adapter's `prefill.mesh`, set from a model that
parallel/sharding.parallelize split): the model's own collectives run the
tensor axis, and generate() splits the batch's rows over the batch axes
(mesh.BATCH_AXES, as the Trainer does), runs its block of rows and gathers
the sequences, so every rank returns the whole batch's tokens. Tensor ranks
see the same gathered logits bit for bit and so draw the same tokens from
the per-row counter stream; a generator's stream is each rank's own, so
sampling on a mesh takes `row_seeds` and refuses beam or speculative
sampling.

Model protocol: `prefill(input_ids, attention_mask)` and
`decode(token [B,1], cache)` both -> (f32 logits [B,V] for the last
position, cache); beam search also needs `reindex_cache(cache, rows)`.
Decoder-only prompts are LEFT-padded (left_pad below).
"""

import numpy as np
import torch

from easynlp_tpu_torch.parallel import comm
from easynlp_tpu_torch.parallel.mesh import BATCH_AXES, batch_sharding

NEG_INF = -1.0e7


def left_pad(sequences, pad_token_id, length=None):
    """List of id-lists -> left-padded [B, P] int32 + attention mask
    (numpy)."""
    length = length or max(len(s) for s in sequences)
    ids = np.full((len(sequences), length), pad_token_id, np.int32)
    mask = np.zeros((len(sequences), length), np.int32)
    for i, seq in enumerate(sequences):
        seq = seq[-length:]
        ids[i, length - len(seq):] = seq
        mask[i, length - len(seq):] = 1
    return ids, mask


# -----------------------------------------------------------------------------
# logits processors (pure)
# -----------------------------------------------------------------------------

def _neg_inf_where(ban, logits):
    return torch.where(ban, torch.full_like(logits, NEG_INF), logits)


def apply_temperature(logits, temperature):
    if temperature and temperature != 1.0:
        return logits / float(temperature)
    return logits


def apply_top_k(logits, top_k):
    if not top_k or top_k <= 0:
        return logits
    top_k = min(top_k, logits.shape[-1])
    kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
    return _neg_inf_where(logits < kth, logits)


def apply_top_p(logits, top_p):
    if not top_p or top_p >= 1.0:
        return logits
    sorted_logits = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_logits, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest set with cumulative prob >= top_p (always keeps the
    # top-1); threshold = the smallest kept logit
    drop = cum - probs >= top_p
    cutoff = sorted_logits.masked_fill(drop, float("inf")).amin(
        dim=-1, keepdim=True)
    return _neg_inf_where(logits < cutoff, logits)


def _token_hits(sequences, hit, vocab_size):
    """bool [B, V]: True for each token that sits at a position where
    `hit` [B, N] is true (sequences [B, N] of ids)."""
    out = torch.zeros((sequences.shape[0], vocab_size), dtype=torch.int32,
                      device=sequences.device)
    out.scatter_reduce_(1, sequences.long(), hit.to(torch.int32),
                        reduce="amax")
    return out.bool()


def apply_repetition_penalty(logits, sequences, valid_mask, penalty):
    """Reference semantics: divide positive logits of seen tokens by the
    penalty, multiply negative ones."""
    if not penalty or penalty == 1.0:
        return logits
    seen = _token_hits(sequences, valid_mask.bool(), logits.shape[-1])
    penalised = torch.where(logits > 0, logits / penalty, logits * penalty)
    return torch.where(seen, penalised, logits)


def apply_min_length(logits, cur_len, min_length, eos_token_id):
    """Ban EOS while cur_len (the buffer position, prompt included, as in
    the JAX loop) is below min_length."""
    if not min_length or eos_token_id is None or cur_len >= min_length:
        return logits
    logits = logits.clone()
    logits[:, eos_token_id] = NEG_INF
    return logits


def apply_no_repeat_ngram(logits, sequences, cur_len, ngram_size):
    """Ban tokens that would complete an n-gram already present in the first
    cur_len positions: compare the trailing n-1 tokens against every
    window."""
    if not ngram_size or ngram_size <= 0:
        return logits
    n = ngram_size
    t = sequences.shape[1]
    if t < n:
        return logits
    windows = sequences.unfold(1, n, 1)                # [B, t-n+1, n]
    # lax.dynamic_slice clamps the start so the slice stays in range
    start = min(max(cur_len - (n - 1), 0), t - (n - 1))
    prefix = sequences[:, start:start + n - 1]
    match = (windows[:, :, :n - 1] == prefix[:, None, :]).all(dim=-1)
    inside = (torch.arange(t - n + 1, device=sequences.device) + n
              <= cur_len)
    ban = _token_hits(windows[:, :, n - 1], match & inside[None, :],
                      logits.shape[-1])
    return _neg_inf_where(ban, logits)


def apply_bad_words_mask(logits, bad_words_mask):
    """bad_words_mask: bool [V] or [B, V]; True = banned."""
    if bad_words_mask is None:
        return logits
    return _neg_inf_where(bad_words_mask, logits)


def process_logits(logits, sequences, valid_mask, cur_len, config):
    logits = logits.float()
    logits = apply_repetition_penalty(
        logits, sequences, valid_mask, config.get("repetition_penalty"))
    logits = apply_no_repeat_ngram(
        logits, sequences, cur_len, config.get("no_repeat_ngram_size"))
    logits = apply_min_length(
        logits, cur_len, config.get("min_length"), config.get("eos_token_id"))
    logits = apply_bad_words_mask(logits, config.get("bad_words_mask"))
    return logits


def _warp(logits, temperature, top_k, top_p):
    logits = apply_temperature(logits, temperature)
    logits = apply_top_k(logits, top_k)
    return apply_top_p(logits, top_p)


def rowwise_warp(logits, temperature, top_k, top_p):
    """Per-ROW temperature, then top-k, then top-p (the JAX package's
    rowwise_warp_and_sample warp, with its keep-set semantics), every
    parameter a [B] tensor so mixed requests share one step: logits [B, V]
    f32; temperature/top_p [B] float; top_k [B] int (<= 0: off). One
    descending sort serves both cuts: top-k masks ranks >= k, and top-p's
    cumulative softmax runs over the top-k-masked sorted values. Returns
    the warped f32 logits (NEG_INF where cut)."""
    v = logits.shape[-1]
    temp = temperature.float().clamp(min=1e-6)
    scaled = logits.float() / temp[:, None]
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, v),
                        top_k.clamp(1, v)).long()
    ranks = torch.arange(v, device=logits.device)[None, :]
    sorted_k = _neg_inf_where(ranks >= k_eff[:, None], sorted_desc)
    kth = torch.gather(sorted_desc, 1, k_eff[:, None] - 1)
    warped = _neg_inf_where(scaled < kth, scaled)
    probs = torch.softmax(sorted_k, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    # keep the smallest set with cumulative prob >= top_p (top-1 always
    # kept); top_p >= 1 keeps everything because cum - probs < 1
    drop = cum - probs >= top_p.float()[:, None]
    cutoff = sorted_k.masked_fill(drop, float("inf")).amin(dim=-1,
                                                           keepdim=True)
    return _neg_inf_where(scaled < cutoff, warped)


_M32 = 0xFFFFFFFF


def _mul32(x, c):
    """(x * c) mod 2^32 for int64 x in [0, 2^32): in 16-bit halves of c, so
    no product leaves int64."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix32(x):
    """murmur3's 32-bit finaliser on int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    return x ^ (x >> 16)


def counter_uniform(seeds, positions, v):
    """[B, V] f32 uniforms in (0, 1): element (i, j) a hash of (seeds[i],
    positions[i], j) computed on the tensors' device. A pure function of
    its counters, as the JAX stream fold_in(PRNGKey(seed), position) is,
    so a row's draws do not depend on its batch, slot or neighbours. (Not
    JAX's threefry stream: the packages' sampled tokens differ; ROADMAP C4
    defines parity without shared random streams.)"""
    seeds = seeds.long() & _M32
    positions = positions.long() & _M32
    key = _mix32(_mix32(seeds) ^ _mul32(positions + 1, 0x9E3779B9))
    cols = _mix32(torch.arange(v, device=seeds.device, dtype=torch.long)
                  + 0x632BE5AB)
    bits = _mix32(key[:, None] ^ cols[None, :])
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def rowwise_warp_and_sample(logits, do_sample, temperature, top_k, top_p,
                            seeds, positions):
    """Per-row sampling for the serving paths (the port of the JAX
    package's rowwise_warp_and_sample): rows with do_sample[i] draw from
    softmax(rowwise_warp(...)[i]) by Gumbel-max over
    counter_uniform(seeds, positions): row i's draw is a pure function of
    (its logits, seeds[i], positions[i]), positions[i] being how many
    tokens request i has produced so far. Other rows return argmax. All
    arguments are [B] tensors on the logits' device; returns [B] int64."""
    greedy = torch.argmax(logits, dim=-1)
    warped = rowwise_warp(logits, temperature, top_k, top_p)
    u = counter_uniform(seeds, positions, logits.shape[-1])
    sampled = torch.argmax(warped - torch.log(-torch.log(u)), dim=-1)
    return torch.where(do_sample.bool(), sampled, greedy)


def _top_k(x, k):
    """(values, indices) of the k largest along the last dim, ties to the
    lower index first (as lax.top_k)."""
    values, indices = torch.sort(x, dim=-1, descending=True, stable=True)
    return values[..., :k], indices[..., :k]


# -----------------------------------------------------------------------------
# greedy / sampling loop
# -----------------------------------------------------------------------------

def greedy_or_sample(prefill, decode, input_ids, attention_mask, max_length,
                     do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                     eos_token_id=None, pad_token_id=0, generator=None,
                     row_seeds=None, **proc_config):
    """input_ids LEFT-padded [B, P]; returns (sequences [B, max_length],
    valid [B, max_length]: 1 where a real token sits). Sampling draws from
    `generator`, or where `row_seeds` ([B]) is given by Gumbel-max over
    counter_uniform(row_seeds, generated position)."""
    b, p = input_ids.shape
    t = max_length
    if t <= p:
        raise ValueError("max_length (%d) must exceed the prompt length (%d)"
                         % (t, p))
    proc = dict(proc_config, eos_token_id=eos_token_id)
    device = input_ids.device
    sequences = torch.full((b, t), pad_token_id, dtype=torch.int32,
                           device=device)
    sequences[:, :p] = input_ids
    valid = torch.zeros((b, t), dtype=torch.int32, device=device)
    valid[:, :p] = attention_mask

    logits, cache = prefill(input_ids, attention_mask)
    finished = torch.zeros((b,), dtype=torch.bool, device=device)
    for step in range(p, t):
        logits = process_logits(logits, sequences, valid, step, proc)
        if do_sample and row_seeds is not None:
            warped = _warp(logits, temperature, top_k, top_p)
            u = counter_uniform(row_seeds, torch.full_like(
                row_seeds, step - p), logits.shape[-1])
            token = torch.argmax(warped - torch.log(-torch.log(u)), dim=-1)
        elif do_sample:
            probs = torch.softmax(_warp(logits, temperature, top_k, top_p),
                                  dim=-1)
            token = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            token = torch.argmax(logits, dim=-1)
        token = torch.where(finished, pad_token_id, token).to(torch.int32)
        sequences[:, step] = token
        valid[:, step] = (~finished).to(torch.int32)
        if eos_token_id is not None:
            finished = finished | (token == eos_token_id)
        if step + 1 == t or bool(finished.all()):
            break  # the JAX loop's cond ends here; its last decode is unread
        logits, cache = decode(token[:, None], cache)
    return sequences, valid


# -----------------------------------------------------------------------------
# beam search
# -----------------------------------------------------------------------------

def beam_search(prefill, decode, input_ids, attention_mask, max_length,
                num_beams=4, length_penalty=1.0, eos_token_id=None,
                pad_token_id=0, early_stopping=True, reindex_cache=None,
                do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                generator=None, num_beam_groups=1, diversity_penalty=0.0,
                num_return_sequences=1, **proc_config):
    """Beam search over a [B, K, T] buffer, as the JAX beam_search: returns
    the best sequences [B, max_length], or the top `num_return_sequences`
    hypotheses [B, N, max_length] when N > 1 (finished hypotheses outrank
    live ones). Group beams (num_beam_groups, diversity_penalty) and
    beam-sample (do_sample, Gumbel-top-k from `generator`) as there.

    reindex_cache(cache, flat_beam) gathers the cache's rows (flat_beam:
    [B*K] source rows); adapters attach it to prefill (`prefill.
    reindex_cache`)."""
    if reindex_cache is None:
        reindex_cache = getattr(prefill, "reindex_cache", None)
    if reindex_cache is None:
        raise ValueError("beam_search needs reindex_cache(cache, flat_beam): "
                         "pass it or attach it to the prefill fn")
    if num_beams % num_beam_groups:
        raise ValueError("num_beams (%d) must be a multiple of "
                         "num_beam_groups (%d)"
                         % (num_beams, num_beam_groups))
    b, p = input_ids.shape
    k = num_beams
    t = max_length
    if t <= p:
        raise ValueError("max_length (%d) must exceed the prompt length (%d)"
                         % (t, p))
    device = input_ids.device
    proc = dict(proc_config, eos_token_id=eos_token_id)
    sub_k = k // num_beam_groups

    ids_bk = input_ids.repeat_interleave(k, dim=0)            # [B*K, P]
    mask_bk = attention_mask.repeat_interleave(k, dim=0)
    logits, cache = prefill(ids_bk, mask_bk)                  # [B*K, V]
    v = logits.shape[-1]

    live_seqs = torch.full((b, k, t), pad_token_id, dtype=torch.int32,
                           device=device)
    live_seqs[:, :, :p] = ids_bk.view(b, k, p)
    # only beam 0 of each group is live at first (identical beams would
    # duplicate)
    live_scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                             device=device)
    live_scores[:, ::sub_k] = 0.0
    fin_seqs = torch.full((b, k, t), pad_token_id, dtype=torch.int32,
                          device=device)
    fin_scores = torch.full((b, k), NEG_INF, dtype=torch.float32,
                            device=device)
    rows = torch.arange(b, device=device)[:, None]

    def brevity(gen_len):
        # HF semantics: score = sum_logprobs / gen_len**length_penalty
        return float(np.power(np.float32(max(gen_len, 1)),
                              np.float32(length_penalty)))

    def improvable(step):
        horizon = brevity(step - p + 1 if early_stopping else t - p)
        worst_fin = fin_scores.amin(dim=1)
        return bool((worst_fin < live_scores.amax(dim=1) / horizon).any())

    step = p
    running = improvable(step)
    while running:
        flat_seqs = live_seqs.view(b * k, t)
        valid = (flat_seqs != pad_token_id).to(torch.int32)
        logp_all = torch.log_softmax(
            process_logits(logits, flat_seqs, valid, step, proc), dim=-1)
        if do_sample:
            logp_all = torch.log_softmax(
                _warp(logp_all, temperature, top_k, top_p), dim=-1)
        logp_all = logp_all.view(b, k, v)

        # per-group frontiers: later groups pay a diversity penalty on the
        # tokens earlier groups chose this step
        token_counts = torch.zeros((b, v), dtype=torch.float32,
                                   device=device)
        live_parts, fin_score_parts, fin_seq_parts = [], [], []
        beam_parts, token_parts, score_parts = [], [], []
        for g in range(num_beam_groups):
            logp = logp_all[:, g * sub_k:(g + 1) * sub_k]
            if diversity_penalty > 0.0 and g > 0:
                logp = logp - diversity_penalty * token_counts[:, None, :]
            cand = live_scores[:, g * sub_k:(g + 1) * sub_k, None] + logp
            flat = cand.reshape(b, sub_k * v)
            if do_sample:
                # Gumbel-top-k: sampling without replacement; the scores
                # stay the true log-probabilities
                u = torch.rand(flat.shape, generator=generator,
                               device=device).clamp_(min=1e-20)
                noised = torch.where(flat > NEG_INF / 2,
                                     flat - torch.log(-torch.log(u)), flat)
                top_idx = _top_k(noised, 2 * sub_k)[1]
                top_scores = torch.gather(flat, 1, top_idx)
            else:
                top_scores, top_idx = _top_k(flat, 2 * sub_k)
            beam_idx = top_idx // v + g * sub_k           # global beam index
            token_idx = top_idx % v
            seqs = live_seqs[rows, beam_idx]              # [B, 2sk, T]
            seqs[:, :, step] = token_idx.to(torch.int32)

            if eos_token_id is not None:
                is_eos = token_idx == eos_token_id
            else:
                is_eos = torch.zeros_like(token_idx, dtype=torch.bool)
            neg = torch.full_like(top_scores, NEG_INF)
            fin_score_parts.append(torch.where(
                is_eos, top_scores / brevity(step - p + 1), neg))
            fin_seq_parts.append(seqs)

            live_top, live_sel = _top_k(torch.where(is_eos, neg, top_scores),
                                        sub_k)
            live_parts.append(seqs[rows, live_sel])
            chosen_token = torch.gather(token_idx, 1, live_sel)
            beam_parts.append(torch.gather(beam_idx, 1, live_sel))
            token_parts.append(chosen_token)
            score_parts.append(live_top)
            if diversity_penalty > 0.0:
                token_counts.scatter_add_(
                    1, chosen_token, torch.ones_like(live_top))

        live_seqs = torch.cat(live_parts, dim=1)           # [B, K, T]
        live_scores = torch.cat(score_parts, dim=1)
        chosen_beam = torch.cat(beam_parts, dim=1)
        chosen_token = torch.cat(token_parts, dim=1)

        # the finished pool takes every group's EOS candidates
        all_fin_scores = torch.cat([fin_scores] + fin_score_parts, dim=1)
        all_fin_seqs = torch.cat([fin_seqs] + fin_seq_parts, dim=1)
        fin_scores, fin_sel = _top_k(all_fin_scores, k)
        fin_seqs = all_fin_seqs[rows, fin_sel]

        step += 1
        # the JAX loop's cond; when it ends the loop, its last decode is
        # unread and skipped here
        running = step < t and improvable(step)
        if running:
            # reindex the cache to the chosen beams: flat row = b*K + beam
            flat_beam = (rows * k + chosen_beam).reshape(-1)
            cache = reindex_cache(cache, flat_beam)
            logits, cache = decode(chosen_token.reshape(b * k, 1)
                                   .to(torch.int32), cache)

    if num_return_sequences > 1:
        # the pool is the finished hypotheses, topped up with live beams
        # (normalised) only below every finished one
        n = min(num_return_sequences, k)
        live_norm = live_scores / brevity(max(step - p, 1))
        fin_keys = torch.where(fin_scores > NEG_INF / 2, fin_scores + 1e9,
                               fin_scores)
        keys = torch.cat([fin_keys, live_norm], dim=1)     # [B, 2K]
        seqs = torch.cat([fin_seqs, live_seqs], dim=1)
        return seqs[rows, _top_k(keys, n)[1]]              # [B, N, T]

    # the best live beam where nothing finished
    none_fin = (fin_scores <= NEG_INF).all(dim=1)
    best_live = live_seqs[rows[:, 0], live_scores.argmax(dim=1)]
    best_fin = fin_seqs[rows[:, 0], fin_scores.argmax(dim=1)]
    return torch.where(none_fin[:, None], best_live, best_fin)


# -----------------------------------------------------------------------------
# public entry
# -----------------------------------------------------------------------------

_SAMPLING_KEYS = ("generator", "temperature", "top_k", "top_p", "row_seeds")
_BEAM_KEYS = ("num_beam_groups", "diversity_penalty", "length_penalty",
              "num_return_sequences")


def generate(prefill, decode, input_ids, attention_mask, max_length=64,
             **kwargs):
    """Greedy / sample / beam / beam-sample / group-beam, as the JAX
    generate; returns sequences [B, max_length] (or [B, N, max_length] for
    beams with num_return_sequences N > 1). On a mesh (`prefill.mesh`)
    each rank runs its block of rows over the batch axes and every rank
    returns the gathered batch (module docstring); a [B] `row_seeds` or a
    [B, V] bad-words mask is split with the rows, and sampling there needs
    `row_seeds` (ValueError otherwise, as for beam or speculative
    sampling). Collective there: every rank calls
    it with the same arguments."""
    mesh = getattr(prefill, "mesh", None)
    group = None
    if (mesh is not None and mesh.world_size > 1 and kwargs.get("do_sample")
            and (kwargs.get("row_seeds") is None
                 or kwargs.get("num_beams", 1) > 1
                 or kwargs.get("speculative"))):
        # a generator's stream is each rank's own and restarts on each
        # data rank's block of rows
        raise ValueError(
            "sampled generate() on a mesh draws only from the per-row "
            "counter stream: pass row_seeds ([B]), without beams or "
            "speculative decoding")
    if mesh is not None and mesh.size(BATCH_AXES) > 1:
        group = mesh.group(BATCH_AXES)
        start, stop = batch_sharding(input_ids.shape[0], mesh)
        input_ids = input_ids[start:stop]
        attention_mask = attention_mask[start:stop]
        if kwargs.get("row_seeds") is not None:
            kwargs["row_seeds"] = kwargs["row_seeds"][start:stop]
        bad = kwargs.get("bad_words_mask")
        if bad is not None and bad.dim() == 2:
            kwargs["bad_words_mask"] = bad[start:stop]
    seqs = _generate(prefill, decode, input_ids, attention_mask, max_length,
                     group=group, **kwargs)
    return comm.all_gather(seqs, group)


def _generate(prefill, decode, input_ids, attention_mask, max_length,
              num_beams=1, do_sample=False, speculative=None,
              num_draft_tokens=8, ngram_size=2, group=None, **kwargs):
    """generate() on this rank's rows; `group` joins the ranks that split
    the batch (the shared speculative acceptance reduces over it).

    speculative='prompt_lookup': prompt-lookup speculative decoding
    (modelzoo/speculative.py), token-exact vs plain greedy; greedy takes
    per-row acceptance where the adapter has `decode.chunk_rowwise`.
    Falls back silently to the plain loops under beams, a repetition
    penalty or no-repeat-ngram, or an adapter without `decode.chunk`, as
    the JAX generate does; raises ValueError where the adapter's
    cache_slack is under num_draft_tokens + 1."""
    if (speculative == "prompt_lookup" and num_beams == 1
            and hasattr(decode, "chunk")
            and not kwargs.get("repetition_penalty")
            and not kwargs.get("no_repeat_ngram_size")):
        from easynlp_tpu_torch.modelzoo import speculative as spec
        # verify chunks write K+1 entries past the committed length before
        # the rollback: without the slack they would run off the cache
        slack = getattr(decode, "cache_slack", 0)
        if slack < num_draft_tokens + 1:
            raise ValueError(
                "speculative decoding needs cache_slack >= num_draft_tokens"
                " + 1 (= %d) KV slots past max_length, but the adapter was"
                " built with cache_slack=%d; pass cache_slack=%d to the"
                " generation-fns constructor"
                % (num_draft_tokens + 1, slack, num_draft_tokens + 1))
        for key in _BEAM_KEYS + ("repetition_penalty",
                                 "no_repeat_ngram_size"):
            kwargs.pop(key, None)
        if not do_sample:
            for key in _SAMPLING_KEYS:
                kwargs.pop(key, None)
        if not do_sample and hasattr(decode, "chunk_rowwise"):
            seqs, _, _ = spec.speculative_greedy_rowwise(
                prefill, decode.chunk_rowwise, input_ids, attention_mask,
                max_length, num_draft_tokens=num_draft_tokens,
                ngram_size=ngram_size, **kwargs)
            return seqs
        seqs, _, _ = spec.speculative_greedy(
            prefill, decode.chunk, decode.rollback, input_ids,
            attention_mask, max_length, num_draft_tokens=num_draft_tokens,
            ngram_size=ngram_size, do_sample=do_sample, group=group,
            **kwargs)
        return seqs
    if num_beams > 1:
        if not do_sample:
            for key in _SAMPLING_KEYS:
                kwargs.pop(key, None)
        return beam_search(prefill, decode, input_ids, attention_mask,
                           max_length, num_beams=num_beams,
                           do_sample=do_sample, **kwargs)
    for key in _BEAM_KEYS:
        kwargs.pop(key, None)
    seqs, _ = greedy_or_sample(prefill, decode, input_ids, attention_mask,
                               max_length, do_sample=do_sample, **kwargs)
    return seqs
