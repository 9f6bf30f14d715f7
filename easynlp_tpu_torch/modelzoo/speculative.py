"""Prompt-lookup speculative decoding for the PyTorch port (greedy-exact).

Counterpart of easynlp_tpu/modelzoo/speculative.py. Draft tokens come from
matching the trailing n-gram of the committed buffer against earlier
occurrences (no draft model); one chunked forward over [pending, d_1..d_K]
scores every draft, and the longest prefix that agrees with the model's
own choices is committed with one bonus token. Output equals plain greedy
decoding token for token; sampling (`speculative_greedy` with do_sample)
stays distribution-exact: position i of the chunk is conditioned on the
drafts before it, so while every earlier draft equals the token sampled,
the chunk's logits are the true conditionals (top_k=1 is greedy).

The JAX package runs each loop as one `lax.while_loop`. Here it is a
Python loop whose drafting, verification, acceptance, buffer writes and
cache bookkeeping stay on the device; each round reads back to the host
once (the loop's condition, with `speculative_greedy`'s shared accepted
count, which the cache's rollback and the next write position need as
host integers), and each call once more after the prefill.

Model protocol (models/gpt2/generation.py, seq2seq_generation.py,
appzoo/sequence_generation/glm.py):
- decode.chunk(tokens [B,S], cache) -> (f32 logits [B,S,V], cache) with
  the shared write index advanced by S;
- decode.rollback(cache, drop) -> cache with the last `drop` entries
  invalidated (index -= drop, re-masked);
- decode.chunk_rowwise(tokens, cache) for a cache whose index is [B]
  (`speculative_greedy_rowwise`).

Over ranks that split the batch's rows (generate() on a mesh), the shared
accepted count and the loop's end are MIN all-reduces over their group:
the cross-device reduction GSPMD inserts for the JAX loop. The per-row
variant needs none.

Only position-static processors run under speculation (min_length,
bad_words_mask, EOS, and the sampling warps); repetition_penalty and
no_repeat_ngram_size raise here (generate() falls back to the plain loop).
"""

import torch
import torch.distributed as dist

from easynlp_tpu_torch.modelzoo.generation_utils import NEG_INF, _warp
from easynlp_tpu_torch.parallel import comm


def _windows(sequences, valid, n):
    """[B, P, n] n-gram windows of sequences and their all-valid flags
    [B, P] (P = T - n + 1)."""
    return sequences.unfold(1, n, 1), (valid.unfold(1, n, 1) == 1).all(-1)


def _copy_after(sequences, p_best, found, n, k, pad_token_id):
    """The K tokens after the chosen window start, pad where none."""
    t = sequences.shape[1]
    src = (p_best + n).clamp(0, t - 1)
    idx = (src[:, None] + torch.arange(k, device=sequences.device)) \
        .clamp(0, t - 1)
    draft = torch.gather(sequences, 1, idx)
    return torch.where(found[:, None], draft,
                       torch.full_like(draft, pad_token_id)).to(torch.int32)


def _best_start(cand, starts, n, k, cur_len):
    """Among candidate window starts prefer the most recent whose K-token
    continuation is committed (the naive most-recent match on cyclic text
    drafts pads), else any match; -1 where none."""
    full = (starts + n + k) <= cur_len
    none = torch.full_like(starts, -1).expand_as(cand)
    p_full = torch.where(cand & full, starts.expand_as(cand), none).amax(-1)
    p_any = torch.where(cand, starts.expand_as(cand), none).amax(-1)
    return torch.where(p_full >= 0, p_full, p_any)


def prompt_lookup_drafts(sequences, valid, cur_len, num_draft_tokens,
                         ngram_size, pad_token_id=0):
    """[B, K] drafts: the tokens after the most recent earlier occurrence
    of the trailing `ngram_size`-gram of the first `cur_len` (an int)
    positions; rows with no match draft `pad_token_id`."""
    b, t = sequences.shape
    n, k = ngram_size, num_draft_tokens
    start = min(max(cur_len - n, 0), t - n)  # lax.dynamic_slice clamps
    ngram = sequences[:, start:start + n]
    windows, win_valid = _windows(sequences, valid, n)
    eq = (windows == ngram[:, None, :]).all(-1)
    starts = torch.arange(t - n + 1, device=sequences.device)
    usable = (starts + n) <= (cur_len - 1)
    cand = eq & win_valid & usable[None, :]
    p_best = _best_start(cand, starts[None, :], n, k, cur_len)
    return _copy_after(sequences, p_best, p_best >= 0, n, k, pad_token_id)


def prompt_lookup_drafts_rowwise(sequences, valid, cur_len,
                                 num_draft_tokens, ngram_size,
                                 pad_token_id=0):
    """Per-row prompt lookup: `cur_len` is a [B] tensor (the slot layout,
    each row's committed length its own); the trailing n-gram must sit on
    valid positions too."""
    b, t = sequences.shape
    n, k = ngram_size, num_draft_tokens
    dev = sequences.device
    cur_len = cur_len.long()
    tail_idx = (cur_len[:, None] - n + torch.arange(n, device=dev)) \
        .clamp(0, t - 1)
    ngram = torch.gather(sequences, 1, tail_idx)
    tail_ok = (torch.gather(valid, 1, tail_idx) == 1).all(-1) \
        & (cur_len >= n)
    windows, win_valid = _windows(sequences, valid, n)
    eq = (windows == ngram[:, None, :]).all(-1)
    starts = torch.arange(t - n + 1, device=dev)[None, :]
    usable = (starts + n) <= (cur_len[:, None] - 1)
    cand = eq & win_valid & usable
    p_best = _best_start(cand, starts, n, k, cur_len[:, None])
    return _copy_after(sequences, p_best, (p_best >= 0) & tail_ok, n, k,
                       pad_token_id)


def _process_chunk_logits(logits, step, config):
    """Position-static processors on chunk logits [B, S, V]; position i
    decodes buffer position step + i, `step` an int (shared) or a [B]
    tensor (per row)."""
    logits = logits.float()
    bad = config.get("bad_words_mask")
    if bad is not None:
        ban = bad if bad.dim() == 1 else bad[:, None, :]
        logits = torch.where(ban, torch.full_like(logits, NEG_INF), logits)
    min_length = config.get("min_length")
    eos = config.get("eos_token_id")
    if min_length and eos is not None:
        arange = torch.arange(logits.shape[1], device=logits.device)
        pos = (step[:, None] + arange if torch.is_tensor(step)
               else step + arange)
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        ban = (pos < min_length)[..., None] & (vocab == eos)
        logits = torch.where(ban, torch.full_like(logits, NEG_INF), logits)
    return logits


def _refuse_content_processors(proc_config):
    for key in ("repetition_penalty", "no_repeat_ngram_size"):
        if proc_config.get(key):
            raise ValueError(
                "%s is sequence-content-dependent per position and not "
                "supported under speculative decoding; use plain greedy "
                "(generate() falls back automatically)" % key)


def _buffers(input_ids, attention_mask, tb, pad_token_id):
    b, p = input_ids.shape
    sequences = torch.full((b, tb), pad_token_id, dtype=torch.int32,
                           device=input_ids.device)
    sequences[:, :p] = input_ids
    valid = torch.zeros((b, tb), dtype=torch.int32, device=input_ids.device)
    valid[:, :p] = attention_mask
    return sequences, valid


def speculative_greedy(prefill, decode_chunk, rollback, input_ids,
                       attention_mask, max_length, num_draft_tokens=8,
                       ngram_size=2, eos_token_id=None, pad_token_id=0,
                       do_sample=False, temperature=1.0, top_k=0, top_p=1.0,
                       generator=None, group=None, **proc_config):
    """Greedy (or ancestral-sampling) decoding with prompt-lookup drafts
    and ONE accepted length shared by the batch (the minimum over live
    rows), so the cache keeps one write index. input_ids LEFT-padded
    [B, P]. Returns (sequences [B, max_length], valid [B, max_length],
    stats {accepted_drafts, verify_rounds, generated, read_backs}). The
    cache needs num_draft_tokens + 1 slots past max_length. `group`: the
    ranks holding the batch's other rows, over which the accepted count
    and the end are reduced (collective: they step together)."""
    _refuse_content_processors(proc_config)
    b, p = input_ids.shape
    t, k = max_length, num_draft_tokens
    if t <= p:
        raise ValueError("max_length (%d) must exceed the prompt length (%d)"
                         % (t, p))
    proc = dict(proc_config, eos_token_id=eos_token_id)
    device = input_ids.device

    def choose(logits3):
        if not do_sample:
            return torch.argmax(logits3, dim=-1).to(torch.int32)
        probs = torch.softmax(_warp(logits3, temperature, top_k, top_p), -1)
        flat = probs.reshape(-1, probs.shape[-1])
        return torch.multinomial(flat, 1, generator=generator) \
            .view(probs.shape[:-1]).to(torch.int32)

    sequences, valid = _buffers(input_ids, attention_mask, t + k + 1,
                                pad_token_id)
    logits0, cache = prefill(input_ids, attention_mask)
    g0 = choose(_process_chunk_logits(logits0[:, None], p, proc))[:, 0]
    finished = (g0 == eos_token_id) if eos_token_id is not None \
        else torch.zeros((b,), dtype=torch.bool, device=device)
    sequences[:, p] = g0
    valid[:, p] = 1
    pending = torch.where(finished, pad_token_id, g0)
    step, accepted, rounds = p + 1, 0, 0

    def everywhere_min(t):
        """A 0-d tensor's minimum over the group's ranks."""
        return comm.all_reduce(t.reshape(1), group, op=dist.ReduceOp.MIN)[0]

    done = bool(everywhere_min(finished.all().long()))
    read_backs = 1
    cidx = torch.arange(k + 1, device=device)
    while step < t and not done:
        draft = prompt_lookup_drafts(sequences, valid, step, k, ngram_size,
                                     pad_token_id)
        tokens_in = torch.cat([pending[:, None], draft], dim=1)
        logits, cache = decode_chunk(tokens_in, cache)          # [B,K+1,V]
        g = choose(_process_chunk_logits(logits, step, proc))   # [B,K+1]
        # d_i is accepted iff it equals the model's choice g_{i-1}
        match = (draft == g[:, :-1]).to(torch.int32)
        acc_row = torch.cumprod(match, dim=1).sum(dim=1)
        acc_row = torch.where(finished, k, acc_row)   # dead rows don't bind
        a = everywhere_min(acc_row.min())
        committed = cidx <= a                                   # [K+1]
        if eos_token_id is not None:
            is_eos = (g == eos_token_id) & committed[None]
        else:
            is_eos = torch.zeros_like(g, dtype=torch.bool)
        eos_before = torch.cat(
            [torch.zeros((b, 1), dtype=torch.bool, device=device),
             torch.cumsum(is_eos.to(torch.int32), dim=1)[:, :-1] > 0], 1)
        dead = finished[:, None] | eos_before
        write_live = committed[None] & ~dead
        sequences[:, step:step + k + 1] = torch.where(
            write_live, g, pad_token_id).to(torch.int32)
        valid[:, step:step + k + 1] = write_live.to(torch.int32)
        finished = finished | (is_eos & ~dead).any(dim=1)
        bonus = torch.gather(g, 1, a.expand(b, 1).long())[:, 0]
        pending = torch.where(finished, pad_token_id, bonus)
        # the one read-back of the round: the shared accepted count (the
        # rollback and the next write position need it) and the loop's end
        a_host, done = torch.stack([a.long(), everywhere_min(
            finished.all().long())]).tolist()
        read_backs += 1
        # of the K+1 entries just written ([pending, d_1..d_K]) keep the
        # pending token and the a accepted drafts
        cache = rollback(cache, k - a_host)
        step += 1 + a_host
        accepted += a_host
        rounds += 1
    seqs = sequences[:, :t]
    val = valid[:, :t]
    seqs = torch.where(val == 1, seqs, pad_token_id)
    stats = {"accepted_drafts": accepted, "verify_rounds": rounds,
             "generated": step - p, "read_backs": read_backs}
    return seqs, val, stats


def speculative_greedy_rowwise(prefill, decode_chunk_rowwise, input_ids,
                               attention_mask, max_length,
                               num_draft_tokens=8, ngram_size=2,
                               eos_token_id=None, pad_token_id=0,
                               **proc_config):
    """Greedy prompt-lookup speculation with PER-ROW acceptance: the cache
    keeps a [B] write index, each row advances by its own accepted length,
    and rejected entries are masked instead of rolled back (later rounds
    overwrite them). Token-exact vs plain greedy per row. Returns
    (sequences, valid, stats) as speculative_greedy."""
    _refuse_content_processors(proc_config)
    b, p = input_ids.shape
    t, k = max_length, num_draft_tokens
    if t <= p:
        raise ValueError("max_length (%d) must exceed the prompt length (%d)"
                         % (t, p))
    proc = dict(proc_config, eos_token_id=eos_token_id)
    device = input_ids.device
    rows = torch.arange(b, device=device)[:, None]
    cidx = torch.arange(k + 1, device=device)

    sequences, valid = _buffers(input_ids, attention_mask, t + k + 1,
                                pad_token_id)
    logits0, cache = prefill(input_ids, attention_mask)
    g0 = torch.argmax(_process_chunk_logits(logits0[:, None], p, proc),
                      dim=-1).to(torch.int32)[:, 0]
    finished = (g0 == eos_token_id) if eos_token_id is not None \
        else torch.zeros((b,), dtype=torch.bool, device=device)
    sequences[:, p] = g0
    valid[:, p] = 1
    # every row's prefill ends at the shared index p
    cache.index = torch.full((b,), cache.index, dtype=torch.long,
                             device=device)
    step = torch.full((b,), p + 1, dtype=torch.long, device=device)
    pending = torch.where(finished, pad_token_id, g0)
    accepted = torch.zeros((), dtype=torch.long, device=device)
    rounds, read_backs = 0, 0
    while True:
        active = ~finished & (step < t)
        read_backs += 1
        if not bool(active.any()):  # the round's one read-back
            break
        draft = prompt_lookup_drafts_rowwise(sequences, valid, step, k,
                                             ngram_size, pad_token_id)
        tokens_in = torch.cat([pending[:, None], draft], dim=1)
        index = cache.index
        logits, cache = decode_chunk_rowwise(tokens_in, cache)
        g = torch.argmax(_process_chunk_logits(logits, step, proc),
                         dim=-1).to(torch.int32)                # [B,K+1]
        match = (draft == g[:, :k]).to(torch.int32)
        acc = torch.cumprod(match, dim=1).sum(dim=1)
        n_new = torch.minimum(acc + 1, t - step)         # per-row budget
        if eos_token_id is not None:
            is_eos = g == eos_token_id
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
            n_new = torch.where(is_eos.any(dim=1),
                                torch.minimum(n_new, first_eos + 1), n_new)
        n_new = torch.where(active, n_new, 0)
        commit = cidx[None, :] < n_new[:, None]                 # [B,K+1]
        pos_buf = step[:, None] + cidx[None, :]
        sequences.scatter_(1, pos_buf, torch.where(
            commit, g, torch.gather(sequences, 1, pos_buf)))
        valid.scatter_(1, pos_buf, torch.where(
            commit, 1, torch.gather(valid, 1, pos_buf)))
        if eos_token_id is not None:
            finished = finished | (is_eos & commit).any(dim=1)
        # keep pending + the accepted drafts visible, drop the rejected
        # tail; the index advances by the accepted length only
        cache.mask[rows, index[:, None] + cidx[None, :]] = \
            commit.to(torch.int32)
        cache.index = index + n_new
        bonus = torch.gather(g, 1, (n_new - 1).clamp(min=0)[:, None])[:, 0]
        pending = torch.where(active, bonus, pending)
        pending = torch.where(finished, pad_token_id, pending)
        step = step + n_new
        accepted = accepted + (n_new - 1).clamp(min=0).sum()
        rounds += 1
    seqs = sequences[:, :t]
    val = valid[:, :t]
    seqs = torch.where(val == 1, seqs, pad_token_id)
    stats = {"accepted_drafts": int(accepted), "verify_rounds": rounds,
             "generated": int((step - p).sum()), "read_backs": read_backs}
    return seqs, val, stats
