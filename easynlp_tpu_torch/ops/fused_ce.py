"""Large-vocabulary softmax cross-entropy without the [N, V] logits.

Counterpart of easynlp_tpu/ops/fused_ce.py:

1. `chunked_softmax_ce(hidden, embedding, labels)` (:43-131): the mean CE
   of hidden @ embedding^T over the labels that are not ignore_index,
   computed a vocabulary chunk at a time with an online logsumexp and the
   gold logit. A torch.autograd.Function whose backward recomputes each
   chunk's probabilities from the saved LSE, so neither pass holds more
   than [N, chunk] logits.
2. `vocab_parallel_cross_entropy(local_logits, labels, group)` (:138-163):
   the CE of logits whose vocabulary is split over the `tensor` group,
   Megatron's vocab-parallel CE: three all-reduces (max, sum of exp, gold
   logit) and no all-gather of the vocabulary. `vocab_size` marks the
   padded columns of the last shard (a vocabulary that does not divide
   by the group is padded, as Megatron's make_vocab_size_divisible_by);
   they are masked out.

Nothing in the apps calls either; they are building blocks, as in JAX.
"""

import torch

from easynlp_tpu_torch.parallel import comm


def _chunk_logits(hidden32, embedding, start, chunk):
    emb = embedding[start:start + chunk].float()
    return hidden32 @ emb.t(), emb


class ChunkedSoftmaxCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, hidden, embedding, labels, chunk_size, ignore_index):
        n = hidden.shape[0]
        v = embedding.shape[0]
        chunk = min(chunk_size, v)
        h32 = hidden.float()
        valid = labels != ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        m = torch.full((n,), -torch.inf, device=hidden.device)
        s = torch.zeros(n, device=hidden.device)
        gold = torch.zeros(n, device=hidden.device)
        for start in range(0, v, chunk):
            logits, _ = _chunk_logits(h32, embedding, start, chunk)
            width = logits.shape[1]
            in_chunk = (safe >= start) & (safe < start + width)
            local = (safe - start).clamp(0, width - 1)
            gold = gold + torch.where(
                in_chunk, logits.gather(1, local[:, None])[:, 0], 0.0)
            m_new = torch.maximum(m, logits.amax(-1))
            s = s * torch.exp(m - m_new) + torch.exp(
                logits - m_new[:, None]).sum(-1)
            m = m_new
        lse = m + torch.log(s)
        denom = valid.sum().clamp(min=1)
        loss = torch.where(valid, lse - gold, 0.0).sum() / denom
        ctx.save_for_backward(hidden, embedding, labels, lse, denom)
        ctx.chunk, ctx.ignore_index = chunk, ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        hidden, embedding, labels, lse, denom = ctx.saved_tensors
        chunk = ctx.chunk
        v = embedding.shape[0]
        h32 = hidden.float()
        valid = labels != ctx.ignore_index
        safe = torch.where(valid, labels, torch.zeros_like(labels))
        scale = (g / denom).float()
        dh = torch.zeros_like(h32)
        demb = []
        for start in range(0, v, chunk):
            logits, emb = _chunk_logits(h32, embedding, start, chunk)
            cols = torch.arange(start, start + logits.shape[1],
                                device=hidden.device)
            p = torch.exp(logits - lse[:, None])
            onehot = (safe[:, None] == cols[None, :]) & valid[:, None]
            dlogits = (p - onehot.float()) * valid[:, None] * scale
            dh = dh + dlogits @ emb
            demb.append(dlogits.t() @ h32)
        return (dh.to(hidden.dtype), torch.cat(demb).to(embedding.dtype),
                None, None, None)


def chunked_softmax_ce(hidden, embedding, labels, chunk_size=8192,
                       ignore_index=-100):
    """Mean CE of hidden [N, E] @ embedding [V, E]^T against labels [N]
    (ignore_index rows left out), a vocabulary chunk at a time."""
    return ChunkedSoftmaxCE.apply(hidden, embedding, labels, chunk_size,
                                  ignore_index)


def vocab_parallel_cross_entropy(local_logits, labels, group=None,
                                 ignore_index=-100, vocab_size=None):
    """Mean CE of logits whose vocabulary is split over `group` (default:
    the mesh's `tensor` group): local_logits [N, V/tp] hold rank r's
    columns [r V/tp, (r+1) V/tp); labels [N] are global ids. Columns at or
    past vocab_size (padding) are masked."""
    if group is None:
        from easynlp_tpu_torch.parallel.mesh import axis_group
        group = axis_group("tensor")
    v_local = local_logits.shape[-1]
    start = comm.rank(group) * v_local
    logits = local_logits.float()
    if vocab_size is not None:
        cols = start + torch.arange(v_local, device=logits.device)
        logits = logits.masked_fill(cols >= vocab_size, -torch.inf)
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    local = (safe - start).clamp(0, v_local - 1)
    in_shard = (safe >= start) & (safe < start + v_local)
    # the max cancels in log(sum exp(l - m)) - (l_gold - m): no gradient
    m = comm.all_reduce(logits.detach().amax(-1), group,
                        torch.distributed.ReduceOp.MAX)
    # every rank reads the same sums and its own columns reach the loss
    # only through its share: the sum's gradient is the identity
    sumexp = comm.reduce_from_group(torch.exp(logits - m[:, None]).sum(-1),
                                    group)
    gold = comm.reduce_from_group(torch.where(
        in_shard, logits.gather(1, local[:, None])[:, 0] - m, 0.0), group)
    nll = torch.where(valid, torch.log(sumexp) - gold, 0.0)
    return nll.sum() / valid.sum().clamp(min=1)
