"""Ring attention: exact attention with the sequence split over the
`sequence` axis of the mesh.

Counterpart of easynlp_tpu/ops/ring_attention.py:29-81. Each rank holds
its S/n tokens of q, k, v and the key mask; the K/V/mask chunks travel
around the ring of the group (comm.ring_shift: batch_isend_irecv) while
each rank merges its queries' results hop by hop, so no rank holds more
than two chunks of keys.

JAX writes the ring with lax collectives and takes the backward from
autodiff. Here it is a torch.autograd.Function over the port's kernels:

- each forward hop launches B3 (`flash_attention_fwd`, csrc/
  flash_attention_fwd.cu), which returns the hop's O and f32 LSE; the hop
  merges into the running result by the logsumexp of the LSEs, in f32;
- each backward hop launches B4/B5 (`flash_attention_bwd`, csrc/
  flash_attention_bwd.cu) with the *global* O and LSE, so its P is the
  global softmax restricted to the hop's keys. dQ accumulates on the rank;
  dK and dV travel with their chunk, in f32, and are home after n hops;
- causal hops use where the source chunk lies: before the local one every
  key is visible (causal=False); the local chunk takes causal=True at
  offset 0; after it the hop is skipped (its chunks still travel).

On a CPU tensor the wrappers run their plain twins; on a CUDA tensor a hop
launches the kernels or raises. There is no other path.

A fully masked query row (every key masked or causally hidden) gives what
attention() gives: the mean of V over all S keys, and dO/S to every key's
dV (ROADMAP C1: JAX's ring gives zeros there, its local path the mean).
The kernels would give each hop's mean over its own S/n keys, so the ring
keeps such rows out of the kernels' results (their dO is zeroed for the
backward) and forms both from the sum of V and of dO.
"""

import math

import torch

from easynlp_tpu_torch.ops.attention import (
    MASKED_ROW_LSE,
    NEG_INF,
    _kernel_ready,
    flash_attention_bwd,
    flash_attention_fwd,
)
from easynlp_tpu_torch.parallel import comm


def _hops(n, me, causal):
    """(hop, source chunk, causal flag or None to skip) for each hop."""
    for i in range(n):
        src = (me - i) % n
        if causal and src > me:
            yield i, src, None
        else:
            yield i, src, bool(causal and src == me)


def _rows(t):
    """[B,H,Sq] -> [B,Sq,H,1], to scale [B,Sq,H,D] rows."""
    return t.transpose(1, 2)[..., None]


class RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, kv_mask, group, causal, scale):
        n, me = comm.size(group), comm.rank(group)
        b, c, h, d = q.shape
        total = n * c
        q, k, v = _kernel_ready(q), _kernel_ready(k), _kernel_ready(v)
        kv_mask = kv_mask.to(torch.int32).contiguous()
        acc = torch.zeros((b, c, h, d), dtype=torch.float32, device=q.device)
        lse = torch.full((b, h, c), -math.inf, dtype=torch.float32,
                         device=q.device)
        v_sum = torch.zeros((b, h, d), dtype=torch.float32, device=q.device)
        k_cur, v_cur, m_cur = k, v, kv_mask
        for i, _, hop_causal in _hops(n, me, causal):
            v_sum += v_cur.float().sum(1)
            if hop_causal is not None:
                o_i, lse_i = flash_attention_fwd(q, k_cur, v_cur, m_cur,
                                                 hop_causal, scale)
                lse_i = lse_i.masked_fill(lse_i < MASKED_ROW_LSE, -math.inf)
                new = torch.logaddexp(lse, lse_i)
                ref = torch.where(torch.isinf(new), 0.0, new)
                acc = (acc * _rows(torch.exp(lse - ref))
                       + o_i.float() * _rows(torch.exp(lse_i - ref)))
                lse = new
            if i < n - 1:
                k_cur, v_cur, m_cur = comm.ring_shift([k_cur, v_cur, m_cur],
                                                      group)
        seen = torch.isfinite(lse)
        out = torch.where(_rows(seen), acc, (v_sum / total)[:, None])
        out = out.to(q.dtype)
        lse = lse.masked_fill(~seen, NEG_INF)
        ctx.save_for_backward(q, k, v, kv_mask, out, lse)
        ctx.group, ctx.causal, ctx.scale = group, causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_mask, out, lse = ctx.saved_tensors
        group, causal, scale = ctx.group, ctx.causal, ctx.scale
        n, me = comm.size(group), comm.rank(group)
        total = n * q.shape[1]
        masked = _rows(lse < MASKED_ROW_LSE)
        # fully masked rows: dO/S to every key, outside the kernels
        do_masked = torch.where(masked, do.float(), 0.0).sum(1) / total
        do = _kernel_ready(torch.where(masked, torch.zeros_like(do), do))
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        k_cur, v_cur, m_cur = k, v, kv_mask
        for i, _, hop_causal in _hops(n, me, causal):
            dv += do_masked[:, None]
            if hop_causal is not None:
                dq_i, dk_i, dv_i = flash_attention_bwd(
                    q, k_cur, v_cur, m_cur, out, lse, do, hop_causal, scale)
                dq += dq_i.float()
                dk += dk_i.float()
                dv += dv_i.float()
            if n > 1:
                moved = [dk, dv] if i == n - 1 else [k_cur, v_cur, m_cur,
                                                     dk, dv]
                moved = comm.ring_shift(moved, group)
                dk, dv = moved[-2:]
                if i < n - 1:
                    k_cur, v_cur, m_cur = moved[:3]
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def ring_attention(q, k, v, kv_mask=None, group=None, causal=False,
                   scale=None):
    """This rank's chunk of exact attention over the group's ring: q/k/v
    [B, S/n, H, D] (the rank's tokens, in rank order along the sequence),
    kv_mask [B, S/n] int32 or bool. Returns [B, S/n, H, D] in q's dtype."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if kv_mask is None:
        kv_mask = torch.ones(k.shape[:2], dtype=torch.int32,
                             device=k.device)
    return RingAttention.apply(q, k, v, kv_mask, group, bool(causal),
                               float(scale))
