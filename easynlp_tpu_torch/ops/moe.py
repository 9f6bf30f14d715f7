"""Switch-Transformer mixture-of-experts FFN for the PyTorch port.

Counterpart of easynlp_tpu/ops/moe.py:23-117 (SwitchMoE), with its
parameters (router [D,E], wi [E,D,F], wo [E,F,D], bi [E,F], bo [E,D]) and
numerics: an f32 router, top-k dispatch into capacity buckets of
C = max(k, ceil(k N / E * capacity_factor)) slots, the combine gates
renormalised over the chosen experts for k > 1, the buckets as one-hot
einsums, and Switch's load-balancing loss E * sum_e f_e p_e with f_e from
the routing before any token is dropped.

On a mesh the tokens are split over the batch axes (data, fsdp, expert:
parallel/mesh.py BATCH_AXES), and JAX's GSPMD semantics are kept: the
capacity comes from the global token count, each token's slot in its
expert's bucket is its position in the global token order (this rank's
offset per expert is the sum of the lower ranks' counts, from one
all_gather), and f_e and p_e are means over the global batch. So the same
tokens are dropped as in one process.

Expert parallelism: over the `expert` axis each rank holds E/ep experts
(`shard_experts`). The rank's [E, C, D] buckets go to the experts' owners
with all_to_all (slots are disjoint across ranks, so an owner sums what it
receives), its experts run, and a second all_to_all brings every owner's
[E/ep, C, D] outputs back. Expert parameters are tagged
`expert_parallel` so the Trainer reduces their gradients over the data
axes alone.
"""

import functools
import math

import torch
import torch.nn.functional as F
from torch import nn

from easynlp_tpu_torch.parallel import comm
from easynlp_tpu_torch.parallel.mesh import BATCH_AXES, axis_group


class SwitchMoE(nn.Module):
    """Drop-in MLP: x [..., D] -> (y [..., D] in dtype, f32 aux loss)."""

    def __init__(self, d_model, d_ff, num_experts, top_k=1,
                 capacity_factor=1.25, router_jitter=0.01,
                 activation=None, dtype=torch.float32, device=None):
        super().__init__()
        e, d, f = num_experts, d_model, d_ff
        self.num_experts = e
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        self.router_jitter = router_jitter
        # flax's nn.gelu, JAX's default: the tanh form
        self.activation = activation or functools.partial(
            F.gelu, approximate="tanh")
        self.dtype = dtype
        self.router = nn.Parameter(torch.empty(d, e, device=device))
        self.wi = nn.Parameter(torch.empty(e, d, f, device=device))
        self.wo = nn.Parameter(torch.empty(e, f, d, device=device))
        self.bi = nn.Parameter(torch.zeros(e, f, device=device))
        self.bo = nn.Parameter(torch.zeros(e, d, device=device))

    def expert_parameters(self):
        return [self.wi, self.wo, self.bi, self.bo]

    @torch.no_grad()
    def shard_experts(self, rank, size):
        """Keep experts [rank E/size, (rank+1) E/size): this rank's share
        over an expert axis of `size` ranks."""
        e = self.num_experts
        if e % size:
            raise ValueError("%d experts do not split over %d expert ranks"
                             % (e, size))
        per = e // size
        for p in self.expert_parameters():
            p.data = p.data[rank * per:(rank + 1) * per].clone()
            p.expert_parallel = True

    def capacity(self, n_tokens):
        k = self.top_k
        return max(k, int(math.ceil(k * n_tokens / self.num_experts
                                    * self.capacity_factor)))

    def forward(self, x, deterministic=True):
        e, k, dt = self.num_experts, self.top_k, self.dtype
        shape = x.shape
        x = x.reshape(-1, shape[-1])
        n = x.shape[0]
        tokens = axis_group(BATCH_AXES)
        experts = axis_group("expert")
        n_global = n * comm.size(tokens)
        capacity = self.capacity(n_global)

        logits = x.float() @ self.router
        if not deterministic and self.training and self.router_jitter > 0:
            j = self.router_jitter
            logits = logits * torch.empty_like(logits).uniform_(1 - j, 1 + j)
        probs = torch.softmax(logits, dim=-1)

        dispatch = torch.zeros_like(probs)
        gates = torch.zeros_like(probs)
        remaining = probs
        for _ in range(k):
            onehot = F.one_hot(remaining.argmax(-1), e).float()
            gates = gates + onehot * probs
            dispatch = dispatch + onehot
            remaining = remaining * (1.0 - onehot)
        if k > 1:
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        assigned = dispatch.detach()
        # slot of each token in its expert's bucket, in the global order
        offset = 0.0
        if comm.size(tokens) > 1:
            counts = comm.all_gather(dispatch.sum(0, keepdim=True), tokens)
            offset = counts[:comm.rank(tokens)].sum(0)
        position = (torch.cumsum(dispatch, 0) + offset) * dispatch - 1.0
        keep = (position >= 0) & (position < capacity)
        dispatch = dispatch * keep
        gates = gates * keep
        slot = position.long()
        pos_oh = F.one_hot(slot.clamp(0, capacity - 1), capacity).float() \
            * keep[..., None]
        dispatch_nec = dispatch[..., None] * pos_oh
        combine_nec = gates[..., None] * pos_oh

        xin = torch.einsum("nec,nd->ecd", dispatch_nec.to(dt), x.to(dt))
        ep = comm.size(experts)
        if ep > 1:
            # bucket slices to their experts' owners; sum what arrives
            xin = comm.all_to_all_grad(xin, experts)
            xin = xin.reshape(ep, e // ep, *xin.shape[1:]).sum(0)
        h = self.activation(torch.einsum("ecd,edf->ecf", xin,
                                         self.wi.to(dt))
                            + self.bi[:, None].to(dt))
        xout = torch.einsum("ecf,efd->ecd", h, self.wo.to(dt)) \
            + self.bo[:, None].to(dt)
        if ep > 1:
            # every owner's outputs back to every rank, in expert order
            xout = comm.all_to_all_grad(xout.repeat(ep, 1, 1), experts)
        out = torch.einsum("nec,ecd->nd", combine_nec.to(dt), xout)

        f_e = assigned.sum(0)
        p_e = probs.sum(0)
        if comm.size(tokens) > 1:
            f_e = comm.all_reduce(f_e.clone(), tokens)
            p_e = comm.all_reduce_sum(p_e, tokens)
        f_e = f_e / n_global / k
        p_e = p_e / n_global
        aux = e * torch.sum(f_e * p_e)
        return out.reshape(shape), aux
