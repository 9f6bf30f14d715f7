"""Collectives of the port's parallel layer, and their autograd.

Every collective takes a process group that may be None (a group of one
rank), and then returns its input as it is, so the same model code runs in
one process and on a mesh.

Host staging. `gloo` runs all_reduce, broadcast, all_gather_into_tensor,
reduce_scatter_tensor and all_to_all_single on CUDA tensors, but its
point-to-point send and receive do not take them (the process on the other
end fails; `chip_diag/collectives.py` shows it on an H100). So under the
gloo backend, and only there, `ring_shift` copies CUDA tensors into pinned
host memory, exchanges those and copies the result back; `STAGED_BYTES`
counts the bytes it copies each way, by operation. NCCL and CPU tensors
never take that path. gloo's own collectives copy CUDA tensors through
host memory inside the library; `STAGED_BYTES` counts those bytes too
(all_reduce and all_gather: the input's bytes to the host, the result's
back).
"""

import torch
import torch.distributed as dist

# bytes copied through host memory under gloo, by operation
STAGED_BYTES = {"ring_shift": 0, "all_reduce": 0, "all_gather": 0}


def reset_staged_bytes():
    for k in STAGED_BYTES:
        STAGED_BYTES[k] = 0


def size(group):
    return 1 if group is None else dist.get_world_size(group)


def rank(group):
    return 0 if group is None else dist.get_rank(group)


def all_reduce(t, group, op=dist.ReduceOp.SUM):
    """t reduced over the group, in place; t is returned."""
    if group is not None:
        if _staged(t, group):
            STAGED_BYTES["all_reduce"] += 2 * t.numel() * t.element_size()
        dist.all_reduce(t, op=op, group=group)
    return t


def all_gather(t, group, dim=0):
    """The group's tensors concatenated along dim, in rank order."""
    n = size(group)
    if n == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
    if _staged(t, group):
        STAGED_BYTES["all_gather"] += (1 + n) * t.numel() * t.element_size()
    dist.all_gather_into_tensor(out, t, group=group)
    return out.movedim(0, dim)


def reduce_scatter(t, group, dim=0):
    """The sum of the group's tensors, this rank's 1/n of it along dim."""
    n = size(group)
    if n == 1:
        return t
    t = t.movedim(dim, 0).contiguous()
    out = t.new_empty((t.shape[0] // n,) + tuple(t.shape[1:]))
    dist.reduce_scatter_tensor(out, t, group=group)
    return out.movedim(0, dim)


def all_to_all(t, group):
    """Chunk i of t's leading dim goes to rank i; chunk i of the result
    came from rank i."""
    if size(group) == 1:
        return t
    t = t.contiguous()
    out = torch.empty_like(t)
    dist.all_to_all_single(out, t, group=group)
    return out


def _staged(t, group):
    return (t.device.type == "cuda"
            and dist.get_backend(group) == dist.Backend.GLOO)


def ring_shift(tensors, group, step=1):
    """Each tensor sent `step` ranks on around the group's ring and
    replaced by the one sent to this rank (step 1: rank i receives rank
    i-1's; step -1 the other way): one batch_isend_irecv. Under gloo, CUDA
    tensors go through pinned host memory (module docstring)."""
    n = size(group)
    if n == 1:
        return list(tensors)
    me = rank(group)
    nxt = dist.get_global_rank(group, (me + step) % n)
    prv = dist.get_global_rank(group, (me - step) % n)
    staged = _staged(tensors[0], group)
    sends, recvs = [], []
    for t in tensors:
        t = t.contiguous()
        if staged:
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            STAGED_BYTES["ring_shift"] += 2 * host.numel() * host.element_size()
            t = host
        sends.append(t)
        recvs.append(torch.empty_like(t))
    ops = []
    for s, r in zip(sends, recvs):
        ops.append(dist.P2POp(dist.isend, s, nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if staged:
        device = tensors[0].device
        recvs = [r.to(device, non_blocking=True) for r in recvs]
    return recvs


# --------------------------------------------------------------- autograd

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; the gradient summed over the group (Megatron's
    `f`: the input of a column-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Sum over the group forward; identity backward (Megatron's `g`: the
    output of a row-parallel layer)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group forward and backward: every rank's objective
    reads the sum, so each input's gradient is the sum of every rank's."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_reduce(x.contiguous().clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


class _GatherFromGroup(torch.autograd.Function):
    """All-gather along dim forward; backward this rank's chunk of the
    gradient (Megatron's gather: every rank reads the same whole tensor,
    and its own chunk reaches the loss only through itself)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        n, r = size(ctx.group), rank(ctx.group)
        return g.chunk(n, dim=ctx.dim)[r].contiguous(), None, None


class _GatherAveraged(torch.autograd.Function):
    """All-gather along dim forward; backward the gradient summed over the
    group and this rank's chunk of it taken (reduce-scatter), for groups
    whose gradients the Trainer averages (the sequence axis)."""

    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter(g, ctx.group, ctx.dim), None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return all_to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return all_to_all(g, ctx.group), None


def copy_to_group(x, group):
    return x if size(group) == 1 else _CopyToGroup.apply(x, group)


def reduce_from_group(x, group):
    return x if size(group) == 1 else _ReduceFromGroup.apply(x, group)


def all_reduce_sum(x, group):
    """Differentiable sum over the group (gradient: the sum too)."""
    return x if size(group) == 1 else _AllReduceSum.apply(x, group)


def gather_from_group(x, group, dim):
    """Differentiable all-gather along dim (gradient: this rank's chunk)."""
    return x if size(group) == 1 else _GatherFromGroup.apply(x, group, dim)


def gather_averaged(x, group, dim):
    """Differentiable all-gather along dim (gradient: reduce-scatter)."""
    return x if size(group) == 1 else _GatherAveraged.apply(x, group, dim)


def all_to_all_grad(x, group):
    """Differentiable all_to_all over the leading dim."""
    return x if size(group) == 1 else _AllToAll.apply(x, group)
