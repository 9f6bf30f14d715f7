"""Pipeline parallelism: the GPipe schedule over the `pipeline` axis.

Counterpart of easynlp_tpu/parallel/pipeline.py:24-113. Each rank of the
pipeline group holds one stage's parameters; the batch is cut into M
micro-batches and runs fill and drain: at tick t stage s works on
micro-batch t - s, M + S - 1 ticks in all, and after each tick every
stage's activation moves one stage on (comm.ring_shift, cyclic as JAX's
ppermute: stage 0 takes a fresh micro-batch instead of what arrives). The
last stage banks each finished micro-batch and the outputs are summed over
the group, so every rank returns them, as JAX's psum does.

JAX differentiates its schedule. Here `gpipe` is a torch.autograd.Function
that runs the backward schedule itself, in reverse tick order: every rank
takes part in every tick's exchange, which autograd's own order would not
promise across ranks. Each active tick's stage is recomputed from its saved
input and differentiated with torch.autograd.grad; the input's gradient
moves one stage back. Gradients equal those of the stages run in sequence.
The Trainer does not call it, as the JAX Trainer does not call JAX's.
"""

import torch

from easynlp_tpu_torch.parallel import comm


class _GPipe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, stage_fn, group, m_count, x, *params):
        s_count, stage = comm.size(group), comm.rank(group)
        if x.shape[0] % m_count:
            raise ValueError("batch %d does not divide into %d "
                             "micro-batches" % (x.shape[0], m_count))
        xs = x.reshape((m_count, -1) + tuple(x.shape[1:]))
        state = torch.zeros_like(xs[0])
        outputs = torch.zeros_like(xs)
        inputs = {}
        for t in range(m_count + s_count - 1):
            m = t - stage
            y = torch.zeros_like(state)
            if 0 <= m < m_count:
                x_in = xs[m] if stage == 0 else state
                inputs[t] = x_in
                y = stage_fn(list(params), x_in)
                if stage == s_count - 1:
                    outputs[m] = y
            state = comm.ring_shift([y], group)[0]
        outputs = comm.all_reduce(outputs, group)
        ctx.stage_fn, ctx.group, ctx.m_count = stage_fn, group, m_count
        ctx.inputs = inputs
        ctx.save_for_backward(*params)
        return outputs.reshape(x.shape)

    @staticmethod
    def backward(ctx, g):
        params = ctx.saved_tensors
        group, m_count = ctx.group, ctx.m_count
        s_count, stage = comm.size(group), comm.rank(group)
        g = g.reshape((m_count, -1) + tuple(g.shape[1:]))
        leaves = [p.detach().requires_grad_() for p in params]
        grads = [torch.zeros_like(p) for p in params]
        dx = torch.zeros_like(g)
        g_state = torch.zeros_like(g[0])
        for t in reversed(range(m_count + s_count - 1)):
            # the adjoint of tick t's shift: back one stage
            g_y = comm.ring_shift([g_state], group, step=-1)[0]
            m = t - stage
            g_state = torch.zeros_like(g_y)
            if not 0 <= m < m_count:
                continue
            if stage == s_count - 1:
                g_y = g_y + g[m]
            x_in = ctx.inputs[t].detach().requires_grad_()
            with torch.enable_grad():
                y = ctx.stage_fn(leaves, x_in)
            got = torch.autograd.grad(y, [x_in] + leaves, g_y,
                                      allow_unused=True)
            for acc, gp in zip(grads, got[1:]):
                if gp is not None:
                    acc += gp
            if stage == 0:
                dx[m] = got[0]
            else:
                g_state = got[0]
        # x is the same on every rank: its gradient (stage 0's) on each
        dx = comm.all_reduce(dx, group)
        return (None, None, None, dx.reshape((-1,) + tuple(dx.shape[2:])),
                *grads)


def gpipe(stage_fn, stage_params, x, num_microbatches, group=None):
    """y = f_{S-1}(... f_0(x)) over the pipeline group (default: the
    mesh's `pipeline` group): stage_fn(params, x_micro) -> the same shape;
    stage_params: this rank's stage (a list of tensors); x [B, ...], the
    same on every rank. Returns y [B, ...] on every rank."""
    if group is None:
        from easynlp_tpu_torch.parallel.mesh import axis_group
        group = axis_group("pipeline")
    return _GPipe.apply(stage_fn, group, int(num_microbatches), x,
                        *stage_params)
