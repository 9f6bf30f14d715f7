"""Optimizers and learning-rate schedules for the PyTorch port.

Counterpart of easynlp_tpu/core/optimizers.py, with the same update rules
and order of operations:

- `BertAdam`: no bias correction, weight decay added to the update before
  the learning rate, its own global-norm clip (min(1, c / (norm + 1e-6))),
  eps forced to 1e-6 by `get_optimizer`;
- `AdamW` / `Adam`: optax's chain, i.e. clip_by_global_norm ->
  scale_by_adam (bias-corrected) -> masked add_decayed_weights -> -lr;
- `SGD`: clip -> -lr * g;
- `Lion`: optax.lion's chain, i.e. clip_by_global_norm -> sign((1 - b1) g +
  b1 m) with m = b2 m + (1 - b2) g -> masked add_decayed_weights -> -lr;
- `Adafactor`: optax.adafactor with its defaults, i.e. scale_by_factored_rms
  (factored second moments where the two largest dims are >= 128) ->
  clip_by_block_rms(1) -> lr -> scale_by_param_block_rms -> -1.

The schedule is read at the optimizer's step count before it increments, as
optax reads it, so warmup_linear's first step has lr 0. Weight decay skips
every parameter whose name holds one of NO_DECAY_SUBSTRINGS (biases and
LayerNorm), which picks the same parameters under the port's HF names as
under the JAX package's flax paths.

An optimizer holds a list of named f32 parameters and updates them in place
with PyTorch's multi-tensor (`_foreach`) operations: a handful of launches
per step for the whole model rather than several per parameter. Its step
count lives on the parameters' device, and the learning rate is read there
from a table of the schedule over the run's steps, so a step never waits
for the device: `step(grads, apply=flag)` takes a 0-d bool tensor and,
where it is False, leaves the parameters, the state and the count exactly
as they were (the Trainer's non-finite guard, which optax's lax.cond gives
the JAX Trainer). Such a step's gradients are replaced by zeros and every
coefficient of the update is switched to the identity (decay 1, gradient
weight 0, learning rate 0), so no select over the state is needed.
"""

import math

import torch

from easynlp_tpu_torch.parallel import comm

NO_DECAY_SUBSTRINGS = ("bias", "LayerNorm", "layer_norm", "_ln", "ln_")


# -- schedules (fraction x = step/t_total, warmup w) --------------------------

def constant_schedule(lr, **_):
    return lambda step: lr


def warmup_constant_schedule(lr, warmup, t_total):
    def f(step):
        x = step / max(t_total, 1)
        return lr * min(x / max(warmup, 1e-8), 1.0)
    return f


def warmup_linear_schedule(lr, warmup, t_total):
    def f(step):
        x = step / max(t_total, 1)
        if x < warmup:
            return lr * x / max(warmup, 1e-8)
        return lr * max((1.0 - x) / max(1.0 - warmup, 1e-8), 0.0)
    return f


def warmup_cosine_schedule(lr, warmup, t_total, cycles=0.5):
    def f(step):
        x = step / max(t_total, 1)
        if x < warmup:
            return lr * x / max(warmup, 1e-8)
        prog = (x - warmup) / max(1.0 - warmup, 1e-8)
        cos = 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * prog))
        return lr * max(cos, 0.0)
    return f


def warmup_cosine_hard_restarts_schedule(lr, warmup, t_total, cycles=1.0):
    def f(step):
        x = step / max(t_total, 1)
        if x < warmup:
            return lr * x / max(warmup, 1e-8)
        prog = (x - warmup) / max(1.0 - warmup, 1e-8)
        cos = 0.5 * (1.0 + math.cos(math.pi * ((cycles * prog) % 1.0)))
        return lr * max(cos, 0.0)
    return f


SCHEDULES = {
    "none": constant_schedule,
    "constant": constant_schedule,
    "warmup_constant": warmup_constant_schedule,
    "warmup_linear": warmup_linear_schedule,
    "warmup_cosine": warmup_cosine_schedule,
    "warmup_cosine_with_hard_restarts": warmup_cosine_hard_restarts_schedule,
}


def decays(name):
    """True where weight decay applies (not biases, not LayerNorm)."""
    return not any(sub in name for sub in NO_DECAY_SUBSTRINGS)


def norms(tensors):
    """Each tensor's L2 norm, a 1-D f64 tensor: summed in f64, as the
    CPU's f32 sum over a table of millions of elements (BERT's word
    embeddings) drifts from the exact norm where a split of the table,
    summed in parts, does not (tests/test_torch_mesh_trainer.py)."""
    return torch.stack(torch._foreach_norm(tensors, dtype=torch.float64))


def global_norm(tensors):
    """sqrt of the sum of squares over all tensors, as a 0-d f32 tensor."""
    return torch.linalg.vector_norm(norms(tensors)).float()


def _zeros_unless(apply, tensors):
    """The tensors where `apply` (0-d bool) is set, else zeros of their
    shapes: one select over their concatenation, handed back as views."""
    flat = torch.cat([t.reshape(-1) for t in tensors])
    flat = torch.where(apply, flat, torch.zeros((), dtype=flat.dtype,
                                                device=flat.device))
    return [v.view_as(t) for v, t in
            zip(flat.split([t.numel() for t in tensors]), tensors)]


class Optimizer:
    """Named f32 parameters, their state and a step count (a 0-d int64
    tensor on the parameters' device). `step(grads)` updates the
    parameters in place at lr = schedule_fn(count), then counts the step.
    The learning rates of counts 0..num_steps are tabled on the device
    (counts past num_steps read the last entry). Subclasses define
    `_update(grads, lr, coef)` and their state; `coef` holds their
    `coefficients` ((value, identity) pairs: the identity leaves the state
    as it is) as a 1-D f32 tensor, the values or, on a skipped step, the
    identities. State under `replicated_keys` is whole on every rank of a
    mesh (neither split nor gathered at save and resume)."""

    state_keys = ()
    replicated_keys = ()
    coefficients = ()

    def __init__(self, named_params, schedule_fn, weight_decay=0.0,
                 max_grad_norm=0.0, num_steps=1):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule_fn = schedule_fn
        self.weight_decay = float(weight_decay or 0.0)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.decay_index = [i for i, n in enumerate(self.names) if decays(n)]
        device = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=device)
        self.lr_table = torch.tensor(
            [schedule_fn(i) for i in range(max(int(num_steps), 0) + 1)],
            dtype=torch.float32, device=device)
        self.state = {key: [torch.zeros_like(p) for p in self.params]
                      for key in self.state_keys}
        self._coef = torch.tensor(
            list(zip(*self.coefficients)) or [[], []],
            dtype=torch.float32, device=device)

    @torch.no_grad()
    def step(self, grads=None, apply=None):
        """grads: one tensor per parameter, in order (default: each
        parameter's .grad; a missing gradient counts as zeros). apply: a
        0-d bool tensor on the parameters' device; where False, the step
        leaves parameters, state and count as they were."""
        grads = [p.grad for p in self.params] if grads is None else list(grads)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        lr = self.lr_table[self.count.clamp(max=len(self.lr_table) - 1)]
        coef = self._coef[0]
        if apply is not None:
            grads = _zeros_unless(apply, grads)
            lr = lr * apply
            coef = torch.where(apply, coef, self._coef[1])
        self._update(grads, lr, coef)
        self.count += 1 if apply is None else apply.to(torch.int64)

    def _add_decay(self, updates):
        """updates += weight_decay * param, on the decayed parameters."""
        if self.weight_decay and self.decay_index:
            torch._foreach_add_([updates[i] for i in self.decay_index],
                                [self.params[i] for i in self.decay_index],
                                alpha=self.weight_decay)

    def _apply(self, updates, lr):
        """params -= lr * updates (lr a 0-d tensor; updates are
        overwritten)."""
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(self.params, updates)

    def _clip(self, grads):
        """optax.clip_by_global_norm: unchanged below the bound, else
        g / norm * bound."""
        if self.max_grad_norm <= 0:
            return grads
        norm = global_norm(grads)
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm), self.max_grad_norm / norm)
        return torch._foreach_mul(grads, scale)

    def _state_names(self, key):
        """The parameter name of each buffer of state[key]."""
        return self.names

    def state_dict(self):
        return {"type": type(self).__name__, "count": int(self.count),
                "names": list(self.names),
                **{key: dict(zip(self._state_names(key), self.state[key]))
                   for key in self.state_keys}}

    def load_state_dict(self, state):
        if state.get("type") != type(self).__name__:
            raise ValueError("optimizer state of %s, this is %s"
                             % (state.get("type"), type(self).__name__))
        self.count.fill_(int(state["count"]))
        for key in self.state_keys:
            for buf, name in zip(self.state[key], self._state_names(key)):
                buf.copy_(state[key][name])


def _moment_coefficients(b1, b2):
    """Adam's moment coefficients (b1, 1 - b1, b2, 1 - b2), each paired
    with the identity's (1, 0)."""
    return ((b1, 1.0), (1 - b1, 0.0), (b2, 1.0), (1 - b2, 0.0))


def _moment(buffers, grads, decay, weight):
    """buffers = decay * buffers + weight * grads (decay and weight 0-d
    tensors), optax's update_moment."""
    torch._foreach_mul_(buffers, decay)
    torch._foreach_add_(buffers, torch._foreach_mul(grads, weight))


class BertAdam(Optimizer):
    """Reference BertAdam: global clip -> m, v (no bias correction) ->
    update = m / (sqrt(v) + eps) + wd * p -> p -= lr * update."""

    state_keys = ("m", "v")

    def __init__(self, named_params, schedule_fn, b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.01, max_grad_norm=1.0, num_steps=1):
        self.eps = eps
        self.coefficients = _moment_coefficients(b1, b2)
        super().__init__(named_params, schedule_fn, weight_decay,
                         max_grad_norm, num_steps)

    def _update(self, grads, lr, coef):
        if self.max_grad_norm > 0:
            norm = global_norm(grads)
            scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
            grads = torch._foreach_mul(grads, scale)
        m, v = self.state["m"], self.state["v"]
        b1, w1, b2, w2 = coef.unbind()
        _moment(m, grads, b1, w1)
        _moment(v, torch._foreach_mul(grads, grads), b2, w2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(m, denom)
        self._add_decay(updates)
        self._apply(updates, lr)


class AdamW(Optimizer):
    """optax.chain(clip_by_global_norm, scale_by_adam,
    add_decayed_weights(mask), scale_by_learning_rate): decoupled decay
    with bias correction. weight_decay=0 is Adam."""

    state_keys = ("mu", "nu")

    def __init__(self, named_params, schedule_fn, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, max_grad_norm=1.0, num_steps=1):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.coefficients = _moment_coefficients(b1, b2)
        super().__init__(named_params, schedule_fn, weight_decay,
                         max_grad_norm, num_steps)

    def _update(self, grads, lr, coef):
        grads = self._clip(grads)
        mu, nu = self.state["mu"], self.state["nu"]
        b1, w1, b2, w2 = coef.unbind()
        _moment(mu, grads, b1, w1)
        _moment(nu, torch._foreach_mul(grads, grads), b2, w2)
        # bias corrections 1 - b^t in float64 on the device, t the count
        # this step would reach
        t = (self.count + 1).to(torch.float64)
        denom = torch._foreach_div(nu, (1 - torch.pow(self.b2, t)).float())
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, (1 - torch.pow(self.b1, t)).float())
        torch._foreach_div_(updates, denom)
        self._add_decay(updates)
        self._apply(updates, lr)


class Lion(Optimizer):
    """optax.chain(clip_by_global_norm, lion(schedule, b1, b2,
    weight_decay)): the update is the sign of (1 - b1) g + b1 m, the
    momentum m = b2 m + (1 - b2) g. Decay is masked like AdamW's (the JAX
    package's optax.lion gets no mask and decays biases and LayerNorm
    too).

    Unlike the JAX package, the clip is left out when max_grad_norm is 0,
    as for SGD: the JAX Trainer passes 0 and clips itself, and
    optax.clip_by_global_norm(0) zeroes every update, so a JAX Lion run
    through its Trainer never moves (ROADMAP C8)."""

    state_keys = ("mu",)

    def __init__(self, named_params, schedule_fn, b1=0.9, b2=0.99,
                 weight_decay=1e-3, max_grad_norm=1.0, num_steps=1):
        # (1 - b1, b1) of the sign's argument (not switched on a skipped
        # step: lr 0 holds the parameters), then the momentum's
        self.mix = (1.0 - b1, b1)
        self.coefficients = ((b2, 1.0), (1.0 - b2, 0.0))
        super().__init__(named_params, schedule_fn, weight_decay,
                         max_grad_norm, num_steps)

    def _update(self, grads, lr, coef):
        grads = self._clip(grads)
        mu = self.state["mu"]
        updates = torch._foreach_mul(grads, self.mix[0])
        torch._foreach_add_(updates, torch._foreach_mul(mu, self.mix[1]))
        torch._foreach_sign_(updates)
        b2, w2 = coef.unbind()
        _moment(mu, grads, b2, w2)
        self._add_decay(updates)
        self._apply(updates, lr)


class Adafactor(Optimizer):
    """optax.adafactor(schedule) with optax's defaults: decay rate 0.8
    (beta2 at step t = 1 - t^-0.8), eps 1e-30, second moments factored into
    row and column means where the two largest dims are >= 128, the update
    clipped to block rms 1, scaled by the learning rate and by the
    parameter's rms (at least 1e-3); no momentum, no weight decay, no
    global-norm clip.

    State: per parameter `v_row`, `v_col` (factored) or `v` (the others),
    optax's layout with torch's [out, in] weights. optax factors over the
    two largest dims of the JAX [in, out] kernel; the row statistic is the
    mean over the largest dim whichever axis holds it, so the transposed
    layout gives the same update. Where the step is skipped, the decay is
    switched to 1, and a 1 added to the moments before their inverse root
    keeps the zeroed gradient's update at 0 even before the first real
    step.

    On a mesh (`splits`: each parameter's sharding.DimSplit list) every
    statistic is the whole parameter's, as JAX computes them on the global
    arrays: the factoring is decided on the whole shape, a mean over a
    split dim is summed over the group that split it, the factored state
    is whole on every rank (`replicated_keys`: JAX's _opt_state_shardings
    replicates it) and each rank takes its part of it, and the update's
    and the parameter's rms sum their squares over every group that split
    the parameter."""

    state_keys = ()  # set once the buffers, of other shapes, are built
    replicated_keys = ("v_row", "v_col")
    coefficients = ((1.0, 0.0),)  # on; 0 on a skipped step

    def __init__(self, named_params, schedule_fn, decay_rate=0.8,
                 eps=1e-30, min_dim_size_to_factor=128, clipping_threshold=1.0,
                 min_scale=1e-3, num_steps=1, splits=None):
        self.decay_rate, self.eps = decay_rate, eps
        self.clipping_threshold, self.min_scale = clipping_threshold, min_scale
        super().__init__(named_params, schedule_fn, num_steps=num_steps)
        self.splits = splits or [[] for _ in self.params]
        for name, s in zip(self.names, self.splits):
            if len({x.dim for x in s}) < len(s):
                raise NotImplementedError(
                    "Adafactor: %s is split twice along one dim" % name)
        shapes = [_whole_shape(p.shape, s)
                  for p, s in zip(self.params, self.splits)]
        self.factored = [_factored_dims(shape, min_dim_size_to_factor)
                         for shape in shapes]
        self.state = {"v_row": [], "v_col": [], "v": []}
        for p, shape, dims in zip(self.params, shapes, self.factored):
            if dims is None:
                self.state["v"].append(torch.zeros_like(p))
                continue
            d1, d0 = dims
            self.state["v_row"].append(p.new_zeros(
                [n for i, n in enumerate(shape) if i != d0]))
            self.state["v_col"].append(p.new_zeros(
                [n for i, n in enumerate(shape) if i != d1]))
        self.state_keys = ("v_row", "v_col", "v")
        self._root_sizes = torch.tensor(
            [math.sqrt(math.prod(shape)) for shape in shapes],
            dtype=torch.float32, device=self.count.device)
        self._split_groups = []  # (group, mask of the parameters it split)
        for s in {id(x.group): x for ss in self.splits for x in ss}.values():
            mask = torch.tensor([any(x.group is s.group for x in ss)
                                 for ss in self.splits],
                                device=self.count.device)
            self._split_groups.append((s.group, mask))

    def _state_names(self, key):
        factored = key != "v"
        return [n for n, dims in zip(self.names, self.factored)
                if (dims is not None) == factored]

    def _whole_mean(self, t, dim, splits):
        """mean over dim of t (a parameter's local part), the whole
        parameter's: summed over the group that split dim."""
        split = next((s for s in splits if s.dim == dim), None)
        if split is None:
            return t.mean(dim)
        return comm.all_reduce(t.sum(dim), split.group) / split.full

    @staticmethod
    def _whole(t, splits, removed):
        """The whole of t, a statistic of a local part without its dim
        `removed`: gathered along the split dims it kept."""
        for s in splits:
            if s.dim != removed:
                t = s.gather(t, s.dim - (s.dim > removed))
        return t

    @staticmethod
    def _local(t, splits, removed, fill):
        for s in splits:
            if s.dim != removed:
                t = s.local(t, s.dim - (s.dim > removed), fill)
        return t

    def _update(self, grads, lr, coef):
        on = coef[0]
        t = (self.count + 1).float()
        decay = 1.0 - on * t.pow(-self.decay_rate)
        weight = 1.0 - decay
        pad = 1.0 - on
        grads_f = [g for g, d in zip(grads, self.factored) if d is not None]
        grads_v = [g for g, d in zip(grads, self.factored) if d is None]
        dims = [d for d in self.factored if d is not None]
        splits = [s for s, d in zip(self.splits, self.factored)
                  if d is not None]
        updates_f = updates_v = []
        if grads_f:
            # factored: the row (mean over the largest dim) and column
            # statistics of g^2 + eps; the update g / sqrt(row / mean(row)
            # x col)
            sq = torch._foreach_mul(grads_f, grads_f)
            torch._foreach_add_(sq, self.eps)
            v_row, v_col = self.state["v_row"], self.state["v_col"]
            _moment(v_row, [
                self._whole(self._whole_mean(s, d0, sp), sp, d0)
                for s, (_, d0), sp in zip(sq, dims, splits)], decay, weight)
            _moment(v_col, [
                self._whole(self._whole_mean(s, d1, sp), sp, d1)
                for s, (d1, _), sp in zip(sq, dims, splits)], decay, weight)
            row = torch._foreach_add(v_row, pad)
            col = torch._foreach_add(v_col, pad)
            row_factor = torch._foreach_div(row, [
                r.mean(d1 - 1 if d1 > d0 else d1, keepdim=True)
                for r, (d1, d0) in zip(row, dims)])
            torch._foreach_pow_(row_factor, -0.5)
            torch._foreach_pow_(col, -0.5)
            row_factor = [self._local(r, sp, d0, 1.0) for r, (_, d0), sp
                          in zip(row_factor, dims, splits)]
            col = [self._local(k, sp, d1, 1.0) for k, (d1, _), sp
                   in zip(col, dims, splits)]
            updates_f = [g * r.unsqueeze(d0) * k.unsqueeze(d1) for g, r, k,
                         (d1, d0) in zip(grads_f, row_factor, col, dims)]
        if grads_v:
            sq = torch._foreach_mul(grads_v, grads_v)
            torch._foreach_add_(sq, self.eps)
            _moment(self.state["v"], sq, decay, weight)
            denom = torch._foreach_add(self.state["v"], pad)
            torch._foreach_pow_(denom, -0.5)
            updates_v = torch._foreach_mul(grads_v, denom)
        factored, plain = iter(updates_f), iter(updates_v)
        updates = [next(plain) if d is None else next(factored)
                   for d in self.factored]
        # clip_by_block_rms, lr and scale_by_param_block_rms (optax's
        # safe_root_mean_squares: the rms, min_scale at or below it) as one
        # factor per tensor, computed for all tensors at once
        rms = self._whole_norms(updates) / self._root_sizes
        p_rms = self._whole_norms(self.params) / self._root_sizes
        factor = lr * torch.clamp(p_rms, min=self.min_scale) / torch.clamp(
            rms / self.clipping_threshold, min=1.0)
        torch._foreach_mul_(updates, list(factor.unbind()))
        torch._foreach_sub_(self.params, updates)

    def _whole_norms(self, tensors):
        """Each whole parameter's norm: the squares of its parts summed
        over every group that split it."""
        sq = norms(tensors).square()
        for group, mask in self._split_groups:
            sq = torch.where(mask, comm.all_reduce(sq * mask, group), sq)
        return sq.sqrt().float()


def _whole_shape(shape, splits):
    shape = list(shape)
    for s in splits:
        shape[s.dim] = s.full
    return shape


def _factored_dims(shape, min_dim_size_to_factor):
    """optax's choice: (second largest dim, largest dim) when the second
    largest is at least min_dim_size_to_factor, else None (also for
    leaves of fewer than 2 dims). Ties keep the axis order, as numpy's
    argsort does on so few dims."""
    if len(shape) < 2:
        return None
    order = sorted(range(len(shape)), key=lambda i: shape[i])
    if shape[order[-2]] < min_dim_size_to_factor:
        return None
    return order[-2], order[-1]


class SGD(Optimizer):
    """optax.chain(clip_by_global_norm, sgd): p -= lr * g.

    Unlike the JAX package, the clip is left out when max_grad_norm is 0:
    there optax.clip_by_global_norm(0) scales every update to 0, so the JAX
    Trainer (which passes 0 and clips itself) never moves an SGD run's
    parameters (ROADMAP C8)."""

    def _update(self, grads, lr, coef):
        torch._foreach_add_(self.params,
                            torch._foreach_mul(self._clip(grads), -lr))


def get_optimizer(named_params, optimizer_type="AdamW", learning_rate=5e-5,
                  warmup_proportion=0.1, lr_scheduler="warmup_linear",
                  epoch_num=3.0, steps_per_epoch=100,
                  gradient_accumulation_steps=1, weight_decay=0.01,
                  max_grad_norm=1.0, b1=0.9, b2=0.999, eps=1e-8,
                  splits=None):
    """(optimizer over named_params, schedule_fn, t_total), with
    t_total = ceil(steps_per_epoch / grad_accum) * epochs. splits: each
    parameter's sharding.DimSplit list on a mesh (Adafactor reads them;
    the element-wise optimizers need none)."""
    t_total = int(math.ceil(steps_per_epoch / gradient_accumulation_steps)
                  * epoch_num)
    if lr_scheduler not in SCHEDULES:
        raise ValueError("unknown lr_scheduler %r" % lr_scheduler)
    schedule_fn = SCHEDULES[lr_scheduler](
        learning_rate, warmup=warmup_proportion, t_total=t_total) \
        if lr_scheduler not in ("none", "constant") \
        else constant_schedule(learning_rate)
    if optimizer_type == "BertAdam":
        opt = BertAdam(named_params, schedule_fn, b1=b1, b2=b2, eps=1e-6,
                       weight_decay=weight_decay, max_grad_norm=max_grad_norm,
                       num_steps=t_total)
    elif optimizer_type in ("AdamW", "Adam"):
        wd = weight_decay if optimizer_type == "AdamW" else 0.0
        opt = AdamW(named_params, schedule_fn, b1=b1, b2=b2, eps=eps,
                    weight_decay=wd, max_grad_norm=max_grad_norm,
                    num_steps=t_total)
    elif optimizer_type == "SGD":
        opt = SGD(named_params, schedule_fn, max_grad_norm=max_grad_norm,
                  num_steps=t_total)
    elif optimizer_type == "Lion":
        opt = Lion(named_params, schedule_fn, weight_decay=weight_decay,
                   max_grad_norm=max_grad_norm, num_steps=t_total)
    elif optimizer_type == "Adafactor":
        opt = Adafactor(named_params, schedule_fn, num_steps=t_total,
                        splits=splits)
    else:
        raise ValueError("unknown optimizer %r" % optimizer_type)
    return opt, schedule_fn, t_total
