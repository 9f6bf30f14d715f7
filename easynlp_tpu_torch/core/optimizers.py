"""Optimizers and learning-rate schedules for the PyTorch port.

Counterpart of easynlp_tpu/core/optimizers.py, with the same update rules
and order of operations:

- `BertAdam`: no bias correction, weight decay added to the update before
  the learning rate, its own global-norm clip (min(1, c / (norm + 1e-6))),
  eps forced to 1e-6 by `get_optimizer`;
- `AdamW` / `Adam`: optax's chain, i.e. clip_by_global_norm ->
  scale_by_adam (bias-corrected) -> masked add_decayed_weights -> -lr;
- `SGD`: clip -> -lr * g.

The schedule is read at the optimizer's step count before it increments, as
optax reads it, so warmup_linear's first step has lr 0. Weight decay skips
every parameter whose name holds one of NO_DECAY_SUBSTRINGS (biases and
LayerNorm), which picks the same parameters under the port's HF names as
under the JAX package's flax paths.

An optimizer holds a list of named f32 parameters and updates them in place
with PyTorch's multi-tensor (`_foreach`) operations: a handful of launches
per step for the whole model rather than several per parameter.
"""

import math

import torch

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


def global_norm(tensors):
    """sqrt of the sum of squares over all tensors, as a 0-d f32 tensor."""
    return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


class Optimizer:
    """Named f32 parameters, their state and a step count. `step(grads)`
    updates the parameters in place at lr = schedule_fn(count), then counts
    the step. Subclasses define `_update(grads, lr)` and their state."""

    state_keys = ()

    def __init__(self, named_params, schedule_fn, weight_decay=0.0,
                 max_grad_norm=0.0):
        named = list(named_params)
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.schedule_fn = schedule_fn
        self.weight_decay = float(weight_decay or 0.0)
        self.max_grad_norm = float(max_grad_norm or 0.0)
        self.decay_index = [i for i, n in enumerate(self.names) if decays(n)]
        self.count = 0
        self.state = {key: [torch.zeros_like(p) for p in self.params]
                      for key in self.state_keys}

    @torch.no_grad()
    def step(self, grads=None):
        """grads: one tensor per parameter, in order (default: each
        parameter's .grad; a missing gradient counts as zeros)."""
        grads = [p.grad for p in self.params] if grads is None else list(grads)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(self.params, grads)]
        self._update(grads, self.schedule_fn(self.count))
        self.count += 1

    def _add_decay(self, updates):
        """updates += weight_decay * param, on the decayed parameters."""
        if self.weight_decay and self.decay_index:
            torch._foreach_add_([updates[i] for i in self.decay_index],
                                [self.params[i] for i in self.decay_index],
                                alpha=self.weight_decay)

    def _clip(self, grads):
        """optax.clip_by_global_norm: unchanged below the bound, else
        g / norm * bound."""
        if self.max_grad_norm <= 0:
            return grads
        norm = global_norm(grads)
        scale = torch.where(norm < self.max_grad_norm,
                            torch.ones_like(norm), self.max_grad_norm / norm)
        return torch._foreach_mul(grads, scale)

    def state_dict(self):
        return {"type": type(self).__name__, "count": self.count,
                "names": list(self.names),
                **{key: dict(zip(self.names, self.state[key]))
                   for key in self.state_keys}}

    def load_state_dict(self, state):
        if state.get("type") != type(self).__name__:
            raise ValueError("optimizer state of %s, this is %s"
                             % (state.get("type"), type(self).__name__))
        self.count = int(state["count"])
        for key in self.state_keys:
            for buf, name in zip(self.state[key], self.names):
                buf.copy_(state[key][name])


class BertAdam(Optimizer):
    """Reference BertAdam: global clip -> m, v (no bias correction) ->
    update = m / (sqrt(v) + eps) + wd * p -> p -= lr * update."""

    state_keys = ("m", "v")

    def __init__(self, named_params, schedule_fn, b1=0.9, b2=0.999, eps=1e-6,
                 weight_decay=0.01, max_grad_norm=1.0):
        super().__init__(named_params, schedule_fn, weight_decay,
                         max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _update(self, grads, lr):
        if self.max_grad_norm > 0:
            norm = global_norm(grads)
            scale = torch.clamp(self.max_grad_norm / (norm + 1e-6), max=1.0)
            grads = torch._foreach_mul(grads, scale)
        m, v = self.state["m"], self.state["v"]
        torch._foreach_mul_(m, self.b1)
        torch._foreach_add_(m, grads, alpha=1 - self.b1)
        torch._foreach_mul_(v, self.b2)
        torch._foreach_addcmul_(v, grads, grads, value=1 - self.b2)
        denom = torch._foreach_sqrt(v)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(m, denom)
        self._add_decay(updates)
        torch._foreach_add_(self.params, updates, alpha=-lr)


class AdamW(Optimizer):
    """optax.chain(clip_by_global_norm, scale_by_adam,
    add_decayed_weights(mask), scale_by_learning_rate): decoupled decay
    with bias correction. weight_decay=0 is Adam."""

    state_keys = ("mu", "nu")

    def __init__(self, named_params, schedule_fn, b1=0.9, b2=0.999, eps=1e-8,
                 weight_decay=0.01, max_grad_norm=1.0):
        super().__init__(named_params, schedule_fn, weight_decay,
                         max_grad_norm)
        self.b1, self.b2, self.eps = b1, b2, eps

    def _update(self, grads, lr):
        grads = self._clip(grads)
        mu, nu = self.state["mu"], self.state["nu"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, grads, alpha=1 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.b2)
        t = self.count + 1
        denom = torch._foreach_div(nu, 1 - self.b2 ** t)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        updates = torch._foreach_div(mu, 1 - self.b1 ** t)
        torch._foreach_div_(updates, denom)
        self._add_decay(updates)
        torch._foreach_add_(self.params, updates, alpha=-lr)


class SGD(Optimizer):
    """optax.chain(clip_by_global_norm, sgd): p -= lr * g.

    Unlike the JAX package, the clip is left out when max_grad_norm is 0:
    there optax.clip_by_global_norm(0) scales every update to 0, so the JAX
    Trainer (which passes 0 and clips itself) never moves an SGD run's
    parameters (ROADMAP C8)."""

    def _update(self, grads, lr):
        torch._foreach_add_(self.params, self._clip(grads), alpha=-lr)


def get_optimizer(named_params, optimizer_type="AdamW", learning_rate=5e-5,
                  warmup_proportion=0.1, lr_scheduler="warmup_linear",
                  epoch_num=3.0, steps_per_epoch=100,
                  gradient_accumulation_steps=1, weight_decay=0.01,
                  max_grad_norm=1.0, b1=0.9, b2=0.999, eps=1e-8):
    """(optimizer over named_params, schedule_fn, t_total), with
    t_total = ceil(steps_per_epoch / grad_accum) * epochs."""
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
                       weight_decay=weight_decay, max_grad_norm=max_grad_norm)
    elif optimizer_type in ("AdamW", "Adam"):
        wd = weight_decay if optimizer_type == "AdamW" else 0.0
        opt = AdamW(named_params, schedule_fn, b1=b1, b2=b2, eps=eps,
                    weight_decay=wd, max_grad_norm=max_grad_norm)
    elif optimizer_type == "SGD":
        opt = SGD(named_params, schedule_fn, max_grad_norm=max_grad_norm)
    elif optimizer_type in ("Lion", "Adafactor"):
        raise NotImplementedError(
            "--optimizer_type=%s is not ported yet (ROADMAP A4b)"
            % optimizer_type)
    else:
        raise ValueError("unknown optimizer %r" % optimizer_type)
    return opt, schedule_fn, t_total
