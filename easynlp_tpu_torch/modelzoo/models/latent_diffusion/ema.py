"""Exponential moving average of model parameters.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/ema.py
(`ema_init`, `ema_update`, `ema_params`): an f32 shadow of each parameter
and an update count, both on the parameters' device. Each update blends
the shadow towards the parameters at the warm-up-corrected decay
min(decay, (1 + n) / (10 + n)), n the count after this update, computed on
the device: an update launches a few `_foreach` kernels and reads nothing
back to the host.
"""

import torch


def ema_init(params):
    """{'shadow': f32 copies of `params`, 'num_updates': a 0-d int32
    device tensor at 0}."""
    params = list(params)
    device = params[0].device if params else None
    return {"shadow": [p.detach().to(torch.float32, copy=True)
                       for p in params],
            "num_updates": torch.zeros((), dtype=torch.int32,
                                       device=device)}


@torch.no_grad()
def ema_update(state, params, decay=0.9999, use_num_updates=True):
    """One EMA step in place: shadow -= (1 - eff) * (shadow - params)."""
    state["num_updates"] += 1
    shadow = state["shadow"]
    if use_num_updates:
        n = state["num_updates"].to(torch.float32)
        eff = torch.clamp((1.0 + n) / (10.0 + n), max=float(decay))
    else:
        eff = torch.tensor(float(decay), device=state["num_updates"].device)
    diff = torch._foreach_sub(shadow, [p.detach().to(torch.float32)
                                       for p in params])
    torch._foreach_mul_(diff, 1.0 - eff)
    torch._foreach_sub_(shadow, diff)
    return state


def ema_params(state, like=None):
    """The averaged weights, each cast to the dtype of its counterpart in
    `like` where given."""
    if like is None:
        return state["shadow"]
    return [s.to(p.dtype) for s, p in zip(state["shadow"], like)]
