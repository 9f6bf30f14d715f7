"""OLSS, the Optimal Linear Subspace Search scheduler, for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/olss.py: a
DDIM teacher's trajectory (x_i, eps_i) is recorded, N timesteps are picked
greedily under a bisected error limit, and each student state is fitted by
least squares as x_{i+1} = wx[i] x_T + sum_j we[i, j] eps_j. The teacher
runs on the device (`ddim_collect_path`, one model call a step); the
solver is the JAX package's host numpy in float64, copied here; the
student (`olss_sample`) is a Python loop over its N steps.
"""

import numpy as np
import torch

from easynlp_tpu_torch.modelzoo.models.latent_diffusion.ddim import (
    _a_prev,
    _timesteps,
    draw_normal,
    sample_steps,
)


# ------------------------------------------------------------------ teacher
def ddim_collect_path(denoise_fn, shape, schedule, num_steps=100,
                      generator=None, x_init=None, device="cpu"):
    """The deterministic DDIM teacher's trajectory: (t_path [T] int32
    descending, x_path [T + 1, B, ...], e_path [T, B, ...]) as f32 numpy."""
    device = x_init.device if x_init is not None else torch.device(device)
    steps = sample_steps(schedule.num_timesteps, num_steps)
    x = x_init if x_init is not None else draw_normal(shape, generator,
                                                      device)
    acp = schedule.tables(device)[0]
    xs, es = [], []
    for i in range(num_steps):
        t = int(steps[i])
        t_prev = int(steps[i + 1]) if i + 1 < num_steps else -1
        a_t = acp[t]
        a_prev = _a_prev(acp, t_prev, device)
        eps = denoise_fn(x, _timesteps(t, shape[0], device))
        xs.append(x)
        es.append(eps)
        pred_x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        x = torch.sqrt(a_prev) * pred_x0 + torch.sqrt(1 - a_prev) * eps
    x_path = torch.stack(xs + [x]).float().cpu().numpy()
    e_path = torch.stack(es).float().cpu().numpy()
    return steps.astype(np.int32), x_path, e_path


# ------------------------------------------------------------------- solver
def _solve_step(xT_flat, e_prev_flat, x_goal_flat):
    """lstsq fit of x_goal over [xT, eps_0..eps_k], float64."""
    X = np.concatenate([xT_flat, e_prev_flat], axis=0).astype(np.float64).T
    y = x_goal_flat.astype(np.float64)
    coef, *_ = np.linalg.lstsq(X, y, rcond=None)
    err = float(np.mean((X @ coef - y) ** 2))
    return coef[0], coef[1:], err


def resolve_diffusion_process(steps_accelerate, t_path, x_path, e_path,
                              i_path=None):
    """(timesteps, wx, we) fitted on a chosen sub-path (every
    len/steps_accelerate-th step where i_path is None)."""
    steps_inference = t_path.shape[0]
    if i_path is None:
        i_path = np.arange(0, steps_inference,
                           steps_inference // steps_accelerate
                           )[:steps_accelerate]
    i_path = np.asarray(i_path)
    t_sub = t_path[i_path]
    x_flat = x_path.reshape(x_path.shape[0], -1)
    e_flat = e_path.reshape(e_path.shape[0], -1)
    x_sub = np.concatenate([x_flat[i_path], x_flat[-1:]], axis=0)
    e_sub = e_flat[i_path]
    n = len(i_path)
    wx = np.zeros(n, np.float64)
    we = np.zeros((n, n), np.float64)
    for i in range(n):
        wx[i], we[i, :i + 1], _ = _solve_step(
            x_sub[0:1], e_sub[:i + 1], x_sub[i + 1])
    return t_sub, wx, we


def _search_next_step(x_prev, e_prev, x_flat, i_lower, max_error):
    """The farthest trajectory index reachable under max_error
    (bisection)."""
    i_upper = len(x_flat) - 1
    while i_upper > i_lower:
        i_mid = (i_lower + i_upper + 1) // 2
        _, _, err = _solve_step(x_prev, e_prev, x_flat[i_mid])
        if err > max_error:
            i_upper = i_mid - 1
        else:
            i_lower = i_mid
    return i_lower


def _search_path(max_steps, x_flat, e_flat, max_error):
    """The greedy max-error-bounded path, or None past max_steps."""
    n = e_flat.shape[0]
    i_path = [0]
    for step in range(max_steps):
        x_prev = x_flat[i_path[step:step + 1]]
        e_prev = e_flat[i_path]
        i_next = _search_next_step(x_prev, e_prev, x_flat,
                                   i_path[step] + 1, max_error)
        if i_next == n:
            return i_path
        i_path.append(i_next)
    return None


def fit_olss(t_path, x_path, e_path, num_accelerate_steps, max_iter=30):
    """Bisect the error limit until the greedy path fits in N steps, then
    fit the weights: (timesteps [N] int32, wx [N], we [N, N])."""
    x_flat = x_path.reshape(x_path.shape[0], -1)
    e_flat = e_path.reshape(e_path.shape[0], -1)
    err_l, err_r = 0.0, 10.0
    for _ in range(max_iter):
        err_m = (err_l + err_r) / 2
        path = _search_path(num_accelerate_steps, x_flat, e_flat, err_m)
        if path is None:
            err_l = err_m
        else:
            err_r = err_m
    path = _search_path(num_accelerate_steps, x_flat, e_flat, err_r)
    return resolve_diffusion_process(num_accelerate_steps, t_path, x_path,
                                     e_path, i_path=path)


# ------------------------------------------------------------------ student
def olss_sample(denoise_fn, xT, timesteps, wx, we):
    """The learned N-step sampler: x = wx[i] x_T + sum_j<=i we[i, j] eps_j
    with the weights as f32."""
    timesteps = [int(t) for t in np.asarray(timesteps)]
    wx = torch.tensor(np.asarray(wx), dtype=torch.float32, device=xT.device)
    we = torch.tensor(np.asarray(we), dtype=torch.float32, device=xT.device)
    x = xT
    eps_hist = []
    for i, t in enumerate(timesteps):
        eps_hist.append(denoise_fn(x, _timesteps(t, xT.shape[0], xT.device)))
        x = wx[i] * xT
        for j in range(i + 1):
            x = x + we[i, j] * eps_hist[j]
        x = x.to(xT.dtype)
    return x


def save_olss(path, timesteps, wx, we):
    np.savez(path, timesteps=np.asarray(timesteps, np.int32),
             wx=np.asarray(wx), we=np.asarray(we))


def load_olss(path):
    d = np.load(path)
    return d["timesteps"], d["wx"], d["we"]
