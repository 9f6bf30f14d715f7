"""Diffusion schedule and samplers for the PyTorch port.

Counterpart of easynlp_tpu/modelzoo/models/latent_diffusion/ddim.py:
Stable Diffusion's scaled-linear betas, q_sample, and the DDIM, PLMS,
DPM-Solver++(2M) and img2img samplers. The schedule is built on the host
exactly as JAX builds it (an f64 linspace, then f32 alphas_cumprod), and
every per-step coefficient is an f32 0-d tensor on the latents' device, so
the samplers do the JAX samplers' f32 arithmetic. Each sampler is a Python
loop over its steps (one or two `denoise_fn` calls a step, no read-back to
the host); `denoise_fn(x, t)` takes latents and a [B] int64 timestep tensor
and returns the predicted noise (classifier-free guidance, when wanted,
inside it).

Randomness comes from an explicit torch.Generator. Draws are made where
the generator lives (a CPU generator gives the same latents to a run on
the CPU and on a card) and moved to the latents' device. `x_init` (and
img2img's `noise`) take given draws instead, so a test can feed the JAX
sampler's. DDIM at eta 0 draws nothing: JAX draws a noise each step and
multiplies it by sigma = 0.
"""

import numpy as np
import torch


def linear_beta_schedule(num_timesteps=1000, beta_start=0.00085,
                         beta_end=0.012):
    """SD's scaled-linear schedule, f64."""
    return np.linspace(beta_start ** 0.5, beta_end ** 0.5, num_timesteps,
                       dtype=np.float64) ** 2


def sample_steps(num_timesteps, num_steps):
    """The sampled timesteps, descending (int64 numpy)."""
    return np.linspace(0, num_timesteps - 1, num_steps,
                       dtype=np.int64)[::-1].copy()


def draw_normal(shape, generator, device):
    """f32 standard normals drawn on the generator's device, then moved to
    `device`."""
    gen_device = generator.device if generator is not None else "cpu"
    return torch.randn(tuple(shape), generator=generator,
                       dtype=torch.float32, device=gen_device).to(device)


class DiffusionSchedule:
    def __init__(self, num_timesteps=1000, beta_start=0.00085,
                 beta_end=0.012):
        self.num_timesteps = num_timesteps
        betas = linear_beta_schedule(num_timesteps, beta_start, beta_end)
        self.alphas_cumprod_np = np.cumprod(1.0 - betas).astype(np.float32)
        self._by_device = {}

    def tables(self, device):
        """(alphas_cumprod, its sqrt, sqrt(1 - it)), f32 on `device`."""
        key = str(torch.device(device))
        if key not in self._by_device:
            acp = torch.from_numpy(self.alphas_cumprod_np).to(device)
            self._by_device[key] = (acp, torch.sqrt(acp),
                                    torch.sqrt(1.0 - acp))
        return self._by_device[key]

    @property
    def alphas_cumprod(self):
        return self.tables("cpu")[0]

    def q_sample(self, x0, t, noise):
        """Forward noising: sqrt(acp[t]) x0 + sqrt(1 - acp[t]) noise."""
        _, sqrt_acp, sqrt_one_minus = self.tables(x0.device)
        t = t.to(x0.device).long()
        a = sqrt_acp[t].view(-1, *([1] * (x0.dim() - 1)))
        s = sqrt_one_minus[t].view(-1, *([1] * (x0.dim() - 1)))
        return a * x0 + s * noise


def _timesteps(t, batch, device):
    return torch.full((batch,), int(t), dtype=torch.int64, device=device)


def _a_prev(acp, t_prev, device):
    return acp[t_prev] if t_prev >= 0 else torch.ones((), device=device)


def _ddim_step(acp, x, eps, t, t_prev):
    """The deterministic DDIM update from t to t_prev (-1: the clean
    sample)."""
    a_t = acp[t]
    a_prev = _a_prev(acp, t_prev, x.device)
    x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
    return torch.sqrt(a_prev) * x0 + torch.sqrt(1 - a_prev) * eps


def ddim_sample(denoise_fn, shape, schedule, num_steps=50, eta=0.0,
                generator=None, x_init=None, device="cpu"):
    """DDIM from x_T (x_init, or drawn from `generator`) to x_0, [B, C, h, w]
    on `device` (x_init's device when given)."""
    device = x_init.device if x_init is not None else torch.device(device)
    steps = sample_steps(schedule.num_timesteps, num_steps)
    x = x_init if x_init is not None else draw_normal(shape, generator,
                                                      device)
    acp = schedule.tables(device)[0]
    for i in range(num_steps):
        t = int(steps[i])
        t_prev = int(steps[i + 1]) if i + 1 < num_steps else -1
        a_t = acp[t]
        a_prev = _a_prev(acp, t_prev, device)
        eps = denoise_fn(x, _timesteps(t, shape[0], device))
        x0 = (x - torch.sqrt(1 - a_t) * eps) / torch.sqrt(a_t)
        sigma = eta * torch.sqrt((1 - a_prev) / (1 - a_t)
                                 * (1 - a_t / a_prev))
        dir_xt = torch.sqrt(torch.clamp(1 - a_prev - sigma ** 2,
                                        min=0.0)) * eps
        x = torch.sqrt(a_prev) * x0 + dir_xt
        if eta > 0:
            x = x + sigma * draw_normal(shape, generator, device)
    return x


def plms_sample(denoise_fn, shape, schedule, num_steps=50, generator=None,
                x_init=None, device="cpu"):
    """PLMS: a first improved-Euler step (two model calls averaged), then
    Adams-Bashforth extrapolation over the last (up to) four eps."""
    device = x_init.device if x_init is not None else torch.device(device)
    steps = sample_steps(schedule.num_timesteps, num_steps)
    x = x_init if x_init is not None else draw_normal(shape, generator,
                                                      device)
    acp = schedule.tables(device)[0]
    t0 = int(steps[0])
    eps0 = denoise_fn(x, _timesteps(t0, shape[0], device))
    if num_steps > 1:
        t1 = int(steps[1])
        x_pred = _ddim_step(acp, x, eps0, t0, t1)
        eps1 = denoise_fn(x_pred, _timesteps(t1, shape[0], device))
        x = _ddim_step(acp, x, (eps0 + eps1) / 2.0, t0, t1)
    else:
        x = _ddim_step(acp, x, eps0, t0, -1)
    hist = [eps0]
    for i in range(1, num_steps):
        t = int(steps[i])
        t_prev = int(steps[i + 1]) if i + 1 < num_steps else -1
        eps = denoise_fn(x, _timesteps(t, shape[0], device))
        if len(hist) == 1:
            eps_prime = (3 * eps - hist[0]) / 2
        elif len(hist) == 2:
            eps_prime = (23 * eps - 16 * hist[0] + 5 * hist[1]) / 12
        else:
            eps_prime = (55 * eps - 59 * hist[0] + 37 * hist[1]
                         - 9 * hist[2]) / 24
        x = _ddim_step(acp, x, eps_prime, t, t_prev)
        hist = [eps] + hist[:2]
    return x


def dpm_solver_pp_sample(denoise_fn, shape, schedule, num_steps=20,
                         generator=None, x_init=None, device="cpu"):
    """DPM-Solver++(2M) in data-prediction form: second-order multistep
    extrapolation of x0, the last update to a clean sample."""
    device = x_init.device if x_init is not None else torch.device(device)
    x = x_init if x_init is not None else draw_normal(shape, generator,
                                                      device)
    steps = sample_steps(schedule.num_timesteps, num_steps)
    acp = schedule.alphas_cumprod_np[steps]
    # as JAX builds them: f64 square roots of the f32 table, then f32
    alpha = torch.tensor(np.sqrt(np.concatenate([acp, [1.0]])),
                         dtype=torch.float32, device=device)
    sigma = torch.tensor(np.sqrt(np.concatenate([1.0 - acp, [1e-8]])),
                         dtype=torch.float32, device=device)
    lam = torch.log(alpha) - torch.log(sigma)
    x0_prev = None
    for i in range(num_steps):
        eps = denoise_fn(x, _timesteps(steps[i], shape[0], device))
        x0 = (x - sigma[i] * eps) / alpha[i]
        h = lam[i + 1] - lam[i]
        if i == 0:
            d = x0
        else:
            r = (lam[i] - lam[i - 1]) / h
            d = (1.0 + 1.0 / (2.0 * r)) * x0 - (1.0 / (2.0 * r)) * x0_prev
        x = (sigma[i + 1] / sigma[i]) * x - alpha[i + 1] * torch.expm1(-h) * d
        x0_prev = x0
    return x


def ddim_img2img(denoise_fn, latents0, schedule, strength=0.7, num_steps=50,
                 generator=None, noise=None):
    """img2img: q_sample the latents to the step `strength` of the way
    along the schedule, then DDIM back (strength 1 is full generation, 0
    returns the input). `noise` takes a given draw."""
    if strength <= 0.0:
        return latents0
    full = sample_steps(schedule.num_timesteps, num_steps)
    n_keep = max(1, int(round(strength * num_steps)))
    steps = full[num_steps - n_keep:]
    device = latents0.device
    b = latents0.shape[0]
    if noise is None:
        noise = draw_normal(latents0.shape, generator, device)
    x = schedule.q_sample(latents0, _timesteps(full[num_steps - n_keep], b,
                                               device), noise)
    acp = schedule.tables(device)[0]
    for i in range(n_keep):
        t = int(steps[i])
        t_prev = int(steps[i + 1]) if i + 1 < n_keep else -1
        eps = denoise_fn(x, _timesteps(t, b, device))
        x = _ddim_step(acp, x, eps, t, t_prev)
    return x
