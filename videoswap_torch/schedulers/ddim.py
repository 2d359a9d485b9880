"""DDIM noise schedule, steps and the training-time forward diffusion as
plain tensor functions, in fp32.

Semantics of videoswap_tpu/schedulers/ddim.py (diffusers 0.19.3
`DDIMScheduler` / `DDIMInverseScheduler` as the reference configures them):
linear betas 0.00085 -> 0.012 over 1000 steps, epsilon (or v) prediction,
`steps_offset=1`, `set_alpha_to_one=True`, eta = 0. A timestep broadcasts
against (B, F, H, W, C) latents; the functions compute in fp32 and return
fp32 (callers cast back to the latents' dtype).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class DiffusionSchedule(NamedTuple):
    alphas_cumprod: torch.Tensor      # [num_train_timesteps] float32 (CPU)
    final_alpha_cumprod: float        # alpha used "past the end"
    num_train_timesteps: int
    init_noise_sigma: float
    prediction_type: str = 'epsilon'  # 'epsilon' | 'v_prediction'


def make_schedule(
    num_train_timesteps: int = 1000,
    beta_start: float = 0.00085,
    beta_end: float = 0.012,
    set_alpha_to_one: bool = True,
    prediction_type: str = 'epsilon',
) -> DiffusionSchedule:
    if prediction_type not in ('epsilon', 'v_prediction'):
        raise ValueError(f'unknown prediction_type: {prediction_type}')
    betas = np.linspace(beta_start, beta_end, num_train_timesteps,
                        dtype=np.float64)
    alphas_cumprod = np.cumprod(1.0 - betas)
    final = 1.0 if set_alpha_to_one else float(alphas_cumprod[0])
    return DiffusionSchedule(
        alphas_cumprod=torch.tensor(alphas_cumprod, dtype=torch.float32),
        final_alpha_cumprod=float(np.float32(final)),
        num_train_timesteps=num_train_timesteps,
        init_noise_sigma=1.0,
        prediction_type=prediction_type,
    )


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   steps_offset: int = 1) -> np.ndarray:
    """Descending sampling timesteps, e.g. [981, 961, ..., 1] for 50."""
    ratio = num_train_timesteps // num_inference_steps
    ts = (np.arange(0, num_inference_steps) * ratio).round()[::-1]
    return (ts + steps_offset).astype(np.int64)


def ddim_inverse_timesteps(num_train_timesteps: int,
                           num_inference_steps: int) -> np.ndarray:
    """Ascending inversion timesteps, e.g. [0, 20, ..., 980] for 50."""
    ratio = num_train_timesteps // num_inference_steps
    return (np.arange(0, num_inference_steps) * ratio).round().astype(np.int64)


def _gather_alpha(sched: DiffusionSchedule, t, sample: torch.Tensor):
    """alphas_cumprod[t] (final alpha for t < 0), shaped to broadcast."""
    t = torch.as_tensor(t, dtype=torch.long).reshape(-1).cpu()
    a = sched.alphas_cumprod[t.clamp(0, sched.num_train_timesteps - 1)]
    a = torch.where(t < 0, torch.tensor(sched.final_alpha_cumprod), a)
    a = a.to(sample.device)
    return a.reshape(a.shape + (1,) * (sample.dim() - 1)) if a.numel() > 1 \
        else a.reshape(())


def pred_x0_from_eps(sample, eps, alpha_t):
    return (sample - torch.sqrt(1.0 - alpha_t) * eps) / torch.sqrt(alpha_t)


def _to_eps_and_x0(sched: DiffusionSchedule, model_output, sample, alpha_t):
    """The network output as (epsilon, x0), per the schedule's
    prediction_type."""
    if sched.prediction_type == 'epsilon':
        return model_output, pred_x0_from_eps(sample, model_output, alpha_t)
    sqrt_a, sqrt_1ma = torch.sqrt(alpha_t), torch.sqrt(1.0 - alpha_t)
    return (sqrt_a * model_output + sqrt_1ma * sample,
            sqrt_a * sample - sqrt_1ma * model_output)


def ddim_step(sched: DiffusionSchedule, model_output, t, sample,
              num_inference_steps: int):
    """One deterministic DDIM denoising step: x_t -> x_{t - delta}."""
    delta = sched.num_train_timesteps // num_inference_steps
    t = torch.as_tensor(t)
    out, sample = model_output.float(), sample.float()
    alpha_t = _gather_alpha(sched, t, sample)
    alpha_prev = _gather_alpha(sched, t - delta, sample)
    eps, x0 = _to_eps_and_x0(sched, out, sample, alpha_t)
    return torch.sqrt(alpha_prev) * x0 + torch.sqrt(1.0 - alpha_prev) * eps


def ddim_inverse_step(sched: DiffusionSchedule, model_output, t, sample,
                      num_inference_steps: int):
    """One DDIM inversion step: x_{t - delta} -> x_t."""
    delta = sched.num_train_timesteps // num_inference_steps
    t = torch.as_tensor(t)
    out, sample = model_output.float(), sample.float()
    alpha_src = _gather_alpha(sched, t - delta, sample)
    alpha_dst = _gather_alpha(sched, t, sample)
    eps, x0 = _to_eps_and_x0(sched, out, sample, alpha_src)
    return torch.sqrt(alpha_dst) * x0 + torch.sqrt(1.0 - alpha_dst) * eps


def add_noise(sched: DiffusionSchedule, original, noise, t):
    """Forward diffusion q(x_t | x_0) (DDPM add_noise), per-sample t."""
    original, noise = original.float(), noise.float()
    alpha_t = _gather_alpha(sched, t, original)
    return torch.sqrt(alpha_t) * original + torch.sqrt(1.0 - alpha_t) * noise


def get_velocity(sched: DiffusionSchedule, original, noise, t):
    """v-prediction target: v = sqrt(a) * eps - sqrt(1 - a) * x0."""
    original, noise = original.float(), noise.float()
    alpha_t = _gather_alpha(sched, t, original)
    return torch.sqrt(alpha_t) * noise - torch.sqrt(1.0 - alpha_t) * original
