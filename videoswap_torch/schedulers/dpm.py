"""DPM-Solver++(2M), the second-order multistep sampler (the port of
videoswap_tpu/schedulers/dpm.py; Lu et al., arXiv:2211.01095, Algorithm 2).

It solves the probability-flow ODE in data-prediction (x0) space on the
same descending grid as DDIM, so every step-indexed behaviour (the adapter
window, the prompt-to-prompt schedules, the latent blend) stays aligned;
the only extra loop state is the previous step's x0 prediction.

With alpha_t = sqrt(alphas_cumprod[t]), sigma_t = sqrt(1 - alphas_cumprod[t])
(floored at 1e-4, so that the last step's lambda stays finite) and
lambda_t = log(alpha_t / sigma_t), one step from s to t with
h = lambda_t - lambda_s, h_prev = lambda_s - lambda_r and r_h = h_prev / h:

    D   = (1 + 1/(2 r_h)) x0_s - 1/(2 r_h) x0_r
    x_t = (sigma_t / sigma_s) x_s - alpha_t (e^{-h} - 1) D

The first step, and the last when there are fewer than 15, take D = x0_s
(first order: DDIM written in x0 space). Computed in fp32, returned in the
sample's dtype.
"""

from __future__ import annotations

import torch

from .ddim import DiffusionSchedule, _gather_alpha, _to_eps_and_x0, \
    ddim_timesteps

_SIGMA_FLOOR = 1e-4


def dpm_timesteps(num_train_timesteps: int, num_inference_steps: int,
                  steps_offset: int = 1):
    """The same descending grid as DDIM."""
    return ddim_timesteps(num_train_timesteps, num_inference_steps,
                          steps_offset)


def _alpha_sigma_lambda(a_cumprod):
    alpha = torch.sqrt(a_cumprod)
    sigma = torch.sqrt(1.0 - a_cumprod).clamp_min(_SIGMA_FLOOR)
    return alpha, sigma, torch.log(alpha / sigma)


def dpm_pp_2m_step(sched: DiffusionSchedule, model_output, t, sample,
                   prev_x0, step_index: int, num_inference_steps: int):
    """One DPM-Solver++(2M) step: (x_s, x0 of the previous step) ->
    (x_t, x0_s). `t` is the grid label (from `dpm_timesteps`),
    `step_index` its 0-based position; `prev_x0` is ignored at step 0
    (pass zeros). x0_s is the next step's `prev_x0`."""
    n = num_inference_steps
    delta = sched.num_train_timesteps // n
    t = int(t)
    out, x = model_output.float(), sample.float()
    a_cur = _gather_alpha(sched, t, x)
    a_next = _gather_alpha(sched, t - delta, x)       # the target: less noise
    a_prev = _gather_alpha(sched, t + delta, x)       # the previous step's t
    _, x0 = _to_eps_and_x0(sched, out, x, a_cur)

    _, sg_cur, lam_cur = _alpha_sigma_lambda(a_cur)
    al_next, sg_next, lam_next = _alpha_sigma_lambda(a_next)
    _, _, lam_prev = _alpha_sigma_lambda(a_prev)
    h = lam_next - lam_cur
    first_order = step_index == 0 or (n < 15 and step_index == n - 1)
    if first_order:
        d = x0
    else:
        r_h = (lam_cur - lam_prev) / h
        d = (1.0 + 1.0 / (2.0 * r_h)) * x0 \
            - (1.0 / (2.0 * r_h)) * prev_x0.float()
    new = (sg_next / sg_cur) * x - al_next * torch.expm1(-h) * d
    return new.to(sample.dtype), x0.to(sample.dtype)
