"""The port's DPM-Solver++(2M) (videoswap_torch/schedulers/dpm.py) against
the JAX package: the step on seeded inputs (fp32, 1e-5 of the outputs'
scale) at the first, a middle and the last step of schedules shorter and
longer than 15 steps; the JAX package's own DPM cases restated on the
port (tests/test_schedulers.py: the float64 numpy restatement, an exact x0
prediction recovers x0, second order beats DDIM and converges faster than
first order on an analytic Gaussian ODE); and `sample` with the DPM++
sampler and with `guidance_rescale` against the JAX package's at a tiny
config (fp32 on the CPU, 1e-4 of the latents' scale)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_schedulers import _dpm_numpy_restatement
from test_torch_pipeline import (_few_torch_threads, _kwargs,  # noqa: F401
                                 pipes)
from videoswap_tpu.schedulers import dpm as jdpm
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_torch.schedulers import (add_noise, ddim_step, ddim_timesteps,
                                        dpm_pp_2m_step, dpm_timesteps,
                                        make_schedule)


@pytest.fixture(scope='module')
def sched():
    return make_schedule()


def _chain(sched, x, steps, eps_for):
    """The port's host loop over dpm_pp_2m_step; eps_for(x, t, i)."""
    prev = torch.zeros_like(x)
    for i, t in enumerate(dpm_timesteps(1000, steps)):
        x, prev = dpm_pp_2m_step(sched, eps_for(x, int(t), i), int(t), x,
                                 prev, i, steps)
    return x


@pytest.mark.parametrize('n, i', [(8, 0), (8, 3), (8, 7), (20, 0), (20, 9),
                                  (20, 19)])
def test_step_matches_jax(sched, n, i):
    rs = np.random.RandomState(n * 100 + i)
    x, eps, prev = (rs.randn(1, 2, 8, 8, 4).astype(np.float32)
                    for _ in range(3))
    t = int(dpm_timesteps(1000, n)[i])
    jsched = j_make_schedule()
    ref = jdpm.dpm_pp_2m_step(jsched, jnp.asarray(eps), jnp.array(t),
                              jnp.asarray(x), jnp.asarray(prev), jnp.array(i),
                              n)
    out = dpm_pp_2m_step(sched, torch.from_numpy(eps), t,
                         torch.from_numpy(x), torch.from_numpy(prev), i, n)
    for o, r in zip(out, ref):
        r = np.asarray(r)
        assert o.dtype == torch.float32
        assert float(np.abs(o.numpy() - r).max()) <= 1e-5 * max(
            1.0, float(np.abs(r).max()))


def test_step_keeps_the_sample_dtype(sched):
    x = torch.randn(1, 2, 4, 4, 4).bfloat16()
    new, x0 = dpm_pp_2m_step(sched, x, 501, x, torch.zeros_like(x), 1, 20)
    assert new.dtype == x0.dtype == torch.bfloat16


@pytest.mark.parametrize('steps', [8, 20])
def test_matches_numpy_restatement(sched, steps):
    rs = np.random.RandomState(0)
    x = rs.randn(2, 3, 4).astype(np.float32)
    eps_seq = rs.randn(steps, *x.shape).astype(np.float32) * 0.3
    out = _chain(sched, torch.from_numpy(x), steps,
                 lambda _x, _t, i: torch.from_numpy(eps_seq[i]))
    ref = _dpm_numpy_restatement(sched.alphas_cumprod.double().numpy(),
                                 sched.final_alpha_cumprod, steps, eps_seq,
                                 x.astype(np.float64))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-4)


def test_exact_x0_prediction_recovers_x0(sched):
    gen = torch.Generator().manual_seed(5)
    x0 = torch.randn((1, 2, 4, 4, 4), generator=gen)
    noise = torch.randn(x0.shape, generator=gen)
    steps = 10
    x = add_noise(sched, x0, noise, torch.tensor([int(
        dpm_timesteps(1000, steps)[0])]))

    def eps_for(x, t, i):
        a = sched.alphas_cumprod[t]
        return (x - torch.sqrt(a) * x0) / torch.sqrt(1 - a)

    out = _chain(sched, x, steps, eps_for)
    np.testing.assert_allclose(out.numpy(), x0.numpy(), atol=2e-3)


def _gaussian_eps(sched, v):
    """The exact eps of Gaussian data x0 ~ N(0, v): linear in x."""
    def eps(x, t):
        a = sched.alphas_cumprod.double()[t]
        x0_hat = torch.sqrt(a) * v * x / (a * v + 1 - a)
        return (x - torch.sqrt(a) * x0_hat) / torch.sqrt(1 - a)
    return eps


def _gaussian_error(sched, steps, kind, v=9.0):
    """The solver's distance from the exact solution of the linear
    probability-flow ODE, x sqrt(sig2(0) / sig2(T)) with sig2 = a v + 1 - a,
    in float64."""
    eps = _gaussian_eps(sched, v)
    ts = ddim_timesteps(1000, steps)
    a_t = float(sched.alphas_cumprod[int(ts[0])])
    x = torch.from_numpy(np.random.RandomState(2).randn(256))
    x_true = x.numpy() * np.sqrt(v / (a_t * v + (1.0 - a_t)))
    if kind == 'ddim':
        for t in ts:
            x = ddim_step(sched, eps(x, int(t)), int(t), x, steps).double()
    else:
        x = _chain(sched, x, steps, lambda x, t, i: eps(x, t))
    return float(np.linalg.norm(x.numpy() - x_true))


def test_second_order_beats_ddim_on_an_analytic_gaussian(sched):
    assert _gaussian_error(sched, 20, 'dpm') \
        < 0.7 * _gaussian_error(sched, 20, 'ddim')


def test_order_of_convergence(sched):
    """Halving the step: DDIM's error ratio near 2 (first order), DPM++'s
    above 2.45 (the JAX package's limits, tests/test_schedulers.py), and
    DPM++ at least 1.8x more accurate at equal budget."""
    e = {(k, n): _gaussian_error(sched, n, k) for k in ('ddim', 'dpm')
         for n in (20, 32, 40, 64, 80)}
    for a, b in ((20, 40), (32, 64)):
        assert 1.7 < e[('ddim', a)] / e[('ddim', b)] < 2.4
        assert e[('dpm', a)] / e[('dpm', b)] > 2.45
    for n in (20, 40, 80):
        assert e[('dpm', n)] < 0.55 * e[('ddim', n)], n


def _lat():
    from test_torch_pipeline import F, SIZE
    return np.random.RandomState(3).randn(1, F, SIZE // 8, SIZE // 8,
                                          4).astype(np.float32)


@pytest.mark.parametrize('kw', [
    dict(sampler='dpmpp_2m', num_inference_steps=5),
    dict(guidance_rescale=0.7),
], ids=['dpmpp_2m', 'guidance_rescale'])
def test_sample_matches_jax(pipes, kw):  # noqa: F811
    jpipe, tpipe = pipes
    lat0 = _lat()
    args = dict(_kwargs(), **kw)
    ref = np.asarray(jpipe.sample(latents=jnp.asarray(lat0), loop='python',
                                  output_type='latent', **args))
    out = tpipe.sample(latents=torch.from_numpy(lat0), output_type='latent',
                       **args).numpy()
    scale = max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(out - ref).max()) <= 1e-4 * scale
    # the option changes the result
    base = tpipe.sample(latents=torch.from_numpy(lat0), output_type='latent',
                        **dict(_kwargs(), num_inference_steps=args[
                            'num_inference_steps'])).numpy()
    assert float(np.abs(out - base).max()) > 1e-3
