"""Gradients of the port's kernel wrappers (videoswap_torch/ops) against the
JAX package: the flash-attention backward against the Pallas backward
kernels in interpret mode, GEGLU FFN and temporal attention against
`jax.grad` through the JAX package's custom VJPs.

On the CPU each wrapper runs as its autograd Function with the plain
forward and the plain backward (`flash_attention_bwd_plain`,
`geglu_ffn_bwd_plain`, `temporal_attention_bwd_plain`); the CUDA backward
kernels are held against the plain backward on the card by
tests/test_torch_cuda_kernels.py. Same numpy inputs on both sides, fp32.
"""

from unittest import mock

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import videoswap_tpu.ops.flash_attention as jfa
from videoswap_tpu.ops import geglu_ffn as jgf
from videoswap_tpu.ops import temporal_attention as jta
from videoswap_torch.ops import flash_attention as tfa
from videoswap_torch.ops import geglu_ffn as tgf
from videoswap_torch.ops import temporal_attention as tta

torch.backends.cuda.matmul.allow_tf32 = False


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    # the suite runs several pytest workers on one host, and JAX's CPU
    # backend has a pool of its own: a small torch pool keeps the workers
    # from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, grad=False):
    return torch.from_numpy(np.asarray(a, dtype=np.float32)).requires_grad_(
        grad)


def _rel_max_err(out, ref):
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    return float(np.abs(out - ref).max() / np.abs(ref).max())


# fp32 on both sides with sums in another order: the gradients agree to a
# few fp32 ulps of their largest entry times the reduction length
GRAD_TOL = 1e-4


@pytest.mark.parametrize('sk', [256, 77])
def test_flash_backward_matches_pallas_interpret(sk):
    """The port's FlashAttention backward (flash_attention_bwd_plain on the
    CPU) against `_bwd_dq_kernel` and `_bwd_dkv_kernel` run in interpret
    mode, at sq = 256, d = 40, self (sk = 256) and cross (sk = 77)."""
    rs = np.random.RandomState(sk)
    sq, h, d = 256, 2, 40
    q = rs.randn(1, sq, h, d).astype(np.float32)
    k, v = (rs.randn(1, sk, h, d).astype(np.float32) for _ in range(2))
    ct = rs.randn(1, sq, h, d).astype(np.float32)

    orig, calls = pl.pallas_call, []

    def interp(*a, **kw):
        calls.append(1)
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        return orig(*a, **kw)

    def loss(q, k, v):
        return (jfa.flash_attention(q, k, v, 128, 128) * ct).sum()

    with jax.disable_jit(), \
            mock.patch.object(jfa.pl, 'pallas_call', interp), \
            mock.patch.object(jfa.jax, 'default_backend', lambda: 'tpu'):
        ref = jax.grad(loss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    assert len(calls) >= 3, 'the forward and both backward kernels must run'

    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(ct))
    for g, r, name in zip(grads, ref, 'qkv'):
        assert _rel_max_err(g, r) <= GRAD_TOL, f'd{name}'


def test_flash_backward_plain_chunks_agree():
    rs = np.random.RandomState(3)
    q, k, v, g = (_t(rs.randn(5, 33, 2, 16)) for _ in range(4))
    out, lse = tfa.flash_attention_plain(q, k, v)
    full = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g)
    chunked = tfa.flash_attention_bwd_plain(q, k, v, out, lse, g,
                                            batch_chunk=2)
    for a, b in zip(full, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


@pytest.mark.parametrize('n,c', [(130, 64), (77, 40)])
def test_geglu_grad_matches_jax(n, c):
    """All five gradients, and dX alone with frozen weights, against the
    JAX package's custom VJP (an XLA recompute through `_xla_reference`).
    x spans |x / sqrt(2)| > 3, where gelu_fast's erf polynomial is
    clamped."""
    rs = np.random.RandomState(n)
    args = [rs.randn(n, c).astype(np.float32) * 2.0,
            rs.randn(c, 8 * c).astype(np.float32) * c ** -0.5 * 3.0,
            rs.randn(8 * c).astype(np.float32) * 0.5,
            rs.randn(4 * c, c).astype(np.float32) * (4 * c) ** -0.5,
            rs.randn(c).astype(np.float32) * 0.1]
    ct = rs.randn(n, c).astype(np.float32)
    ref = jax.grad(lambda *a: (jgf.geglu_ffn(*a) * ct).sum(),
                   argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, args))
    # JAX Dense layout (I, O) -> torch Linear layout (O, I)
    x, w1, b1, w2, b2 = (_t(a, grad=True) for a in
                         (args[0], args[1].T, args[2], args[3].T, args[4]))
    out = tgf.geglu_ffn(x, w1, b1, w2, b2)
    grads = torch.autograd.grad(out, (x, w1, b1, w2, b2), _t(ct))
    for g, r, name in zip(grads, (ref[0], ref[1].T, ref[2], ref[3].T,
                                  ref[4]), ('x', 'w1', 'b1', 'w2', 'b2')):
        assert _rel_max_err(g, r) <= GRAD_TOL, f'd{name}'

    frozen = [w.detach() for w in (w1, b1, w2, b2)]
    x2 = x.detach().requires_grad_()
    with mock.patch.object(tgf, 'geglu_ffn_bwd_plain',
                           wraps=tgf.geglu_ffn_bwd_plain) as spy:
        (dx,) = torch.autograd.grad(tgf.geglu_ffn(x2, *frozen), x2, _t(ct))
    assert spy.call_args.args[-1] == (True, False, False, False, False)
    assert _rel_max_err(dx, ref[0]) <= GRAD_TOL


@pytest.mark.parametrize('el,f,h,c', [(6, 16, 4, 160), (3, 24, 8, 64)])
def test_temporal_grad_matches_jax(el, f, h, c):
    rs = np.random.RandomState(el * f)
    q, k, v, ct = (rs.randn(el * f, c).astype(np.float32) for _ in range(4))
    ref = jax.grad(lambda q, k, v: (jta.temporal_attention(q, k, v, h, f)
                                    * ct).sum(),
                   argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a, grad=True) for a in (q, k, v))
    out = tta.temporal_attention(tq, tk, tv, h, f)
    assert out.grad_fn is not None
    grads = torch.autograd.grad(out, (tq, tk, tv), _t(ct))
    for g, r, name in zip(grads, ref, 'qkv'):
        assert _rel_max_err(g, r) <= GRAD_TOL, f'd{name}'


def test_wrappers_skip_autograd_without_grad():
    """No graph is recorded when nothing needs a gradient: the wrappers
    return plain tensors (the sampling path runs under no_grad)."""
    x = torch.randn(8, 16)
    w = [torch.randn(128, 16), torch.randn(128), torch.randn(16, 64),
         torch.randn(16)]
    assert tgf.geglu_ffn(x, *w).grad_fn is None
    q = torch.randn(1, 8, 2, 8, requires_grad=True)
    with torch.no_grad():
        assert tfa.flash_attention(q, q, q).grad_fn is None
    r = torch.randn(16, 8)
    assert tta.temporal_attention(r, r, r, 2, 4).grad_fn is None
