"""Parity of the port's kernel modules (videoswap_torch/ops) with the JAX
package: GEGLU FFN, temporal attention, flash-attention forward, the
attention router and the subpixel upsample conv.

On the CPU each port wrapper takes its plain PyTorch version; it is held
against the JAX Pallas kernel in interpret mode and against the JAX public
function (its off-TPU fallback), on the same numpy inputs, in fp32. The
CUDA kernels themselves are held against their plain versions on the card
by tests/test_torch_cuda_kernels.py.
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
from videoswap_tpu.ops.attention import \
    dot_product_attention as j_dot_product_attention
from videoswap_torch.ops import flash_attention as tfa
from videoswap_torch.ops import geglu_ffn as tgf
from videoswap_torch.ops import temporal_attention as tta
from videoswap_torch.ops.attention import dot_product_attention

torch.backends.cudnn.allow_tf32 = False
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

# fp32 on both sides; the sums are taken in another order, so outputs of
# O(1) agree to a few fp32 ulps times the reduction length
ATOL = RTOL = 2e-5


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32))


# ------------------------------------------------------------------ GEGLU
def _geglu_args(n, c, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, c).astype(np.float32) * 0.5,
            rs.randn(c, 8 * c).astype(np.float32) * c ** -0.5,
            rs.randn(8 * c).astype(np.float32) * 0.1,
            rs.randn(4 * c, c).astype(np.float32) * (4 * c) ** -0.5,
            rs.randn(c).astype(np.float32) * 0.1]


def _geglu_port(x, w1, b1, w2, b2):
    # JAX Dense layout (I, O) -> torch Linear layout (O, I)
    return tgf.geglu_ffn(_t(x), _t(w1).T.contiguous(), _t(b1),
                         _t(w2).T.contiguous(), _t(b2)).numpy()


@pytest.mark.parametrize('n,c', [(130, 64), (300, 128)])
def test_geglu_plain_matches_pallas_interpret(n, c):
    args = _geglu_args(n, c, n)
    ref = jgf._forward(*map(jnp.asarray, args), interpret=True, block=128)
    np.testing.assert_allclose(_geglu_port(*args), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('n,c', [(77, 40), (64, 80)])
def test_geglu_plain_matches_jax_public(n, c):
    args = _geglu_args(n, c, c)
    ref = jgf.geglu_ffn(*map(jnp.asarray, args))
    np.testing.assert_allclose(_geglu_port(*args), np.asarray(ref),
                               rtol=RTOL, atol=ATOL)


def test_gelu_fast_matches_jax():
    x = np.linspace(-12, 12, 20001).astype(np.float32)
    # the same Horner polynomial in both packages: fp32 rounding only
    np.testing.assert_allclose(tgf.gelu_fast(_t(x)).numpy(),
                               np.asarray(jgf.gelu_fast(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(_t(x)).numpy()
    np.testing.assert_allclose(tgf.gelu_fast(_t(x)).numpy(), exact,
                               atol=5e-5)


def test_geglu_keeps_x_dtype():
    x, w1, b1, w2, b2 = (_t(a) for a in _geglu_args(8, 16, 0))
    out = tgf.geglu_ffn(x.bfloat16(), w1.T.bfloat16(), b1,
                        w2.T.bfloat16(), b2)
    assert out.dtype == torch.bfloat16


# ---------------------------------------------------- temporal attention
def _qkv_rows(el, f, c, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(el * f, c).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize('el,f,h,c', [(10, 16, 8, 320), (6, 24, 4, 160),
                                      (4, 16, 2, 160)])
def test_temporal_plain_matches_pallas_interpret(el, f, h, c):
    # d = c / h: 40, 40 and 80
    q, k, v = _qkv_rows(el, f, c, el + f)
    ref = jta._forward(*map(jnp.asarray, (q, k, v)), h, f, interpret=True)
    out = tta.temporal_attention(_t(q), _t(k), _t(v), h, f).numpy()
    # the TPU kernel's max-free exp with logits clipped at 60 equals the
    # max-subtracted softmax for these unclipped logits
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('el,f,h,c', [(12, 16, 8, 640), (5, 24, 8, 320)])
def test_temporal_plain_matches_jax_public(el, f, h, c):
    q, k, v = _qkv_rows(el, f, c, el)
    ref = jta.temporal_attention(*map(jnp.asarray, (q, k, v)), h, f)
    out = tta.temporal_attention(_t(q), _t(k), _t(v), h, f).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------- flash
def _bshd(b, s, h, d, seed):
    return np.random.RandomState(seed).randn(b, s, h, d).astype(np.float32)


def _jax_flash_interpret(q, k, v):
    orig = pl.pallas_call
    calls = []

    def interp(*a, **kw):
        calls.append(1)
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        return orig(*a, **kw)

    with jax.disable_jit(), \
            mock.patch.object(jfa.pl, 'pallas_call', interp), \
            mock.patch.object(jfa.jax, 'default_backend', lambda: 'tpu'):
        out = jfa.flash_attention(*map(jnp.asarray, (q, k, v)), 128, 128)
    assert calls, 'the Pallas kernel did not run'
    return np.asarray(out)


@pytest.mark.parametrize('sq,sk,d', [(200, 77, 40), (130, 130, 80)])
def test_flash_plain_matches_pallas_interpret(sq, sk, d):
    q = _bshd(1, sq, 2, d, 1)
    k, v = _bshd(1, sk, 2, d, 2), _bshd(1, sk, 2, d, 3)
    ref = _jax_flash_interpret(q, k, v)
    out, lse = tfa.flash_attention_fwd(_t(q), _t(k), _t(v))
    np.testing.assert_allclose(out.numpy(), ref, rtol=RTOL, atol=ATOL)
    logits = np.einsum('bqhd,bkhd->bhqk', q, k) * d ** -0.5
    m = logits.max(-1, keepdims=True)
    lse_ref = (m + np.log(np.exp(logits - m).sum(-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), lse_ref.reshape(-1, sq),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize('b,sq,sk,h,d', [(2, 77, 77, 4, 40),
                                         (3, 45, 77, 2, 80)])
def test_flash_plain_matches_jax_public(b, sq, sk, h, d):
    q = _bshd(b, sq, h, d, 4)
    k, v = _bshd(b, sk, h, d, 5), _bshd(b, sk, h, d, 6)
    ref = jfa.flash_attention(*map(jnp.asarray, (q, k, v)))
    out = tfa.flash_attention(_t(q), _t(k), _t(v)).numpy()
    np.testing.assert_allclose(out, np.asarray(ref), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('d,takes', [(40, True), (80, True), (120, True),
                                     (160, True), (36, False), (104, False),
                                     (136, False), (168, False)])
def test_flash_kernel_args_match_its_head_dims(d, takes):
    """The wrapper refuses, before any launch, each head dim whose padded
    size csrc/flash_attention.cu has no case for."""
    q = torch.zeros(1, 8, 2, d, dtype=torch.bfloat16)
    if takes:
        tfa._check_kernel_args(q, q, q)
    else:
        with pytest.raises(ValueError, match='head dim'):
            tfa._check_kernel_args(q, q, q)


def test_flash_plain_batch_chunks_agree():
    q, k, v = (_t(_bshd(5, 33, 2, 16, s)) for s in (7, 8, 9))
    full = tfa.flash_attention_plain(q, k, v)
    chunked = tfa.flash_attention_plain(q, k, v, batch_chunk=2)
    for a, b in zip(full, chunked):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


# --------------------------------------------------------------- router
@pytest.mark.parametrize('sq,sk,impl', [(16, 16, 'flash'), (40, 40, 'flash'),
                                        (40, 77, 'flash'), (40, 40, 'auto')])
def test_router_matches_jax(sq, sk, impl):
    """Same shape-based routing as the JAX package: <= 32 self tokens go to
    temporal attention, every other site to the flash forward. The JAX
    package's 'auto' (XLA softmax) and 'flash' paths compute the same
    function, so the port matches both."""
    rs = np.random.RandomState(sq + sk)
    q = rs.randn(3, sq, 32).astype(np.float32)
    k, v = (rs.randn(3, sk, 32).astype(np.float32) for _ in range(2))
    ref = j_dot_product_attention(*map(jnp.asarray, (q, k, v)), 4, impl=impl)
    with mock.patch.object(tta, 'temporal_attention_plain',
                           wraps=tta.temporal_attention_plain) as spy, \
            mock.patch.object(tfa, 'flash_attention_plain',
                              wraps=tfa.flash_attention_plain) as flash_spy:
        out = dot_product_attention(_t(q), _t(k), _t(v), 4)
    assert spy.called == (sq == sk and sq <= 32)
    assert flash_spy.called == (not spy.called)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=RTOL,
                               atol=ATOL)


def test_attention_with_probs_matches_jax():
    from videoswap_tpu.ops import attention_with_probs as j_awp
    from videoswap_torch.ops import attention_with_probs
    rs = np.random.RandomState(11)
    q = rs.randn(2, 16, 32).astype(np.float32)
    k, v = (rs.randn(2, 8, 32).astype(np.float32) for _ in range(2))
    jo, jp = j_awp(*map(jnp.asarray, (q, k, v)), 4)
    to, tp = attention_with_probs(_t(q), _t(k), _t(v), 4)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=RTOL,
                               atol=ATOL)


# -------------------------------------------------------------- subpixel
@pytest.mark.parametrize('naive', [False, True])
def test_subpixel_matches_jax(naive):
    from videoswap_tpu.ops import subpixel as jsp
    from videoswap_torch.ops import subpixel as tsp
    rs = np.random.RandomState(5)
    x = rs.randn(2, 5, 6, 8).astype(np.float32)
    kern = rs.randn(3, 3, 8, 12).astype(np.float32) * 0.2     # HWIO
    bias = rs.randn(12).astype(np.float32)
    w = _t(kern).permute(3, 2, 0, 1).contiguous()            # OIHW
    if naive:
        ref = jsp.naive_upsample_conv(jnp.asarray(x), jnp.asarray(kern),
                                      jnp.asarray(bias), jnp.float32, (9, 12))
        out = tsp.naive_upsample_conv(_t(x), w, _t(bias), (9, 12))
    else:
        ref = jsp.subpixel_upsample_conv(jnp.asarray(x), jnp.asarray(kern),
                                         jnp.asarray(bias), jnp.float32)
        out = tsp.subpixel_upsample_conv(_t(x), w, _t(bias))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
