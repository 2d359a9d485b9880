"""Parity of the port's fused temporal transformer (ops/fused_temporal.py)
with the JAX package, on the CPU in fp32, at tiny sizes (F in {8, 16}, C
in {64, 128}, 2-8 heads; C = 384 for the FFN split above 320).

The same numpy weights and inputs go through:
- the port's plain version against the JAX Pallas kernel run in interpret
  mode (`_forward`, `_forward_4d`), both layouts, with and without the FFN;
- `ffn_tail` against the JAX package's;
- the port's autograd Function against the JAX custom VJP;
- the port's `TemporalTransformer3DModel` with the fused branch forced on
  the CPU against the JAX module's layer-wise output.

Tolerance 1e-4 absolute (the JAX side's max-free softmax and fp32 sums in
other orders; outputs are O(1)); gradients 1e-4 of their largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.models.motion_module import (
    VanillaTemporalModule as JModule)
from videoswap_tpu.ops import fused_temporal as jft
from videoswap_torch.models import motion_module as tmm
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.ops import fused_temporal as tft

TOL = 1e-4


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _pair(c, heads, f, seed, groups=8):
    """A JAX VanillaTemporalModule with random weights (proj_out away from
    its zero init) and the port's module loaded with the same weights."""
    jm = JModule(heads=heads, num_transformer_block=1, max_len=24,
                 norm_groups=groups)
    rs = np.random.RandomState(seed)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, f, 2, 2, c)))

    def leaf(path, x):
        name = str(getattr(path[-1], 'key', path[-1]))
        if name == 'kernel':
            v = rs.randn(*x.shape) / np.sqrt(x.shape[0])
        elif name == 'scale':
            v = 1.0 + 0.1 * rs.randn(*x.shape)
        else:
            v = 0.1 * rs.randn(*x.shape)
        return v.astype(np.float32)

    params = jax.tree_util.tree_map_with_path(leaf, shapes)
    tm = tmm.VanillaTemporalModule(c, heads, max_len=24, norm_groups=groups)
    tm.load_state_dict(jax_params_to_state_dict(params), strict=True)
    return jm, params, tm


def _inputs(n, c, seed):
    rs = np.random.RandomState(seed)
    return [rs.randn(n, c).astype(np.float32) for _ in range(2)]


def _jax_pe(f, c):
    rpt = max(1, 128 // f) * f
    return jnp.asarray(jft._pe_rows(f, c, rpt, 24), jnp.float32)


def _port_pe(f, c):
    return torch.from_numpy(tmm.sinusoidal_position_table(24, c)[:f])


@pytest.mark.parametrize('f,c,heads,include_ffn', [
    (16, 64, 2, True), (8, 128, 8, True), (16, 128, 4, False),
    (8, 64, 4, False)])
def test_plain_matches_pallas_kernel_rows(f, c, heads, include_ffn):
    _, params, tm = _pair(c, heads, f, seed=c + f)
    tt = params['params']['temporal_transformer']
    g2, x2 = _inputs(6 * f, c, seed=f)
    ref = jft._forward(jnp.asarray(g2), jnp.asarray(x2), _jax_pe(f, c),
                       jft.flatten_tt_params(tt, 1, include_ffn),
                       heads=heads, f=f, n_blocks=1,
                       include_ffn=include_ffn, interpret=True)
    flat = tft.flat_params(tm.temporal_transformer, include_ffn)
    out = tft.fused_temporal_transformer(
        torch.from_numpy(g2), torch.from_numpy(x2), _port_pe(f, c), flat,
        heads, f, include_ffn=include_ffn)
    assert out.shape == (6 * f, c)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize('f,c,heads,include_ffn', [
    (16, 64, 8, True), (8, 128, 2, False)])
def test_plain_matches_pallas_kernel_frame_major(f, c, heads, include_ffn):
    _, params, tm = _pair(c, heads, f, seed=3 * c + f)
    tt = params['params']['temporal_transformer']
    b, hw = 2, 5
    rs = np.random.RandomState(c)
    g4, x4 = (rs.randn(b, f, hw, c).astype(np.float32) for _ in range(2))
    ref = jft._forward_4d(jnp.asarray(g4), jnp.asarray(x4), _jax_pe(f, c),
                          jft.flatten_tt_params(tt, 1, include_ffn),
                          heads=heads, f=f, n_blocks=1,
                          include_ffn=include_ffn, interpret=True)
    flat = tft.flat_params(tm.temporal_transformer, include_ffn)
    out = tft.fused_temporal_transformer_bfhw(
        torch.from_numpy(g4), torch.from_numpy(x4), _port_pe(f, c), flat,
        heads, f, include_ffn=include_ffn)
    assert out.shape == (b, f, hw, c)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)


def test_ffn_tail_matches_jax():
    f, c, heads = 8, 64, 4
    _, params, tm = _pair(c, heads, f, seed=11)
    tt = params['params']['temporal_transformer']
    h2, x2 = _inputs(3 * f, c, seed=12)
    ref = jft.ffn_tail(jnp.asarray(h2), jnp.asarray(x2), tt, jnp.float32)
    out = tft.ffn_tail(torch.from_numpy(h2), torch.from_numpy(x2),
                       tm.temporal_transformer)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=TOL)


@pytest.mark.parametrize('bfhw', [False, True])
def test_gradients_match_the_jax_custom_vjp(bfhw):
    f, c, heads = 8, 64, 4
    _, params, tm = _pair(c, heads, f, seed=21)
    tt = params['params']['temporal_transformer']
    b, hw = 1, 3
    rs = np.random.RandomState(22)
    g4, x4, dout = (rs.randn(b, f, hw, c).astype(np.float32)
                    for _ in range(3))
    pe_j = _jax_pe(f, c)
    conv = ((lambda a: a.transpose(0, 2, 1, 3).reshape(-1, c)) if not bfhw
            else (lambda a: a))

    def loss(g, x, flat):
        fn = (jft.fused_temporal_transformer_bfhw if bfhw
              else jft.fused_temporal_transformer)
        out = fn(g, x, pe_j, flat, heads, f, 1, True)
        return (out * jnp.asarray(conv(dout))).sum()

    jflat = jft.flatten_tt_params(tt, 1, True)
    dg, dx, dflat = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(
        jnp.asarray(conv(g4)), jnp.asarray(conv(x4)), jflat)

    tt_mod = tm.temporal_transformer
    tt_mod.requires_grad_(True)
    g_t = torch.from_numpy(conv(g4)).requires_grad_()
    x_t = torch.from_numpy(conv(x4)).requires_grad_()
    fn = (tft.fused_temporal_transformer_bfhw if bfhw
          else tft.fused_temporal_transformer)
    out = fn(g_t, x_t, _port_pe(f, c), tft.flat_params(tt_mod, True), heads,
             f, include_ffn=True)
    out.backward(torch.from_numpy(conv(dout)))
    mats = [tt_mod.proj_in.weight]
    blk = tt_mod.transformer_blocks[0]
    mats += [blk.attention_blocks[1].to_v.weight,
             blk.ff.net[0].proj.weight, tt_mod.proj_out.weight]
    jmats = [dflat[0], dflat[13], dflat[18], dflat[22]]
    pairs = [(g_t.grad.numpy(), dg), (x_t.grad.numpy(), dx),
             (blk.norms[0].weight.grad.numpy(), dflat[2]),
             (blk.ff.net[2].bias.grad.numpy(), dflat[21])]
    pairs += [(m.grad.numpy().T, jm) for m, jm in zip(mats, jmats)]
    for got, ref in pairs:
        ref = np.asarray(ref)
        assert got.shape == ref.shape
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=TOL * float(np.abs(ref).max()))


@pytest.mark.parametrize('f,c,heads,four_d', [
    (16, 64, 4, False), (8, 128, 8, True), (8, 384, 8, False)])
def test_module_fused_branch_matches_jax_layerwise(monkeypatch, f, c, heads,
                                                   four_d):
    """The port's module with the fused gate forced open on the CPU (so
    C = 384 takes the attention half + ffn_tail, and FT_4D the frame-major
    entry) against the JAX module's layer-wise path."""
    jm, params, tm = _pair(c, heads, f, seed=31 + c)
    x = np.random.RandomState(32).randn(1, f, 2, 3, c).astype(np.float32)
    ref = jax.jit(jm.apply)(params, jnp.asarray(x))
    taken = []

    def gate(*args):
        taken.append(args[1])
        return True

    monkeypatch.setattr(tmm, 'use_fused', gate)
    if four_d:
        monkeypatch.setenv('FT_4D', '1')
    with torch.no_grad():
        out = tm(torch.from_numpy(x))
    assert taken == [c]
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=TOL)


def test_gate_follows_the_jax_package(monkeypatch):
    x = torch.zeros(1)
    assert not tmm.use_fused(x, 320, 16, 1, 24)          # CPU tensor
    monkeypatch.setattr(torch.Tensor, 'is_cuda', property(lambda s: True))
    assert tmm.use_fused(x, 320, 16, 1, 24)
    assert tmm.use_fused(x, 640, 24, 1, 24)
    assert not tmm.use_fused(x, 1280, 16, 1, 24)          # layer-wise
    assert not tmm.use_fused(x, 320, 16, 2, 24)
    assert not tmm.use_fused(x, 320, 25, 1, 24)
    monkeypatch.setenv('FT_DISABLE', '1')
    assert not tmm.use_fused(x, 320, 16, 1, 24)
