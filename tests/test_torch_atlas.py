"""Parity of the port's layered-neural-atlas path with the JAX package at a
tiny config (nets of width 32 with 3 layers, a 4-level hash grid with a 2^10
table whose levels 0-2 are dense and level 3 hashed, a 4-frame 16x16 clip,
batch 256), fp32 on the CPU: the table-gradient scatter against the Pallas
kernel in interpret mode and its XLA scatter, the hash encoding and both its
gradients against the JAX custom VJP, the IMLPs, every loss, one main step
(both sides of the step gates) and one inverse step on the draws
`jax.random` made, pretraining, the consistency masks, the reconstruction
and its PSNR, and point propagation. Then the port alone, with JAX blocked.
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from videoswap_tpu.atlas import data as jdata
from videoswap_tpu.atlas import losses as jlosses
from videoswap_tpu.atlas.evaluate import evaluate_model as j_evaluate_model
from videoswap_tpu.atlas.evaluate import \
    reconstruct_video as j_reconstruct_video
from videoswap_tpu.atlas.imlp import IMLP as JIMLP
from videoswap_tpu.atlas.imlp import _level_geometry as j_level_geometry
from videoswap_tpu.atlas.imlp import \
    _level_resolutions as j_level_resolutions
from videoswap_tpu.atlas.imlp import hash_encode as j_hash_encode
from videoswap_tpu.atlas.imlp import positional_encode as j_positional_encode
from videoswap_tpu.atlas.propagate import bind_nets as j_bind_nets
from videoswap_tpu.atlas.propagate import \
    propagate_point_sequence as j_propagate_point_sequence
from videoswap_tpu.atlas.trainer import AtlasTrainer as JAtlasTrainer
from videoswap_tpu.ops.hash_table_grad import (hash_table_grad,
                                               hash_table_grad_xla)
from videoswap_torch.atlas import data as tdata
from videoswap_torch.atlas import losses as tlosses
from videoswap_torch.atlas.evaluate import evaluate_model, reconstruct_video
from videoswap_torch.atlas.imlp import (IMLP, _level_geometry,
                                        _level_resolutions, _mul_u32,
                                        hash_encode, positional_encode)
from videoswap_torch.atlas.propagate import (bind_nets,
                                             propagate_point_sequence)
from videoswap_torch.atlas.trainer import AtlasTrainer
from videoswap_torch.builders import build_atlas_nets
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.ops.hash_table_grad import (hash_table_grad_fixed,
                                                 hash_table_grad_plain)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    # several pytest workers share the host, and JAX's CPU backend has a
    # pool of its own
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a, dtype=np.float32):
    return torch.from_numpy(np.array(a, dtype=dtype))


# --------------------------------------------------------------- hash grid
def test_atlas_swan_level_geometry():
    """The published grid (16 levels, 2^19 table, base 16, scale 1.38):
    levels 0-11 index densely, from 289 entries to 306916, and 12-15 hash
    into the whole table; a main step's six F_Atlas sites of 10000 points
    scatter 4 x 60000 rows a level."""
    res = _level_resolutions(16, 16, 1.38)
    assert res == j_level_resolutions(16, 16, 1.38)
    entries = [(r + 1) ** 2 for r in res]
    dense = [e <= 2 ** 19 for e in entries]
    assert dense == [True] * 12 + [False] * 4
    assert entries[0] == 289 and entries[7] == 23409
    assert entries[11] == 306916 and res[12] == 763
    x = torch.rand(6 * 10000, 2)
    idx, u, v, _ = _level_geometry(x, res, 2 ** 19)
    assert idx.shape == (16, 4, 60000)
    assert idx.reshape(16, -1).shape[1] == 240000
    assert int(idx.min()) >= 0 and int(idx.max()) < 2 ** 19
    np.testing.assert_allclose((u * v).sum(1).numpy(), 1.0, atol=1e-6)


def test_hash_index_wraps_like_uint32():
    """The spatial hash of negative and extreme cells: int64 arithmetic
    with the prime split in halves gives numpy's uint32 wrap-around, and
    the whole index matches JAX's at a hashed level."""
    cells = np.array([-2 ** 31, -3000, -1, 0, 1, 7, 2 ** 31 - 1], np.int64)
    want = (cells.astype(np.int32).astype(np.uint32)
            * np.uint32(2654435761)).astype(np.int64)
    got = _mul_u32(torch.from_numpy(cells) & 0xFFFFFFFF, 2654435761)
    np.testing.assert_array_equal(got.numpy(), want)
    x = np.array([[-1.5, -0.7], [-0.01, 2.3], [3.7, -2.2], [0.5, 0.5]],
                 np.float32)
    for res in (22, 763):                    # dense and hashed at T = 2^10
        j_idx, j_w, _ = j_level_geometry(jnp.asarray(x), res, 1024)
        idx, u, v, _ = _level_geometry(torch.from_numpy(x), [res], 1024)
        np.testing.assert_array_equal(idx[0].numpy(), np.asarray(j_idx))
        np.testing.assert_array_equal((u * v)[0].numpy(), np.asarray(j_w))


@pytest.mark.parametrize('num_entries', [289, 2048, 82944])
def test_hash_table_grad_plain_matches_jax(num_entries):
    """Against the Pallas kernel with 5% dropped (-1) rows, and against the
    XLA scatter on the kept rows (jnp's `.at[-1]` wraps to the last entry
    instead of dropping it)."""
    rs = np.random.RandomState(num_entries)
    r = 4096
    idx = rs.randint(0, num_entries, size=r).astype(np.int32)
    idx[rs.rand(r) < 0.05] = -1
    val = rs.randn(r, 2).astype(np.float32)
    out = hash_table_grad_plain(torch.from_numpy(idx), torch.from_numpy(val),
                                num_entries).numpy()
    keep = idx >= 0
    ref_xla = hash_table_grad_xla(jnp.asarray(idx[keep]),
                                  jnp.asarray(val[keep].T), num_entries)
    ref_kernel = hash_table_grad(jnp.asarray(idx), jnp.asarray(val.T),
                                 num_entries, interpret=True)
    assert out.shape == (num_entries, 2)
    np.testing.assert_allclose(out, np.asarray(ref_xla), rtol=1e-6,
                               atol=1e-6)
    # the Pallas kernel splits fp32 values into two bf16 halves
    np.testing.assert_allclose(out, np.asarray(ref_kernel), rtol=2e-3,
                               atol=5e-5)


def test_hash_table_grad_plain_drops_rows_and_takes_any_row_count():
    out = hash_table_grad_plain(torch.tensor([0, -1, 5, -1, 5, 512],
                                             dtype=torch.int32),
                                torch.ones(6, 2), 512)
    assert float(out[0, 0]) == 1.0 and float(out[5, 1]) == 2.0
    assert float(out.abs().sum()) == 6.0
    rs = np.random.RandomState(1)
    idx = rs.randint(-1, 300, size=1000).astype(np.int32)   # R % 1024 != 0
    val = rs.randn(1000, 2).astype(np.float32)
    out = hash_table_grad_plain(torch.from_numpy(idx), torch.from_numpy(val),
                                300)
    ref = hash_table_grad(jnp.asarray(idx), jnp.asarray(val.T), 300,
                          bf16x2=False, interpret=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('num_entries', [289, 2048, 82944])
def test_hash_table_grad_fixed_point_matches_jax_in_any_row_order(
        num_entries):
    """The CUDA kernel's fixed-point arithmetic, stated in PyTorch: within
    1e-5 of the largest entry of the JAX package's XLA scatter (the card
    check's limit), the same bits for the rows in any order, and `out=`
    accumulates."""
    rs = np.random.RandomState(num_entries + 7)
    r = 4096
    idx = rs.randint(0, num_entries, size=r).astype(np.int32)
    idx[rs.rand(r) < 0.05] = -1
    idx[:3] = num_entries                          # past the end: dropped
    val = (rs.randn(r, 2) * 1e-3).astype(np.float32)
    keep = (idx >= 0) & (idx < num_entries)
    ref = np.asarray(hash_table_grad_xla(jnp.asarray(idx[keep]),
                                         jnp.asarray(val[keep].T),
                                         num_entries))
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    out = hash_table_grad_fixed(ti, tv, num_entries)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0,
                               atol=1e-5 * np.abs(ref).max())
    perm = torch.from_numpy(rs.permutation(r))
    again = hash_table_grad_fixed(ti[perm], tv[perm], num_entries)
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))
    acc = torch.ones((num_entries, 2))
    hash_table_grad_fixed(ti, tv, num_entries, out=acc)
    np.testing.assert_allclose((acc - 1).numpy(), ref, rtol=0, atol=2e-7)


def _same_non_finite(a, b):
    """The same entries NaN, +inf and -inf in a and b."""
    return all(torch.equal(f(a), f(b)) for f in (
        torch.isnan, torch.isposinf, torch.isneginf))


@pytest.mark.parametrize('num_entries', [289, 82944])
def test_hash_table_grad_fixed_point_keeps_what_is_not_finite(num_entries):
    """Rows that are NaN, +inf or -inf (a diverging step) leave their
    entries NaN or infinite as the plain version and the JAX package's XLA
    scatter leave them, in any row order, and take no part in the scale:
    the other entries stay within 1e-5 of the largest finite entry."""
    rs = np.random.RandomState(num_entries + 11)
    r = 4096
    idx = rs.randint(0, num_entries, size=r).astype(np.int32)
    idx[rs.rand(r) < 0.05] = -1
    val = (rs.randn(r, 2) * 1e-3).astype(np.float32)
    idx[10:16] = [5, 5, 6, 7, 7, 8]
    val[10:16, 0] = [np.inf, -np.inf, np.nan, np.inf, np.inf, -np.inf]
    val[16, 1] = np.nan                            # a dropped row's NaN
    idx[16] = -1
    keep = idx >= 0
    ref = np.array(hash_table_grad_xla(jnp.asarray(idx[keep]),
                                       jnp.asarray(val[keep].T),
                                       num_entries))
    ti, tv = torch.from_numpy(idx), torch.from_numpy(val)
    out = hash_table_grad_fixed(ti, tv, num_entries)
    plain = hash_table_grad_plain(ti, tv, num_entries)
    assert _same_non_finite(out, plain)
    assert _same_non_finite(out, torch.from_numpy(ref))
    assert torch.isnan(out[5, 0]) and torch.isnan(out[6, 0])
    assert torch.isposinf(out[7, 0]) and torch.isneginf(out[8, 0])
    finite = torch.isfinite(plain)
    assert int(finite.sum()) == plain.numel() - 4
    tol = 1e-5 * float(plain[finite].abs().max())
    assert float((out - plain)[finite].abs().max()) <= tol
    perm = torch.from_numpy(rs.permutation(r))
    again = hash_table_grad_fixed(ti[perm], tv[perm], num_entries)
    assert _same_non_finite(out, again)
    assert torch.equal(out[finite].view(torch.int32),
                       again[finite].view(torch.int32))


def test_hash_table_grad_fixed_point_does_not_overflow():
    """Every row into one entry at the largest value: the integer sum stays
    below 2^63 and comes back to R * max|val|."""
    r = 240000
    val = torch.full((r, 2), 3.0e4)
    val[::2, 1] = -3.0e4
    out = hash_table_grad_fixed(torch.zeros(r, dtype=torch.int32), val, 4)
    assert float(out[0, 0]) == np.float32(r * 3.0e4)
    assert float(out[0, 1]) == 0.0 and float(out[1:].abs().sum()) == 0.0


def test_hash_encode_matches_jax_custom_vjp():
    """Forward and both gradients at coordinates in [-1.5, 1.5] (negative
    cells at dense and hashed levels), 5 levels of a 2^10 table."""
    rs = np.random.RandomState(0)
    n, levels, t = 257, 5, 1024
    x = rs.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    table = (rs.randn(levels, t, 2) * 1e-2).astype(np.float32)
    cot = rs.randn(n, levels * 2).astype(np.float32)
    res = _level_resolutions(levels, 16, 1.38)
    assert [(r + 1) ** 2 <= t for r in res] == [True] * 3 + [False] * 2
    assert (x < 0).any()

    def j_loss(x, table):
        return jnp.vdot(j_hash_encode(x, table, custom_vjp=True), cot)

    ref = j_hash_encode(jnp.asarray(x), jnp.asarray(table), custom_vjp=True)
    rgx, rgt = jax.grad(j_loss, argnums=(0, 1))(jnp.asarray(x),
                                                jnp.asarray(table))
    tx, tt = (_t(a).requires_grad_() for a in (x, table))
    out = hash_encode(tx, tt)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref),
                               rtol=0, atol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(rgx), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(rgt), rtol=1e-5,
                               atol=1e-5)


def test_positional_encode_matches_jax():
    x = np.random.RandomState(3).uniform(-1, 1, (9, 3)).astype(np.float32)
    np.testing.assert_allclose(positional_encode(_t(x), 5).numpy(),
                               np.asarray(j_positional_encode(
                                   jnp.asarray(x), 5)), atol=1e-6)


@pytest.mark.parametrize('pe_type,skip,tanh', [
    ('none', (), True), ('encoding', (1,), False),
    ('hash_encoding', (1, 2), True), ('hash_encoding', (), False)])
def test_imlp_matches_jax(pe_type, skip, tanh):
    in_dim = 2 if pe_type == 'hash_encoding' else 3
    kw = dict(input_dim=in_dim, output_dim=3, hidden_dim=32, mlp_layers=3,
              pe_type=pe_type, pe_dim=4, skip_layers=skip, use_tanh=tanh,
              hash_levels=4, log2_hashmap_size=10)
    x = np.random.RandomState(4).uniform(-1.2, 1.2, (65, in_dim)).astype(
        np.float32)
    jnet = JIMLP(**kw)
    params = jnet.init(jax.random.PRNGKey(1), jnp.asarray(x))
    net = IMLP(**kw)
    net.load_state_dict(jax_params_to_state_dict(params), strict=True)
    with torch.no_grad():
        out = net(_t(x)).numpy()
    np.testing.assert_allclose(out, np.asarray(jnet.apply(params,
                                                          jnp.asarray(x))),
                               rtol=1e-5, atol=1e-5)


# ------------------------------------------------------------------ losses
def _loss_inputs():
    rs = np.random.RandomState(5)
    n = 64
    a = {k: rs.uniform(-1, 1, (n, 2)).astype(np.float32)
         for k in ('uv', 'uv_xm', 'uv_ym', 'uv_f', 'uv_b')}
    a.update(rgb=rs.rand(n, 3).astype(np.float32),
             rgb2=rs.rand(n, 3).astype(np.float32),
             rgb3=rs.rand(n, 3).astype(np.float32),
             dx=rs.randn(n, 3).astype(np.float32) * 0.1,
             dy=rs.randn(n, 3).astype(np.float32) * 0.1,
             alpha=rs.uniform(0.01, 0.99, (n, 1)).astype(np.float32),
             alpha2=rs.uniform(0.01, 0.99, (n, 1)).astype(np.float32),
             alpha3=rs.uniform(0.01, 0.99, (n, 1)).astype(np.float32),
             alpha_gt=(rs.rand(n, 1) > 0.5).astype(np.float32),
             raw=rs.uniform(-1, 1, (n, 1)).astype(np.float32),
             valid_f=(rs.rand(n) > 0.3).astype(np.float32),
             valid_b=(rs.rand(n) > 0.3).astype(np.float32),
             xyf=np.stack([rs.randint(2, 14, n), rs.randint(2, 14, n),
                           rs.randint(1, 3, n)], -1).astype(np.int32),
             flows=rs.randn(4, 16, 16, 2).astype(np.float32),
             flows_rev=rs.randn(4, 16, 16, 2).astype(np.float32),
             fmask=(rs.rand(4, 16, 16) > 0.3).astype(np.float32),
             fmask_rev=(rs.rand(4, 16, 16) > 0.3).astype(np.float32))
    return a


def _nets(m):
    """Smooth stand-ins for the nets in both frameworks."""
    def uv_map(p):
        return m.tanh(p[:, :2] * 0.7 + 0.2 * m.sin(3.0 * p[:, 2:3]))

    def uv_map2(p):
        return p[:, :2] * 0.8 + 0.1 * p[:, 2:3]

    def f_alpha(p):
        return m.tanh(p[:, :1] + p[:, 1:2] * p[:, 2:3])

    def f_atlas(uv):
        return m.tanh(m.concatenate([uv, uv[:, :1] * uv[:, 1:]], 1))
    return uv_map, uv_map2, f_alpha, f_atlas


class _TorchMath:
    tanh, sin = staticmethod(torch.tanh), staticmethod(torch.sin)
    concatenate = staticmethod(torch.cat)


def _norms():
    # the trainer's normalisations at larger_dim 16, 4 frames
    def norm_s(v):
        return v / 8.0 - 1.0

    def norm_t(v):
        return v / 2.0 - 1.0
    return norm_s, norm_t


LOSS_CASES = {
    'masked_mean': lambda L, a, n: L.masked_mean(a['raw'][:, 0],
                                                 a['valid_f']),
    'safe_norm': lambda L, a, n: L.safe_norm(a['uv'] - a['uv_f']),
    'scaled_alpha': lambda L, a, n: L.scaled_alpha(a['raw']),
    'atlas_rgb': lambda L, a, n: L.atlas_rgb(n[3], a['uv'], 'bg'),
    'reconstruct_rgb': lambda L, a, n: L.reconstruct_rgb(
        a['uv'], a['uv_f'], a['alpha'], n[3])[0],
    'rgb_loss': lambda L, a, n: L.rgb_loss(a['rgb'], a['rgb2']),
    'alpha_bce_loss': lambda L, a, n: L.alpha_bce_loss(a['alpha'],
                                                       a['alpha_gt']),
    'sparsity_loss': lambda L, a, n: L.sparsity_loss(a['rgb'], a['alpha']),
    'gradient_loss_pre': lambda L, a, n: L.gradient_loss_pre(
        a['rgb'], a['rgb2'], a['rgb3'], a['dx'], a['dy']),
    'gradient_loss': lambda L, a, n: L.gradient_loss(
        a['xyf'], a['rgb'], a['dx'], a['dy'], n[0], n[1], n[2], n[3],
        *n[4]),
    'rigidity_loss_all': lambda L, a, n: L.rigidity_loss_all(
        a['uv'], a['uv_xm'], a['uv_ym'], 1, 16, 0.8),
    'rigidity_loss_pre': lambda L, a, n: L.rigidity_loss_pre(
        a['uv'], a['uv_xm'], a['uv_ym'], 4, 16, 0.8),
    'rigidity_loss': lambda L, a, n: L.rigidity_loss(
        a['xyf'], n[0](a['xyt']), n[0], 2, 16, 0.8, *n[4]),
    'optical_flow_loss_pre': lambda L, a, n: L.optical_flow_loss_pre(
        a['uv'], a['uv_f'], a['uv_b'], a['valid_f'], a['valid_b'], 16, 0.8,
        alpha=a['alpha']),
    'optical_flow_loss': lambda L, a, n: L.optical_flow_loss(
        a['xyf'], n[1](a['xyt']), n[1], a['flows'], a['fmask'],
        a['flows_rev'], a['fmask_rev'], 16, 0.8, *n[4], alpha=a['alpha']),
    'optical_flow_loss_all': lambda L, a, n: L.optical_flow_loss_all(
        a['uv'], a['uv_f'], a['valid_f'], 16, 0.8, alpha=a['alpha']),
    'flow_alpha_loss_all': lambda L, a, n: L.flow_alpha_loss_all(
        a['alpha'], a['alpha2'], a['valid_f']),
    'optical_flow_alpha_loss_pre': lambda L, a, n:
        L.optical_flow_alpha_loss_pre(a['alpha'], a['alpha2'], a['alpha3'],
                                      a['valid_f'], a['valid_b']),
    'optical_flow_alpha_loss': lambda L, a, n: L.optical_flow_alpha_loss(
        a['xyf'], a['alpha'], n[2], a['flows'], a['fmask'], a['flows_rev'],
        a['fmask_rev'], *n[4]),
}


@pytest.mark.parametrize('name', sorted(LOSS_CASES))
def test_loss_matches_jax(name):
    a = _loss_inputs()
    xyf = a['xyf']
    a['xyt'] = np.stack([xyf[:, 0] / 8.0 - 1, xyf[:, 1] / 8.0 - 1,
                         xyf[:, 2] / 2.0 - 1], -1).astype(np.float32)
    ja = {k: jnp.asarray(v) for k, v in a.items()}
    ta = {k: torch.from_numpy(v) for k, v in a.items()}
    ta['xyf'] = ta['xyf'].long()
    ref = LOSS_CASES[name](jlosses, ja, (*_nets(jnp), _norms()))
    out = LOSS_CASES[name](tlosses, ta,
                           (*_nets(_TorchMath), _norms()))
    np.testing.assert_allclose(np.asarray(out), np.asarray(ref), rtol=1e-5,
                               atol=1e-6, err_msg=name)


def test_every_jax_loss_has_a_case():
    public = {n for n in dir(jlosses) if not n.startswith('_')
              and callable(getattr(jlosses, n))
              and getattr(getattr(jlosses, n), '__module__', '')
              == jlosses.__name__}
    assert public <= set(LOSS_CASES), public - set(LOSS_CASES)
    assert public <= {n for n in dir(tlosses) if not n.startswith('_')}


# ----------------------------------------------------------------- trainer
TRAIN_OPT = {
    'optimizer': {'lr': 1e-3},
    'uv_mapping_scale': 0.8,
    'sample_batch_size': 256,
    'derivative_amount': 1,
    'global_derivative_amount': 4,
    'pretrain_alpha_iter': 6,
    'pretrain_global_rigidity_iter': 4,
    'loss_cfg': {
        'reconstruction_loss': {'rgb_loss_weight': 5000,
                                'gradient_loss_weight': 1000,
                                'alpha_loss_weight': 2000},
        'sparsity_loss': {'sparsity_loss_weight': 1000},
        'rigidity_loss': {'rigidity_loss_weight': 1,
                          'global_rigidity_fg_loss_weight': 5,
                          'global_rigidity_bg_loss_weight': 50},
        'flow_loss': {'flow_loss_weight': 5, 'alpha_flow_loss_weight': 49},
    },
}
NET_KW = {
    'FG_UV_Mapping': dict(input_dim=3, output_dim=2),
    'BG_UV_Mapping': dict(input_dim=3, output_dim=2),
    'F_Alpha': dict(input_dim=3, output_dim=1, pe_type='encoding', pe_dim=2),
    'F_Atlas': dict(input_dim=2, output_dim=3, pe_type='hash_encoding',
                    hash_levels=4, log2_hashmap_size=10, skip_layers=(2,)),
    'FG_UV_Mapping_Inverse': dict(input_dim=3, output_dim=3),
}
F_, H_, W_ = 4, 16, 16


def _clip():
    """A 4-frame 16x16 clip: a gradient background, a block moving right,
    random sub-pixel flows and consistency masks."""
    rs = np.random.RandomState(0)
    video = np.zeros((F_, H_, W_, 3), np.float32)
    mask = np.zeros((F_, H_, W_), np.float32)
    for i in range(F_):
        video[i, :, :, 0] = np.linspace(0, 1, W_)[None, :]
        video[i, :, :, 1] = np.linspace(0, 1, H_)[:, None]
        video[i, :, :, 2] = rs.rand(H_, W_) * 0.2
        cx = 4 + 2 * i
        video[i, 6:10, cx - 2:cx + 2] = [0.9, 0.2, 0.1]
        mask[i, 6:10, cx - 2:cx + 2] = 1.0
    dx, dy = np.zeros_like(video), np.zeros_like(video)
    dx[:, :, :-1] = video[:, :, 1:] - video[:, :, :-1]
    dy[:, :-1] = video[:, 1:] - video[:, :-1]
    flows = (rs.randn(F_, H_, W_, 2) * 0.7).astype(np.float32)
    flows_rev = (rs.randn(F_, H_, W_, 2) * 0.7).astype(np.float32)
    fm = (rs.rand(F_, H_, W_) > 0.3).astype(np.float32)
    fmr = (rs.rand(F_, H_, W_) > 0.3).astype(np.float32)
    return dict(video=video, mask=mask, dx=dx, dy=dy, flows=flows,
                flows_rev=flows_rev, flow_masks=fm, flow_masks_rev=fmr)


@pytest.fixture(scope='module')
def atlas_jax():
    """The JAX trainer, its params and the clip, built once; and a second
    JAX trainer whose optimizer is SGD at lr 1, whose step gives the
    gradient itself as params - new params."""
    nets = {n: JIMLP(hidden_dim=32, mlp_layers=3, **kw)
            for n, kw in NET_KW.items()}
    data = _clip()
    jdata_ = {k: jnp.asarray(v) for k, v in data.items()}
    trainer, grad_trainer = (
        JAtlasTrainer(nets=nets, data=jdata_, train_opt=TRAIN_OPT,
                      larger_dim=16, num_frames=F_) for _ in range(2))
    grad_trainer.tx = optax.sgd(1.0)
    params = trainer.init_params(jax.random.PRNGKey(0))
    return trainer, params, data, grad_trainer


def _port(atlas_jax, params=None):
    """The port's trainer on the CPU with the JAX params loaded."""
    jt, jparams, data, _ = atlas_jax
    nets = {}
    for n, kw in NET_KW.items():
        nets[n] = IMLP(hidden_dim=32, mlp_layers=3, **kw)
        nets[n].load_state_dict(jax_params_to_state_dict(
            (params or jparams)[n]), strict=True)
    return AtlasTrainer(nets, data, TRAIN_OPT, larger_dim=16,
                        num_frames=F_, device='cpu')


def _jax_draws(trainer, key):
    """The coordinates the JAX step draws from `key`."""
    kx, ky, kf = jax.random.split(key, 3)
    b = TRAIN_OPT['sample_batch_size']
    return tuple(torch.from_numpy(np.asarray(jax.random.randint(
        k, (b,), 0, hi))).long() for k, hi in
        ((kx, trainer.res_x), (ky, trainer.res_y), (kf, trainer.num_frames)))


def _copy(tree):
    return jax.tree.map(jnp.copy, tree)


def _assert_params_match(port, jparams, names, grads=None, atol=1e-5):
    """Every parameter within atol. With the JAX gradients given, entries
    whose |gradient| is below 1e-6 are held to 2 lr instead: Adam's first
    step moves a weight by lr g / (|g| + 1e-8), whose slope at such g is up
    to lr / 1e-8, so there fp32 rounding of g in the last bits shows."""
    lr = TRAIN_OPT['optimizer']['lr']
    for n in names:
        sd = jax_params_to_state_dict(jparams[n])
        gd = jax_params_to_state_dict(grads[n]) if grads else {}
        for k, v in port.nets[n].state_dict().items():
            diff = np.abs(v.numpy() - sd[k].numpy())
            if k in gd:
                tiny = np.abs(gd[k].numpy()) < 1e-6
                assert diff[tiny].max(initial=0) <= 2 * lr, f'{n}.{k}'
                diff = diff[~tiny]
            assert diff.max(initial=0) <= atol, (f'{n}.{k}', diff.max())


@pytest.mark.parametrize('global_step', [3, 5, 7])
def test_atlas_step_matches_jax(atlas_jax, global_step):
    """One main step on JAX's draws, with both gates on (3), the global
    rigidity gate off (5) and both off (7): every loss term (relative
    1e-5), every gradient (1e-5 of its tensor's largest entry) and every
    parameter after the Adam step (1e-5)."""
    jt, params, _, jg = atlas_jax
    key = jax.random.PRNGKey(11)
    main = ('FG_UV_Mapping', 'BG_UV_Mapping', 'F_Alpha', 'F_Atlas')
    jp, _, jld = jt.step(_copy(params), jt.init_opt_state(_copy(params)),
                         key, global_step)
    sgd, _, _ = jg.step(_copy(params), jg.init_opt_state(_copy(params)),
                        key, global_step)
    jgrads = jax.tree.map(lambda a, b: np.asarray(a) - np.asarray(b),
                          {n: params[n] for n in main},
                          {n: sgd[n] for n in main})
    port = _port(atlas_jax)
    ld = port.step(global_step, draws=_jax_draws(jt, key))
    assert set(ld) == set(jld)
    for k in jld:
        np.testing.assert_allclose(float(ld[k]), float(jld[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    # F_Atlas (the hash grid and its scatter) and F_Alpha within 1e-5 of
    # each tensor's largest entry. The UV mappings within 3e-4: their
    # rigidity terms divide by the determinant of a random-init Jacobian
    # taken as differences of neighbouring evaluations, which amplifies the
    # frameworks' fp32 rounding (up to 1.2e-4 read on this config)
    for n in main:
        tol = 3e-4 if n.endswith('UV_Mapping') else 1e-5
        ref = jax_params_to_state_dict(jgrads[n])
        for k, p in port.nets[n].named_parameters():
            r = ref[k].numpy()
            np.testing.assert_allclose(p.grad.numpy(), r, rtol=0,
                                       atol=tol * np.abs(r).max(),
                                       err_msg=f'grad {n}.{k}')
    _assert_params_match(port, jp, main, jgrads)
    # the gated terms leave the total alone past their iteration
    gated = (global_step <= 4) * (
        5 * float(jld['global_rigidity_loss_fg'])
        + 50 * float(jld['global_rigidity_loss_bg']))
    gated += (global_step <= 6) * 2000 * float(jld['alpha_loss'])
    w = {'gradient_loss': 1000, 'rgb_loss': 5000, 'sparsity_loss': 1000,
         'rigidity_loss_fg': 1, 'rigidity_loss_bg': 1, 'flow_loss_fg': 5,
         'flow_loss_bg': 5, 'flow_alpha_loss': 49}
    np.testing.assert_allclose(
        float(ld['total_loss']),
        sum(v * float(ld[k]) for k, v in w.items()) + gated, rtol=1e-5)


def test_atlas_inverse_step_matches_jax(atlas_jax):
    jt, params, _, _ = atlas_jax
    key = jax.random.PRNGKey(12)
    opt = jt.init_opt_state(_copy(params))
    jp, _, jloss = jt.inverse_step(_copy(params), opt, key)
    port = _port(atlas_jax)
    loss = port.inverse_step(draws=_jax_draws(jt, key))
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    _assert_params_match(port, jp, ('FG_UV_Mapping_Inverse',
                                    'FG_UV_Mapping'))


def test_pretrain_mapping_lowers_loss_and_run_steps_trains(atlas_jax):
    port = _port(atlas_jax)
    gen = torch.Generator().manual_seed(0)
    xyt = port._xyt(*port.sample(gen))
    net = port.nets['FG_UV_Mapping']

    def fit():
        with torch.no_grad():
            return float(tlosses.safe_norm(xyt[:, :2] * 0.8
                                           - net(xyt)).mean())
    before = fit()
    last = port.pretrain_mapping('FG_UV_Mapping', gen, iters=8, batch=256)
    assert np.isfinite(last) and fit() < before - 0.02
    port.init_opt_state()
    first = port.run_steps(0, 1, gen)
    ld = port.run_steps(1, 20, gen)
    assert set(ld) == set(first) and 'fg_inv_loss' in ld
    assert all(np.isfinite(float(v)) for v in ld.values())
    assert float(ld['total_loss']) < float(first['total_loss'])


# -------------------------------------------------------------------- data
def test_consistency_masks_and_warp_match_jax():
    rs = np.random.RandomState(6)
    fwd = (rs.randn(12, 20, 2) * 2).astype(np.float32)
    bwd = (-fwd + rs.randn(12, 20, 2) * 0.6).astype(np.float32)
    for j, t in ((jdata.warp_flow(bwd, fwd), tdata.warp_flow(bwd, fwd)),
                 (jdata.compute_consistency(fwd, bwd),
                  tdata.compute_consistency(fwd, bwd))):
        assert t.dtype == torch.float64
        np.testing.assert_allclose(t.numpy(), j, rtol=1e-12, atol=1e-12)
    jm, tm = jdata.get_consistency_mask(fwd, bwd), \
        tdata.get_consistency_mask(_t(fwd), _t(bwd))
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(b.numpy(), a)
        assert 0 < a.mean() < 1


def test_resize_flow_matches_jax():
    flow = np.random.RandomState(7).randn(10, 14, 2).astype(np.float32)
    np.testing.assert_array_equal(tdata.resize_flow(flow, 16, 20),
                                  jdata.resize_flow(flow, 16, 20))


# ------------------------------------------------- evaluation, propagation
def test_reconstruct_video_and_psnr_match_jax(atlas_jax):
    jt, params, data, _ = atlas_jax
    port = _port(atlas_jax)
    ref = j_reconstruct_video(jt.nets, params, W_, H_, 2, jt.norm_s,
                              jt.norm_t)
    rec = reconstruct_video(port.nets, W_, H_, 2, port.norm_s, port.norm_t)
    for k, v in ref.items():
        np.testing.assert_allclose(rec[k].numpy(), v, rtol=1e-5, atol=1e-5,
                                   err_msg=k)
    np.testing.assert_allclose(
        evaluate_model(port.nets, data['video'], W_, H_, F_, port.norm_s,
                       port.norm_t),
        j_evaluate_model(jt.nets, params, data['video'], W_, H_, F_,
                         jt.norm_s, jt.norm_t), rtol=1e-5)


def test_propagate_point_sequence_matches_jax(atlas_jax):
    jt, params, _, _ = atlas_jax
    port = _port(atlas_jax)
    tracks = np.full((F_, 2, 2), 5.0, np.float32)
    args = ({'p0': [6, 5], 'p1': []}, {'p0': [8, 7]}, 1, tracks,
            {'p0': 0, 'p1': 1})
    ref = j_propagate_point_sequence(*args, *j_bind_nets(jt.nets, params),
                                     16, F_, jt.norm_s, jt.norm_t)
    out = propagate_point_sequence(*args, *bind_nets(port.nets), 16, F_,
                                   port.norm_s, port.norm_t)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    np.testing.assert_allclose(out[:, 1], 5.0)


# ----------------------------------------------------------------- builder
def test_build_atlas_nets_loads_the_published_config_strictly():
    """atlas_swan's five nets at full width: build_atlas_nets' names and
    shapes are the JAX params' (strict load), and its seeded init draws the
    hash table from U(-1e-4, 1e-4) with zero biases."""
    models = {
        'FG_UV_Mapping': dict(input_dim=3, output_dim=2, hidden_dim=256,
                              pe_type='none', mlp_layers=6),
        'BG_UV_Mapping': dict(input_dim=3, output_dim=2, hidden_dim=256,
                              pe_type='none', mlp_layers=4),
        'F_Atlas': dict(input_dim=2, output_dim=3, hidden_dim=256,
                        pe_type='hash_encoding', mlp_layers=8,
                        skip_layers=[4, 7]),
        'F_Alpha': dict(input_dim=3, output_dim=1, hidden_dim=256,
                        pe_type='encoding', pe_dim=5, mlp_layers=8),
        'FG_UV_Mapping_Inverse': dict(input_dim=3, output_dim=3,
                                      hidden_dim=256, mlp_layers=6),
    }
    from videoswap_tpu.atlas.imlp import imlp_from_opt as j_imlp_from_opt
    nets = build_atlas_nets(models, device='cpu', seed=0)
    assert list(nets) == ['FG_UV_Mapping', 'BG_UV_Mapping', 'F_Alpha',
                          'F_Atlas', 'FG_UV_Mapping_Inverse']
    for name, net in nets.items():
        jnet = j_imlp_from_opt(models[name])
        shapes = jax.eval_shape(jnet.init, jax.random.PRNGKey(0),
                                jnp.zeros((1, jnet.input_dim)))
        zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
        net.load_state_dict(jax_params_to_state_dict(zeros), strict=True)
    again = build_atlas_nets(models, device='cpu', seed=0)
    table = again['F_Atlas'].hash_table
    assert tuple(table.shape) == (16, 2 ** 19, 2)
    assert float(table.abs().max()) <= 1e-4 and float(table.std()) > 5e-5
    assert float(again['F_Alpha'].hidden_0.bias.abs().max()) == 0.0
    w = again['F_Atlas'].hidden_4.weight
    assert abs(float(w.std()) * w.shape[1] ** 0.5 - 1.0) < 0.05
    torch.testing.assert_close(
        build_atlas_nets(models, device='cpu', seed=0)['BG_UV_Mapping']
        .hidden_1.weight, again['BG_UV_Mapping'].hidden_1.weight)


def test_atlas_runs_with_jax_blocked(tmp_path):
    """The atlas path imports nothing of JAX, flax, optax, yaml, PIL or
    videoswap_tpu: with them blocked, build the nets and take one main and
    one inverse step on the CPU. Then, PIL let in (the CLIs read and write
    images with it), the three atlas CLIs run on a 3-frame 24x16 clip with
    --device cpu: flows, 2 iterations with a validation, a propagated drag,
    with JAX, flax, optax, yaml and videoswap_tpu still blocked."""
    code = textwrap.dedent(f'''
        import sys
        for m in ('jax', 'flax', 'optax', 'yaml', 'PIL'):
            sys.modules[m] = None
        sys.path.insert(0, {str(ROOT)!r})
        import numpy as np
        import torch
        torch.set_num_threads(2)   # beside the other test workers
        from videoswap_torch.atlas import data, evaluate, propagate
        from videoswap_torch.atlas.trainer import AtlasTrainer
        from videoswap_torch.builders import build_atlas_nets
        kw = {NET_KW!r}
        models = {{n: dict(k, hidden_dim=32, mlp_layers=3)
                  for n, k in kw.items()}}
        nets = build_atlas_nets(models, device='cpu', seed=0)
        rs = np.random.RandomState(0)
        f, h, w = 4, 16, 16
        clip = dict(video=rs.rand(f, h, w, 3), mask=rs.rand(f, h, w) > 0.5,
                    dx=rs.randn(f, h, w, 3), dy=rs.randn(f, h, w, 3),
                    flows=rs.randn(f, h, w, 2), flows_rev=rs.randn(f, h, w, 2))
        m = data.get_consistency_mask(clip['flows'][0], clip['flows_rev'][1])
        clip['flow_masks'] = np.ones((f, h, w))
        clip['flow_masks_rev'] = np.ones((f, h, w))
        opt = {TRAIN_OPT!r}
        tr = AtlasTrainer(nets, clip, opt, larger_dim=16, num_frames=f,
                          device='cpu')
        g = torch.Generator().manual_seed(0)
        ld = tr.step(1, g)
        inv = tr.inverse_step(g)
        assert torch.isfinite(ld['total_loss']) and torch.isfinite(inv)
        assert np.isfinite(evaluate.evaluate_model(
            tr.nets, clip['video'], w, h, 1, tr.norm_s, tr.norm_t))
        loaded = [m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'flax', 'optax', 'yaml',
                                         'PIL', 'videoswap_tpu')
                  and sys.modules[m] is not None]
        assert not loaded, loaded

        del sys.modules['PIL']
        import json
        import os
        from pathlib import Path
        from PIL import Image
        from videoswap_torch import extract_flow, train_atlas
        from videoswap_torch import propagate_point_displacement as ppd
        d = Path({str(tmp_path)!r})
        for sub in ('frames', 'masks', 'annotation'):
            (d / sub).mkdir()
        ys, xs = np.mgrid[0:16, 0:24]
        for i in range(3):
            img = np.stack([np.sin(xs * 0.5 - i) * 0.4 + 0.5,
                            ys / 16, xs / 24], -1)
            Image.fromarray((img * 255).astype(np.uint8)).save(
                d / 'frames' / f'{{i:05d}}.png')
            Image.fromarray(((xs - 8 - i) ** 2 + (ys - 8) ** 2 < 20)
                            .astype(np.uint8) * 255).save(
                d / 'masks' / f'{{i:05d}}.png')
        extract_flow.cli(['--frame_dir', str(d / 'frames'), '--out_dir',
                          str(d / 'flows'), '--method', 'lk',
                          '--device', 'cpu'])
        models = '\\n'.join(f'  {{n}}: {{json.dumps(o)}}'
                              for n, o in models.items())
        (d / 'a.yml').write_text('\\n'.join([
            'name: blocked', 'manual_seed: 1',
            f'datasets: {{{{frame_path: {{d}}/frames, mask_path: {{d}}/masks,'
            f' flow_path: {{d}}/flows, res_x: 24, res_y: 16, max_frames: 72}}}}',
            'models:', models, 'train:', '  optimizer: {{lr: 0.001}}',
            '  total_iter: 2', '  sample_batch_size: 128',
            '  pretrain_UV_mapping_iter: 1',
            f"  loss_cfg: {{json.dumps(opt['loss_cfg'])}}",
            'val: {{val_freq: 2}}',
            'logger: {{print_freq: 1, save_checkpoint_freq: 2}}']) + '\\n')
        os.chdir(d)       # the train CLI's experiment tree goes there
        train_atlas.main(['-opt', str(d / 'a.yml'), '--device', 'cpu'])
        (d / 'annotation' / '00000.json').write_text('{{"p": [8, 8]}}')
        (d / 'annotation' / 'duck.json').write_text('{{"p": [9, 10]}}')
        torch.save({{'pred_tracks': torch.zeros(3, 1, 2),
                    'point_name2id': {{'p': 0}}}},
                   d / 'annotation' / 'TAP.pth')
        out = ppd.main([
            '--atlas_config_path', str(d / 'a.yml'), '--atlas_model_path',
            str(d / 'experiments/blocked/models/models_2.pth'),
            '--source_tap_path', str(d / 'annotation/TAP.pth'),
            '--source_point_path', str(d / 'annotation/00000.json'),
            '--target_point_path', str(d / 'annotation/duck.json'),
            '--device', 'cpu'])
        assert out.endswith('TAP_duck.pth')
        loaded = [m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'flax', 'optax', 'yaml',
                                         'videoswap_tpu')
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print('ok')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')
