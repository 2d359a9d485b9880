"""The all-levels hash-grid table gradient (`hash_table_grad_levels`) on the
CPU, where it takes its plain route (each level through
`hash_table_grad_plain`), against the per-level calls, against the JAX
package's XLA scatter (`hash_table_grad_xla`, on rows with an index >= 0:
jnp's `.at[-1]` wraps to the last entry instead of dropping the row), and
the hash encoding's table gradient, now one call for all levels, against the
JAX custom VJP. fp32 throughout: the plain route and the XLA scatter sum in
another order, so they agree to 1e-6 (the values are O(1), a few rows an
entry). The kernel itself is held to these levels bit for bit on the card
(`tests/test_torch_cuda_kernels.py`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.atlas.imlp import hash_encode as j_hash_encode
from videoswap_tpu.ops.hash_table_grad import hash_table_grad_xla
from videoswap_torch.atlas.imlp import (_level_geometry, _level_resolutions,
                                        hash_encode)
from videoswap_torch.ops import hash_table_grad as thg


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _levels(seed, levels, rows, table, used, nf=2, drop=0.05):
    """idx (L, R) int32 with `drop` of the rows -1 and some past each
    level's used entries, val (L, R, F) fp32."""
    rs = np.random.RandomState(seed)
    idx = np.stack([rs.randint(0, min(table, n + n // 8 + 1), rows)
                    for n in used]).astype(np.int32)
    idx[rs.rand(levels, rows) < drop] = -1
    val = rs.randn(levels, rows, nf).astype(np.float32)
    return idx, val


@pytest.mark.parametrize('levels,rows,table,used', [
    (3, 4096, 2048, [289, 2048, 1000]),
    (16, 1500, 1024, [289, 529, 961] + [1024] * 13),
    (1, 7, 16, [16]),
    (2, 3000, 300, [300, 5]),
])
def test_levels_plain_matches_per_level_calls_and_jax(levels, rows, table,
                                                      used):
    idx, val = _levels(levels * rows, levels, rows, table, used)
    out = thg.hash_table_grad_levels(torch.from_numpy(idx),
                                     torch.from_numpy(val), used,
                                     torch.zeros((levels, table, 2)))
    assert out.shape == (levels, table, 2)
    for lv, n in enumerate(used):
        one = thg.hash_table_grad(torch.from_numpy(idx[lv]),
                                  torch.from_numpy(val[lv]), n)
        assert torch.equal(out[lv, :n], one)
        assert not out[lv, n:].any()
        keep = idx[lv] >= 0
        ref = hash_table_grad_xla(jnp.asarray(idx[lv][keep]),
                                  jnp.asarray(val[lv][keep].T), n)
        np.testing.assert_allclose(out[lv, :n].numpy(), np.asarray(ref),
                                   rtol=1e-6, atol=1e-6)


def test_levels_plain_accumulates_into_out_and_drops_a_level():
    """out is added to, not overwritten; a level whose rows are all dropped
    keeps out's entries."""
    used = [64, 128, 128]
    idx, val = _levels(7, 3, 2000, 128, used)
    idx[1] = -1
    base = np.random.RandomState(8).randn(3, 128, 2).astype(np.float32)
    out = thg.hash_table_grad_levels(torch.from_numpy(idx),
                                     torch.from_numpy(val), used,
                                     torch.from_numpy(base.copy()))
    fresh = thg.hash_table_grad_levels(torch.from_numpy(idx),
                                       torch.from_numpy(val), used,
                                       torch.zeros((3, 128, 2)))
    np.testing.assert_array_equal(out[1].numpy(), base[1])
    np.testing.assert_allclose(out.numpy(), base + fresh.numpy(), rtol=1e-6,
                               atol=1e-6)


def test_levels_plain_matches_the_fixed_point_arithmetic():
    """The plain route (fp32 index_add_) and the kernel's arithmetic stated
    in PyTorch (`hash_table_grad_fixed`, a level at a time) agree to the
    fixed point's rounding, at the atlas's geometry of 16 levels."""
    res = _level_resolutions(16, 16, 1.38)
    x = torch.from_numpy(np.random.RandomState(9).uniform(
        -0.7, 0.7, (3000, 2)).astype(np.float32))
    idx, u, v, _ = _level_geometry(x, res, 2 ** 12)
    idx = idx.to(torch.int32).reshape(16, -1)
    val = ((u * v)[..., None] * torch.from_numpy(np.random.RandomState(
        10).randn(16, 1, 3000, 2).astype(np.float32))).reshape(16, -1, 2)
    used = [min((r + 1) ** 2, 2 ** 12) for r in res]
    out = thg.hash_table_grad_levels(idx, val, used,
                                     torch.zeros((16, 2 ** 12, 2)))
    for lv, n in enumerate(used):
        fixed = thg.hash_table_grad_fixed(idx[lv], val[lv], n)
        scale = float(fixed.abs().max())
        assert float((out[lv, :n] - fixed).abs().max()) <= 1e-6 * scale


def test_hash_encode_table_gradient_matches_jax_at_sixteen_levels():
    """d_table of the hash encoding (one levels call in the backward)
    against the JAX custom VJP at the atlas's 16 levels, a 2^10 table (levels
    0-2 dense, 3-15 hashed) and coordinates in [-1.5, 1.5]."""
    rs = np.random.RandomState(11)
    n, levels, t = 300, 16, 1024
    x = rs.uniform(-1.5, 1.5, (n, 2)).astype(np.float32)
    table = (rs.randn(levels, t, 2) * 1e-2).astype(np.float32)
    cot = rs.randn(n, levels * 2).astype(np.float32)

    def j_loss(table):
        return jnp.vdot(j_hash_encode(jnp.asarray(x), table,
                                      custom_vjp=True), cot)

    ref = jax.jit(jax.grad(j_loss))(jnp.asarray(table))
    tt = torch.from_numpy(table).requires_grad_()
    (hash_encode(torch.from_numpy(x), tt)
     * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(tt.grad.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_levels_refuses_what_the_kernel_does_not_take_before_launching():
    """The argument checks run before any launch (on the CPU too, where they
    guard the kernel's route): a used count past the table, a count for
    each level, matching shapes."""
    idx = torch.zeros(2, 8, dtype=torch.int32)
    val = torch.zeros(2, 8, 2)
    out = torch.zeros(2, 16, 2)
    for used, o in (([16, 17], out), ([16], out), ([16, 16], out[:1]),
                    ([0, 16], out)):
        with pytest.raises(ValueError):
            thg._check_kernel_args(idx, val, used, o)
    with pytest.raises(TypeError):
        thg._check_kernel_args(idx.long(), val, [16, 16], out)
    thg._check_kernel_args(idx, val, [16, 3], out)
