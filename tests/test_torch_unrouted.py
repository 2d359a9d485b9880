"""Parity of the port's two unrouted ops with the JAX package, on the CPU.

- `ops/spatial_attention.py` against videoswap_tpu/ops/spatial_attention.py:
  the plain version against the Pallas kernel run in interpret mode
  (`_forward`) and against `_xla_reference` (softmax attention), fp32 and
  bf16; inputs whose scaled logits pass the 60 clip (the plain version is
  the kernel's function, which is not softmax there); S = 2304, where the
  TPU kernel drops the keys past its last whole 2048-key block and the port
  does not; the autograd Function's gradients against `jax.grad`; the gate.
- `ops/gn_silu_conv.py` against scripts/bench_resnet_fused.py: the plain
  version against `xla_gn_silu_conv` everywhere and against the interpret
  `fused_gn_silu_conv` in the interior and on the border, in bf16; with
  some gamma = 0, where the TPU kernel's padding trick breaks, against
  `xla_gn_silu_conv` only; the JAX HWIO kernel carried to OIHW by the
  converter; the port's ResnetBlock3D against the plain version fed the
  video's statistics; the CUDA kernel's arithmetic on its tiling (`plan`,
  `pack_weight`) against the plain version in fp32.

The same numpy inputs go to both sides. Tolerances: fp32 attention 1e-5
(exp and sums in another order, outputs O(1)); bf16 outputs are held to
one bf16 ulp of the largest output, 2^-7 max|ref|, where the two sides do
the same roundings in fp32 sums of another order, and to 1e-2 against
`_xla_reference`, which rounds the normalised probabilities to bf16
instead of the unnormalised exponentials.
"""

import importlib.util
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.ops import spatial_attention as jsa
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.models.resnet3d import ResnetBlock3D
from videoswap_torch.ops import gn_silu_conv as tgc
from videoswap_torch.ops import spatial_attention as tsa

BF16_ULP = 2.0 ** -7     # one bf16 ulp, relative to the largest output
TOL_F32 = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def bench():
    """scripts/bench_resnet_fused.py, imported by path. At import it makes
    a cache directory and sets JAX's persistent-cache options for the whole
    process: the directory is not made, and both options are put back."""
    names = ('jax_compilation_cache_dir',
             'jax_persistent_cache_min_compile_time_secs')
    saved = {n: getattr(jax.config, n) for n in names}
    path = Path(__file__).resolve().parents[1] / 'scripts' \
        / 'bench_resnet_fused.py'
    spec = importlib.util.spec_from_file_location('bench_resnet_fused', path)
    mod = importlib.util.module_from_spec(spec)
    try:
        with mock.patch('os.makedirs'):
            spec.loader.exec_module(mod)
    finally:
        for n, v in saved.items():
            jax.config.update(n, v)
    return mod


def _np(x):
    return np.asarray(x, np.float32)


def _both(arrays, jdtype, tdtype):
    return ([jnp.asarray(a, jdtype) for a in arrays],
            [torch.from_numpy(a).to(tdtype) for a in arrays])


@pytest.mark.parametrize('jdtype,tdtype', [(jnp.float32, torch.float32),
                                           (jnp.bfloat16, torch.bfloat16)],
                         ids=['fp32', 'bf16'])
def test_spatial_plain_matches_jax(jdtype, tdtype):
    rs = np.random.RandomState(0)
    arrays = [rs.randn(2, 256, 8 * 40).astype(np.float32) for _ in range(3)]
    (q, k, v), tq = _both(arrays, jdtype, tdtype)
    out = tsa.spatial_self_attention(*tq, 8)
    assert out.dtype == tdtype and out.shape == (2, 256, 320)
    out = out.float().numpy()
    kern = _np(jsa._forward(q, k, v, 8, interpret=True))
    ref = _np(jsa._xla_reference(q, k, v, 8))
    if jdtype == jnp.float32:
        np.testing.assert_allclose(out, kern, atol=TOL_F32)
        np.testing.assert_allclose(out, ref, atol=TOL_F32)
    else:
        assert np.abs(out - kern).max() <= BF16_ULP * np.abs(kern).max()
        assert np.abs(out - ref).max() <= 1e-2


def test_spatial_plain_follows_the_kernel_past_the_clip():
    """q = k ~ N(0, 36), d = 8: the scaled logits reach ~100 on the
    diagonal and are clipped at 60, so the kernel's function is not softmax
    there; the plain version computes the kernel's."""
    rs = np.random.RandomState(1)
    qk = (rs.randn(1, 256, 16) * 6).astype(np.float32)
    v = rs.randn(1, 256, 16).astype(np.float32)
    (jq, jv), (tq, tv) = _both([qk, v], jnp.float32, torch.float32)
    out = tsa.spatial_self_attention(tq, tq, tv, 2).numpy()
    np.testing.assert_allclose(
        out, _np(jsa._forward(jq, jq, jv, 2, interpret=True)), atol=TOL_F32)
    assert np.abs(out - _np(jsa._xla_reference(jq, jq, jv, 2))).max() > 1.0


def test_spatial_attends_every_key_past_2048():
    """S = 2304: the TPU kernel's key loop covers one 2048-key block and
    drops the last 256 keys; the port attends over all of them, as
    `_xla_reference` does."""
    rs = np.random.RandomState(2)
    arrays = [rs.randn(1, 2304, 2 * 40).astype(np.float32) for _ in range(3)]
    (q, k, v), tq = _both(arrays, jnp.float32, torch.float32)
    out = tsa.spatial_self_attention(*tq, 2).numpy()
    np.testing.assert_allclose(out, _np(jsa._xla_reference(q, k, v, 2)),
                               atol=TOL_F32)
    kern = _np(jsa._forward(q, k, v, 2, interpret=True))
    assert np.abs(out - kern).max() > 1e-2      # the reference's defect


def test_spatial_gradients_match_jax():
    rs = np.random.RandomState(3)
    arrays = [rs.randn(1, 256, 4 * 24).astype(np.float32) for _ in range(4)]
    (q, k, v, dout), (tq, tk, tv, tdout) = _both(arrays, jnp.float32,
                                                 torch.float32)
    _, vjp = jax.vjp(lambda *a: jsa.spatial_self_attention(*a, 4), q, k, v)
    refs = vjp(dout)
    xs = [t.requires_grad_() for t in (tq, tk, tv)]
    grads = torch.autograd.grad(tsa.spatial_self_attention(*xs, 4), xs, tdout)
    for g, r in zip(grads, refs):
        r = _np(r)
        assert np.abs(g.numpy() - r).max() <= 1e-4 * np.abs(r).max()


def test_spatial_supported_matches_jax():
    cases = [((1, 256, 320), (1, 256, 320), 8),
             ((2, 4096, 320), (2, 4096, 320), 8),
             ((1, 256, 320), (1, 77, 320), 8),       # cross-attention
             ((1, 100, 320), (1, 100, 320), 8),      # not a multiple of 256
             ((1, 256, 512), (1, 256, 512), 2),      # head dim 256
             ((1, 256, 1280), (1, 256, 1280), 10),   # head dim 128
             ((1, 256, 320), (1, 256, 320), 7)]      # C not split by heads
    for qs, ks, heads in cases:
        assert tsa.supported(torch.zeros(qs), torch.zeros(ks), heads) == \
            jsa.supported(jnp.zeros(qs), jnp.zeros(ks), heads), (qs, ks, heads)


def _conv_inputs(seed, gamma_zero):
    rs = np.random.RandomState(seed)
    n, h, w, c, cout = 2, 16, 8, 64, 64
    x = rs.randn(n, h, w, c).astype(np.float32)
    gamma = (rs.rand(c) + 0.5).astype(np.float32)
    beta = (rs.randn(c) * 0.1).astype(np.float32)
    if gamma_zero:
        gamma[:8] = 0.0
        beta[:8] = rs.randn(8).astype(np.float32)
    hwio = (rs.randn(3, 3, c, cout) / np.sqrt(9 * c)).astype(np.float32)
    bias = (rs.randn(cout) * 0.01).astype(np.float32)
    # bf16 values on both sides: the benchmark's types
    x, hwio = (_np(jnp.asarray(a, jnp.bfloat16)) for a in (x, hwio))
    return x, gamma, beta, hwio, bias


@pytest.mark.parametrize('gamma_zero', [False, True])
def test_conv_plain_matches_jax(bench, gamma_zero):
    """In bf16: against `xla_gn_silu_conv` everywhere; against the Pallas
    kernel (interpret mode) in the interior, and on the border within the
    activation of its pad value (rounded to bf16, it activates to ~1e-2
    instead of 0), except with gamma = 0, where that pad value is 0 and
    the ring activates to silu(beta)."""
    x, gamma, beta, hwio, bias = _conv_inputs(4, gamma_zero)
    jargs = (jnp.asarray(x, jnp.bfloat16), jnp.asarray(gamma),
             jnp.asarray(beta), jnp.asarray(hwio, jnp.bfloat16),
             jnp.asarray(bias))
    weight = jax_params_to_state_dict({'conv': {'kernel': hwio}})[
        'conv.weight']
    out = tgc.fused_gn_silu_conv(
        torch.from_numpy(x).bfloat16(), torch.from_numpy(gamma),
        torch.from_numpy(beta), weight, torch.from_numpy(bias), groups=32)
    assert out.dtype == torch.bfloat16 and out.shape == (2, 16, 8, 64)
    out = out.float().numpy()
    ref = _np(bench.xla_gn_silu_conv(*jargs))
    ulp = BF16_ULP * np.abs(ref).max()
    assert np.abs(out - ref).max() <= ulp
    kern = _np(bench.fused_gn_silu_conv(*jargs, interpret=True))
    inner = np.abs(out - kern)[:, 1:-1, 1:-1]
    border = np.abs(out - kern)
    border[:, 1:-1, 1:-1] = 0
    assert inner.max() <= ulp
    if gamma_zero:
        assert border.max() > 0.1                    # the reference's defect
    else:
        assert border.max() <= 3e-2


def test_conv_weights_carried_across(bench):
    """A flax HWIO conv kernel becomes torch's OIHW through the converter's
    rank-4 transpose, and the plain convolution with it equals JAX's
    (the GroupNorm taken out: scale 1, shift 0, on a bf16 activation)."""
    x, _, _, hwio, bias = _conv_inputs(5, False)
    sd = jax_params_to_state_dict({'conv1': {'kernel': hwio, 'bias': bias}})
    weight = sd['conv1.weight']
    np.testing.assert_array_equal(weight.numpy(), hwio.transpose(3, 2, 0, 1))
    a = jax.nn.silu(jnp.asarray(x)).astype(jnp.bfloat16)
    ref = jax.lax.conv_general_dilated(
        a.astype(jnp.float32), jnp.asarray(hwio), (1, 1), ((1, 1), (1, 1)),
        dimension_numbers=('NHWC', 'HWIO', 'NHWC')) + bias
    n, c = x.shape[0], x.shape[-1]
    out = tgc.gn_silu_conv_plain(torch.from_numpy(x), torch.ones(n, c),
                                 torch.zeros(n, c), weight, sd['conv1.bias'])
    np.testing.assert_allclose(out.numpy(), _np(ref), atol=TOL_F32)


@pytest.mark.parametrize('n,h,w,cin,cout', [
    (2, 7, 5, 16, 8), (1, 20, 30, 32, 24), (1, 9, 136, 48, 16)])
def test_conv_packed_weight_on_the_kernel_tiling(n, h, w, cin, cout):
    """In fp32: the kernel's arithmetic on its own tiling equals
    gn_silu_conv_plain. For each column segment of `plan`, the activation,
    zero-padded after the SiLU, is flattened at pitch pw; virtual row v
    takes tap (dy, dx) from position v + dy pw + dx, and its nine taps' Cin
    channels, in that order, meet `pack_weight`'s (Cout, 9 Cin) rows. The
    tiles' rows that are pixels cover the image: one segment, several
    tiles with a partly full last one, and three segments of 46 columns."""
    rs = np.random.RandomState(n * h + w)
    x = torch.from_numpy(rs.randn(n, h, w, cin).astype(np.float32))
    scale = torch.from_numpy((rs.rand(n, cin) + 0.5).astype(np.float32))
    shift = torch.from_numpy((rs.randn(n, cin) * 0.3).astype(np.float32))
    weight = torch.from_numpy((rs.randn(cout, cin, 3, 3)
                               / np.sqrt(9 * cin)).astype(np.float32))
    weight = weight.bfloat16().float()             # the kernel's weights
    bias = torch.from_numpy((rs.randn(cout) * 0.1).astype(np.float32))
    ref = tgc.gn_silu_conv_plain(x, scale, shift, weight, bias)
    a = torch.nn.functional.silu(x * scale[:, None, None]
                                 + shift[:, None, None]).bfloat16().float()
    wk = tgc.pack_weight(weight).float().reshape(cout, 9 * cin)
    tw, pw, segments, tiles = tgc.plan(h, w)
    assert tw <= tgc.SEGMENT_MAX and (segments - 1) * tw < w <= segments * tw
    rows = tiles * tgc.ROWS
    assert (tiles - 1) * tgc.ROWS < h * pw <= rows
    v = torch.arange(rows)
    taps = torch.tensor([dy * pw + dx for dy in range(3) for dx in range(3)])
    out = torch.full_like(ref, float('nan'))
    for s in range(segments):
        x0 = s * tw
        lo, hi = max(x0 - 1, 0), min(x0 + tw + 1, w)
        img = torch.zeros(n, h + 2, pw, cin)
        img[:, 1:h + 1, lo - x0 + 1:hi - x0 + 1] = a[:, :, lo:hi]
        halo = torch.zeros(n, rows + 2 * pw + 2, cin)
        halo[:, :(h + 2) * pw] = img.reshape(n, -1, cin)
        k = halo[:, v[:, None] + taps[None, :]].reshape(n, rows, 9 * cin)
        res = k @ wk.T + bias
        y, xv = v // pw, v % pw
        keep = (y < h) & (xv < tw) & (x0 + xv < w)
        out[:, y[keep], x0 + xv[keep]] = res[:, keep]
    assert not torch.isnan(out).any()
    torch.testing.assert_close(out, ref, atol=TOL_F32, rtol=0)


def test_resnet_block_first_half_is_the_plain_conv_with_video_statistics():
    """The port's ResnetBlock3D takes its GroupNorm statistics over each
    video's (F, H, W). conv1(silu(norm1(x))) in fp32 equals the plain
    version fed those statistics repeated over the frames, within the bf16
    rounding of the activation (relative L2 <= 4e-3); per-frame statistics
    would be 10x off, since the frames are offset from one another."""
    torch.manual_seed(0)
    blk = ResnetBlock3D(64, 32, None, groups=8)
    with torch.no_grad():
        for p in blk.parameters():
            p.add_(torch.randn(p.shape) * 0.1)
    b, f, h, w, c = 2, 3, 8, 8, 64
    rs = np.random.RandomState(6)
    x = torch.from_numpy((rs.randn(b, f, h, w, c)
                          + rs.randn(b, f, 1, 1, c) * 2).astype(np.float32))
    with torch.no_grad():
        ref = blk.conv1(torch.nn.functional.silu(blk.norm1(x)))
    frames = x.reshape(b * f, h, w, c)

    def rel(scale, shift):
        out = tgc.gn_silu_conv_plain(frames, scale, shift, blk.conv1.weight,
                                     blk.conv1.bias).reshape(ref.shape)
        return float((out - ref).norm() / ref.norm())

    video = tgc.gn_scale_shift(*tgc.gn_stats(x.reshape(b, f * h, w, c), 8,
                                             blk.norm1.eps),
                               blk.norm1.weight, blk.norm1.bias)
    with torch.no_grad():
        err = rel(*(t.repeat_interleave(f, dim=0) for t in video))
        per_frame = rel(*tgc.gn_scale_shift(
            *tgc.gn_stats(frames, 8, blk.norm1.eps), blk.norm1.weight,
            blk.norm1.bias))
    assert err <= 4e-3
    assert per_frame > 10 * 4e-3
