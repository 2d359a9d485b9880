"""The port's CUDA kernels against their plain PyTorch versions, on the
card, and the default device of `build_models`. These tests import nothing
of JAX, so they run on the GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda_kernels.py -q

(`--noconftest` because the suite's conftest.py configures JAX). Without a
CUDA device every test skips: the kernels have no CPU mode.

Tolerances: the bf16 kernel against the fp32 plain version on the same
bf16 inputs; outputs of O(1) are rounded once to bf16 (2^-8 relative), plus
the kernel's bf16 rounding of the gated product (GEGLU) or of the
probabilities (flash). The flash backward's gradients are far from O(1), so
their error is taken relative to the largest |plain| entry (1e-2: bf16
rounding of P, dS and the output, summed over keys or queries). The fused
temporal transformer's output (x + the module, O(1) to O(3)) passes through
about ten bf16 roundings of its intermediates and is held to 5e-2. The
hash-grid scatter is fp32 on both sides: its atomics only reorder each
entry's sum, so it is held to 1e-5 of the largest |plain| entry.
"""

import numpy as np
import pytest
import torch

from videoswap_torch.ops import flash_attention as tfa
from videoswap_torch.ops import fused_temporal as tft
from videoswap_torch.ops import geglu_ffn as tgf
from videoswap_torch.ops import hash_table_grad as thg
from videoswap_torch.ops import temporal_attention as tta

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device: the kernels have no CPU mode')
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device('cuda')


def _randn(shape, seed, scale=1.0):
    rs = np.random.RandomState(seed)
    return torch.from_numpy((rs.randn(*shape) * scale).astype(np.float32))


@pytest.mark.parametrize('n,c', [(1000, 320), (300, 640), (100, 1280),
                                 (77, 64), (50, 128), (40, 1152)])
def test_geglu_kernel_matches_plain(cuda, n, c):
    args = [_randn((n, c), 0, 0.5), _randn((8 * c, c), 1, c ** -0.5),
            _randn((8 * c,), 2, 0.1), _randn((c, 4 * c), 3, (4 * c) ** -0.5),
            _randn((c,), 4, 0.1)]
    args = [a.to(cuda).bfloat16() for a in args]
    before = tgf.launches
    out = tgf.geglu_ffn(*args)
    assert tgf.launches == before + 1
    ref = tgf.geglu_ffn_plain(*(a.float() for a in args))
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 3e-2


@pytest.mark.parametrize('el,f,h,c', [(37, 16, 8, 320), (9, 24, 8, 1280),
                                      (5, 32, 4, 64), (3, 2, 1, 512)])
def test_temporal_kernel_matches_plain(cuda, el, f, h, c):
    q, k, v = (_randn((el * f, c), s).to(cuda).bfloat16() for s in range(3))
    before = tta.launches
    out = tta.temporal_attention(q, k, v, h, f)
    assert tta.launches == before + 1
    ref = tta.temporal_attention_plain(q.float(), k.float(), v.float(), h, f)
    assert (out.float() - ref).abs().max().item() < 1e-2


@pytest.mark.parametrize('sq,sk,d', [(300, 77, 40), (257, 257, 80),
                                     (64, 64, 160), (1, 5, 8), (130, 77, 128)])
def test_flash_kernel_matches_plain(cuda, sq, sk, d):
    q = _randn((2, sq, 8, d), 1).to(cuda).bfloat16()
    k, v = (_randn((2, sk, 8, d), s).to(cuda).bfloat16() for s in (2, 3))
    before = tfa.launches
    out, lse = tfa.flash_attention_fwd(q, k, v)
    assert tfa.launches == before + 1
    ref, lse_ref = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() < 1e-2
    assert (lse - lse_ref).abs().max().item() < 1e-2


def test_flash_kernel_reads_heads_by_stride(cuda):
    """q/k/v as (B, S, H, D) views of merged-head projections, and a
    non-contiguous batch slice: the kernel takes the strides as they are."""
    qkv = _randn((2, 100, 3 * 4 * 40), 5).to(cuda).bfloat16()
    q, k, v = (t.view(2, 100, 4, 40) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    out, _ = tfa.flash_attention_fwd(q, k, v)
    ref, _ = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() < 1e-2


def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.zeros(4, 64, device=cuda)                      # fp32
    with pytest.raises(TypeError):
        tgf.geglu_ffn(x, torch.zeros(512, 64, device=cuda),
                      torch.zeros(512, device=cuda),
                      torch.zeros(64, 256, device=cuda),
                      torch.zeros(64, device=cuda))
    xb = torch.zeros(4, 960, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # C = 960
        tgf.geglu_ffn(xb, torch.zeros(7680, 960, device=cuda).bfloat16(),
                      torch.zeros(7680, device=cuda).bfloat16(),
                      torch.zeros(960, 3840, device=cuda).bfloat16(),
                      torch.zeros(960, device=cuda).bfloat16())
    for d in (36, 104, 136, 168):       # d % 8 != 0, or no case for its pad
        q = torch.zeros(1, 8, 2, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            tfa.flash_attention_fwd(q, q, q)
    r = torch.zeros(33 * 4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # F > 32
        tta.temporal_attention(r, r, r, 4, 33)


def _close(out, ref, tol=1e-2):
    """max |out - ref| <= tol * max |ref|."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


@pytest.mark.parametrize('sq,sk,d', [(300, 77, 40), (257, 257, 80),
                                     (64, 64, 160), (1, 5, 8), (130, 77, 128),
                                     (200, 130, 40)])
def test_flash_backward_kernels_match_plain(cuda, sq, sk, d):
    q = _randn((2, sq, 8, d), 1).to(cuda).bfloat16()
    k, v = (_randn((2, sk, 8, d), s).to(cuda).bfloat16() for s in (2, 3))
    dout = _randn((2, sq, 8, d), 4).to(cuda).bfloat16()
    out, lse = tfa.flash_attention_fwd(q, k, v)
    before = (tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    assert (tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == (before[0] + 1,
                                                           before[1] + 1)
    ref = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float())
    for g, r, name in zip(grads, ref, 'qkv'):
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert _close(g, r), f'd{name}'


def test_flash_backward_reads_heads_by_stride(cuda):
    qkv = _randn((2, 100, 3 * 4 * 40), 5).to(cuda).bfloat16()
    q, k, v = (t.view(2, 100, 4, 40) for t in qkv.chunk(3, dim=-1))
    dout = _randn((2, 100, 4, 40), 6).to(cuda).bfloat16()
    out, lse = tfa.flash_attention_fwd(q, k, v)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    ref = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float())
    for g, r in zip(grads, ref):
        assert _close(g, r)


def _grads_match_plain(fn, plain, args, dout):
    """Autograd through the wrapper (kernel forward) against autograd
    through the fp32 plain version; the output must not be detached."""
    xs = [a.detach().requires_grad_() for a in args]
    out = fn(*xs)
    assert out.grad_fn is not None, 'detached output'
    grads = torch.autograd.grad(out, xs, dout)
    refs = [a.detach().float().requires_grad_() for a in args]
    ref = torch.autograd.grad(plain(*refs), refs, dout.float())
    for g, r in zip(grads, ref):
        assert _close(g, r, 2e-2)


def test_wrappers_are_differentiable_on_the_card(cuda):
    c = 320
    geglu = [_randn((300, c), 0, 0.5), _randn((8 * c, c), 1, c ** -0.5),
             _randn((8 * c,), 2, 0.1), _randn((c, 4 * c), 3, (4 * c) ** -0.5),
             _randn((c,), 4, 0.1)]
    geglu = [a.to(cuda).bfloat16() for a in geglu]
    _grads_match_plain(tgf.geglu_ffn, tgf.geglu_ffn_plain, geglu,
                       _randn((300, c), 5).to(cuda).bfloat16())
    qkv = [_randn((37 * 16, c), s).to(cuda).bfloat16() for s in range(3)]
    _grads_match_plain(lambda *t: tta.temporal_attention(*t, 8, 16),
                       lambda *t: tta.temporal_attention_plain(*t, 8, 16),
                       qkv, _randn((37 * 16, c), 6).to(cuda).bfloat16())
    q = _randn((2, 130, 8, 40), 7).to(cuda).bfloat16()
    k, v = (_randn((2, 77, 8, 40), s).to(cuda).bfloat16() for s in (8, 9))
    before = tfa.bwd_dkv_launches
    _grads_match_plain(tfa.flash_attention,
                       lambda *t: tfa.flash_attention_plain(*t)[0],
                       [q, k, v], _randn((2, 130, 8, 40), 10).to(cuda)
                       .bfloat16())
    assert tfa.bwd_dkv_launches == before + 1


def test_backward_refuses_what_it_does_not_take(cuda):
    q = torch.zeros(1, 8, 2, 40, device=cuda)                # fp32
    lse = torch.zeros(2, 8, device=cuda)
    with pytest.raises(TypeError):
        tfa.flash_attention_bwd(q, q, q, q, lse, q)
    for d in (36, 104):
        qb = torch.zeros(1, 8, 2, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            tfa.flash_attention_bwd(qb, qb, qb, qb, lse, qb)
    qb = torch.zeros(1, 8, 2, 40, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # fp32 dO
        tfa.flash_attention_bwd(qb, qb, qb, qb, lse, qb.float())


def test_build_models_defaults_to_the_card(cuda):
    from videoswap_torch.builders import build_models
    built = build_models({
        'unet': {'unet_cfg': dict(block_out_channels=(16, 32, 32, 32),
                                  attention_head_dim=4,
                                  cross_attention_dim=24, norm_num_groups=8,
                                  motion_heads=4)},
        'vae_cfg': dict(block_out_channels=(8, 8, 16, 16), norm_groups=8),
        'text_encoder_cfg': dict(hidden_size=24, num_layers=1, num_heads=4,
                                 intermediate_size=32),
        'adapter': {'adapter_cfg': dict(embedding_channels=12,
                                        channels=(16, 32, 32, 32),
                                        mid_dim=8)}})
    for name in ('unet', 'vae', 'text_encoder', 'adapter'):
        m = built[name]
        assert all(t.is_cuda for t in (*m.parameters(), *m.buffers())), name


@pytest.mark.parametrize('rows,entries', [(240000, 289), (240000, 529),
                                          (5000, 23409), (100001, 524288),
                                          (1, 7), (4099, 300)])
def test_hash_table_grad_kernel_matches_plain(cuda, rows, entries):
    """Both kernel forms (shared-memory table for small tables with many
    rows an entry, device-memory atomics otherwise), dropped rows, and row
    counts that are not a multiple of the 256-row block."""
    rs = np.random.RandomState(entries)
    idx = torch.from_numpy(rs.randint(-1, entries, rows).astype(np.int32))
    val = _randn((rows, 2), 1)
    idx, val = idx.to(cuda), val.to(cuda)
    ref = thg.hash_table_grad_plain(idx, val, entries)
    before = thg.launches
    out = thg.hash_table_grad(idx, val, entries)
    assert thg.launches == before + 1 and out.dtype == torch.float32
    assert _close(out, ref, 1e-5)
    for mode in ('global', 'shared') if entries * 8 <= 48 * 1024 else ():
        acc = torch.ones((entries, 2), device=cuda)
        thg._launch(idx, val, acc, mode)
        assert _close(acc - 1, ref, 1e-5), mode
    one = _randn((rows, 1), 2).to(cuda)                     # F = 1
    assert _close(thg.hash_table_grad(idx, one, entries),
                  thg.hash_table_grad_plain(idx, one, entries), 1e-5)


def test_hash_table_grad_kernel_refuses_what_it_does_not_take(cuda):
    idx = torch.zeros(8, dtype=torch.int32, device=cuda)
    val = torch.zeros(8, 2, device=cuda)
    with pytest.raises(TypeError):
        thg.hash_table_grad(idx, val.bfloat16(), 16)
    with pytest.raises(TypeError):
        thg.hash_table_grad(idx.long(), val, 16)
    with pytest.raises(ValueError):
        thg.hash_table_grad(idx, torch.zeros(2, 8, device=cuda).t(), 16)
    with pytest.raises(ValueError):
        thg.hash_table_grad(idx, val, 16, out=torch.zeros(15, 2,
                                                          device=cuda))


def test_hash_encode_gradients_on_the_card_match_the_cpu(cuda):
    from videoswap_torch.atlas.imlp import hash_encode
    rs = np.random.RandomState(3)
    x = torch.from_numpy(rs.uniform(-1.5, 1.5, (3000, 2)).astype(np.float32))
    table = _randn((6, 2 ** 12, 2), 4, 1e-2)
    cot = _randn((3000, 12), 5)
    grads = []
    for dev in (cuda, torch.device('cpu')):
        xs, ts = (t.to(dev).requires_grad_() for t in (x, table))
        out = hash_encode(xs, ts)
        grads.append((out.detach().cpu(),
                      *torch.autograd.grad(out, (xs, ts), cot.to(dev))))
    before = thg.launches
    hash_encode(x.to(cuda), table.to(cuda).requires_grad_()).sum().backward()
    assert thg.launches == before + 6                      # one a level
    for g, r in zip(*grads):
        assert _close(g.cpu(), r, 1e-5)


def test_build_atlas_nets_defaults_to_the_card(cuda):
    from videoswap_torch.builders import build_atlas_nets
    nets = build_atlas_nets({'F_Atlas': dict(
        input_dim=2, output_dim=3, hidden_dim=32, pe_type='hash_encoding',
        mlp_layers=3, n_levels=4, log2_hashmap_size=10)})
    assert all(p.is_cuda for p in nets['F_Atlas'].parameters())


def _fused_args(c, heads, f, rows_shape, include_ffn, seed, device):
    """Random (g, x, pe, flat) for the fused temporal kernel: bf16
    activations and matrices, fp32 vectors, weights on a c^-1/2 scale."""
    rs = np.random.RandomState(seed)

    def t(shape, scale, dtype=torch.bfloat16):
        return torch.from_numpy((rs.randn(*shape) * scale).astype(
            np.float32)).to(device, dtype)

    g, x = t(rows_shape, 1.0), t(rows_shape, 1.0)
    pe = t((f, c), 0.5)
    flat = [t((c, c), c ** -0.5), t((c,), 0.1, torch.float32)]
    for _ in range(2):
        flat += [1.0 + t((c,), 0.1, torch.float32), t((c,), 0.1, torch.float32)]
        flat += [t((c, c), c ** -0.5) for _ in range(4)]
        flat += [t((c,), 0.1, torch.float32)]
    if include_ffn:
        flat += [1.0 + t((c,), 0.1, torch.float32), t((c,), 0.1, torch.float32),
                 t((8 * c, c), c ** -0.5), t((8 * c,), 0.1, torch.float32),
                 t((c, 4 * c), (4 * c) ** -0.5), t((c,), 0.1, torch.float32),
                 t((c, c), c ** -0.5), t((c,), 0.1, torch.float32)]
    return g, x, pe, flat


def _f32(flat):
    return [p.float() for p in flat]


@pytest.mark.parametrize('locs,f,c,heads,include_ffn', [
    (37, 16, 320, 8, True), (21, 16, 640, 8, False), (13, 8, 64, 2, True),
    (11, 24, 128, 4, False), (5, 20, 320, 8, True), (9, 16, 640, 8, True)])
def test_fused_temporal_kernel_matches_plain(cuda, locs, f, c, heads,
                                             include_ffn):
    g, x, pe, flat = _fused_args(c, heads, f, (locs * f, c), include_ffn, 0,
                                 cuda)
    before = tft.launches
    out = tft.fused_temporal_transformer(g, x, pe, flat, heads, f,
                                         include_ffn=include_ffn)
    assert tft.launches == before + 1
    ref = tft.fused_temporal_plain(g.float(), x.float(), pe.float(),
                                   _f32(flat), heads, f, 1, include_ffn)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() < 5e-2


@pytest.mark.parametrize('b,f,hw,c,include_ffn', [
    (2, 16, 37, 320, True), (2, 16, 13, 640, False), (1, 8, 9, 64, True)])
def test_fused_temporal_frame_major_kernel_matches_plain(cuda, b, f, hw, c,
                                                         include_ffn):
    g, x, pe, flat = _fused_args(c, 8, f, (b, f, hw, c), include_ffn, 1,
                                 cuda)
    before = tft.bfhw_launches
    out = tft.fused_temporal_transformer_bfhw(g, x, pe, flat, 8, f,
                                              include_ffn=include_ffn)
    assert tft.bfhw_launches == before + 1
    ref = tft.fused_temporal_plain_bfhw(g.float(), x.float(), pe.float(),
                                        _f32(flat), 8, f, 1, include_ffn)
    assert out.shape == (b, f, hw, c)
    assert (out.float() - ref).abs().max().item() < 5e-2
    # the same rows in the (location, frame) layout: the same blocks, the
    # same arithmetic
    rows = tft.fused_temporal_transformer(tft.rows_of(g).contiguous(),
                                          tft.rows_of(x).contiguous(), pe,
                                          flat, 8, f, include_ffn=include_ffn)
    assert torch.equal(tft.unrows(rows, b, f, hw), out)


@pytest.mark.parametrize('bfhw', [False, True])
def test_fused_temporal_is_differentiable_on_the_card(cuda, bfhw):
    c, f, heads = 320, 16, 8
    shape = (1, f, 17, c) if bfhw else (17 * f, c)
    g, x, pe, flat = _fused_args(c, heads, f, shape, True, 2, cuda)
    fn = (tft.fused_temporal_transformer_bfhw if bfhw
          else tft.fused_temporal_transformer)
    plain = (tft.fused_temporal_plain_bfhw if bfhw
             else tft.fused_temporal_plain)
    _grads_match_plain(
        lambda g_, x_: fn(g_, x_, pe, flat, heads, f),
        lambda g_, x_: plain(g_, x_, pe.float(), _f32(flat), heads, f),
        [g, x], _fused_args(c, heads, f, shape, True, 3, cuda)[0])


def test_fused_temporal_kernel_refuses_what_it_does_not_take(cuda):
    g, x, pe, flat = _fused_args(320, 8, 16, (32, 320), True, 4, cuda)
    with pytest.raises(TypeError):                           # fp32 input
        tft.fused_temporal_transformer(g.float(), x.float(), pe, flat, 8, 16)
    with pytest.raises(TypeError):                           # bf16 vectors
        tft.fused_temporal_transformer(
            g, x, pe, [p.bfloat16() for p in flat], 8, 16)
    with pytest.raises(ValueError):                          # head dim 160
        tft.fused_temporal_transformer(g, x, pe, flat, 2, 16)
    g2, x2, pe2, flat2 = _fused_args(1280, 8, 16, (32, 1280), False, 5, cuda)
    with pytest.raises(ValueError):                          # C = 1280
        tft.fused_temporal_transformer(g2, x2, pe2, flat2, 8, 16,
                                       include_ffn=False)
