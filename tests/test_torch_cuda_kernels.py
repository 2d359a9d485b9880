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
hash-grid scatter sums in 64-bit fixed point (two calls give the same
bits, those of `hash_table_grad_fixed`), its plain version in fp32 in
another order: it is held to 1e-5 of the largest |plain| entry. The
spatial-attention kernel (outputs O(1), one bf16 rounding of the
exponentials and of the output) is held to 1e-2; the fused GroupNorm-SiLU
convolution, whose outputs reach ~5 and whose bf16 activations are summed
over 9 Cin products in another order, to 1e-2 of the largest |plain| entry.
At the ED-LoRA path's batch-1 shapes (B.H = 8) the flash kernels and GEGLU
are held to the same limits, and GEGLU's autograd gradients (the weights'
too, which ED-LoRA's 'full' scope trains) to 2e-2 of each gradient's
largest entry (bf16 products summed over N or 4C).
"""

import numpy as np
import pytest
import torch

from videoswap_torch.ops import flash_attention as tfa
from videoswap_torch.ops import fused_temporal as tft
from videoswap_torch.ops import geglu_ffn as tgf
from videoswap_torch.ops import gn_silu_conv as tgc
from videoswap_torch.ops import hash_table_grad as thg
from videoswap_torch.ops import spatial_attention as tsa
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


def _geglu_args(n, c, device):
    args = [_randn((n, c), 0, 0.5), _randn((8 * c, c), 1, c ** -0.5),
            _randn((8 * c,), 2, 0.1), _randn((c, 4 * c), 3, (4 * c) ** -0.5),
            _randn((c,), 4, 0.1)]
    return [a.to(device).bfloat16() for a in args]


# every instantiation of the fused kernel (C <= 640), and widths of the
# split route (the U-Net's 1280 among them)
GEGLU_FUSED = (64, 128, 192, 256, 320, 384, 512, 640)
GEGLU_SPLIT = (768, 960, 1152, 1280)


@pytest.mark.parametrize('n', [1, 63, 65, 129, 1000])
@pytest.mark.parametrize('c', GEGLU_FUSED + GEGLU_SPLIT)
def test_geglu_kernel_matches_plain(cuda, n, c):
    args = _geglu_args(n, c, cuda)
    before = (tgf.launches, tgf.gate_launches)
    out = tgf.geglu_ffn(*args)
    # the fused kernel counts one launch a call; the split route its gate
    fused = c in GEGLU_FUSED
    assert (tgf.launches, tgf.gate_launches) == (before[0] + fused,
                                                 before[1] + (not fused))
    ref = tgf.geglu_ffn_plain(*(a.float() for a in args))
    assert out.dtype == torch.bfloat16
    assert (out.float() - ref).abs().max().item() < 3e-2


@pytest.mark.parametrize('tp', [2, 4])
@pytest.mark.parametrize('c', [64, 320, 640])
def test_geglu_kernel_at_a_tensor_parallel_width_matches_plain(cuda, c, tp):
    """A tp rank's shard: H = 4C / tp hidden units, W1's rows as the
    [a | gate] pairs of those units (parallel/sharding.py), through the
    fused kernel."""
    x, w1, b1, w2, b2 = _geglu_args(1000, c, cuda)
    rows = torch.cat([torch.arange(c // tp * 4), 4 * c
                      + torch.arange(c // tp * 4)]).to(cuda)
    args = (x, w1[rows], b1[rows], w2[:, :4 * c // tp].contiguous(), b2)
    before = tgf.launches
    out = tgf.geglu_ffn(*args)
    assert tgf.launches == before + 1
    ref = tgf.geglu_ffn_plain(*(a.float() for a in args))
    assert (out.float() - ref).abs().max().item() < 3e-2


@pytest.mark.parametrize('c', [320, 640, 1280])
def test_geglu_kernel_is_bitwise_repeatable(cuda, c):
    args = _geglu_args(300, c, cuda)
    assert torch.equal(tgf.geglu_ffn(*args), tgf.geglu_ffn(*args))


def _bf16_ulps(out, ref):
    """|out - ref| of each entry in bf16 ulps of its entry of ref (an ulp
    of 0 is the smallest bf16 subnormal)."""
    r = ref.double()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    ulp = torch.where(r == 0, 2.0 ** -133, ulp).clamp_min(2.0 ** -133)
    return (out.double() - r).abs() / ulp


@pytest.mark.parametrize('n,c', [(1, 1280), (517, 768)])
def test_geglu_gate_kernel_matches_plain(cuda, n, c):
    h = _randn((n, 8 * c), 6, 2.0).to(cuda).bfloat16()
    before = tgf.gate_launches
    out = tgf.geglu_gate(h)
    assert tgf.gate_launches == before + 1
    # the plain version's roundings in bf16 (gate / sqrt(2), gelu, the
    # product), each operation of the polynomial rounded apart as PyTorch's
    # are: every entry within one bf16 ulp of the bf16 plain version
    ref = tgf.geglu_gate_plain(h)
    assert out.dtype == torch.bfloat16 and out.shape == (n, 4 * c)
    assert _bf16_ulps(out, ref).max().item() <= 1
    assert _close(out, tgf.geglu_gate_plain(h.float()), 1e-2)


@pytest.mark.parametrize('el,f,h,c', [(37, 16, 8, 320), (9, 24, 8, 1280),
                                      (5, 32, 4, 64), (3, 2, 1, 512)])
def test_temporal_kernel_matches_plain(cuda, el, f, h, c):
    q, k, v = (_randn((el * f, c), s).to(cuda).bfloat16() for s in range(3))
    before = tta.launches
    out = tta.temporal_attention(q, k, v, h, f)
    assert tta.launches == before + 1
    ref = tta.temporal_attention_plain(q.float(), k.float(), v.float(), h, f)
    assert (out.float() - ref).abs().max().item() < 1e-2


def _temporal_case(cuda, el, f, h, c, seed=0):
    """The kernel against the fp32 plain version, twice (the same bits)."""
    q, k, v = (_randn((el * f, c), seed + s).to(cuda).bfloat16()
               for s in range(3))
    out = tta.temporal_attention(q, k, v, h, f)
    again = tta.temporal_attention(q, k, v, h, f)
    ref = tta.temporal_attention_plain(q.float(), k.float(), v.float(), h, f)
    assert torch.equal(out, again)
    assert (out.float() - ref).abs().max().item() < 1e-2


def _temporal_smem_bytes(f, d, hc, lg):
    """Shared memory the temporal kernel takes for one stage of an item (q,
    k and v: frames padded to a multiple of 16, rows to 16 bytes past a
    multiple of 128), its mbarriers and 16 warps' 16 x 72 staging tiles."""
    rows = 16 if f <= 16 else 32
    stage = 3 * lg * rows * (-(-hc * d * 2 // 128) * 128 + 16)
    return 128 + 16 * 16 * 72 * 2 + stage


@pytest.mark.parametrize('d', [8, 16, 40, 80, 160, 512])
@pytest.mark.parametrize('heads', [1, 4, 8])
def test_temporal_plan_fits_the_kernel_at_every_frame_count(cuda, d, heads):
    """Every F <= 32 and every head dim the kernel takes: hc divides the
    heads, an item fits one block's shared memory (227 KB) and, unless it is
    one location of one head, its q, k and v take at most 64 KB and it has
    at most 16 (location, head, query tile) tasks."""
    for f in range(1, tta.MAX_FRAMES + 1):
        hc, lg = tta.plan(f, heads * d, heads)
        assert heads % hc == 0 and lg >= 1
        assert _temporal_smem_bytes(f, d, hc, lg) <= 227 * 1024
        if hc > 1 or lg > 1:
            assert _temporal_smem_bytes(f, d, hc, lg) - 128 \
                - 16 * 16 * 72 * 2 <= 64 * 1024
            assert lg * hc * (1 if f <= 16 else 2) <= 16


@pytest.mark.parametrize('c,hc', [(320, 8), (640, 4), (1280, 2)])
def test_temporal_plan_groups_two_locations_at_the_unet_widths(cuda, c, hc):
    """At the U-Net's 16 frames and 8 heads an item is two whole locations
    (about 62 KB of q, k and v), so a location group is more than one
    location (scripts/fault_control.py's temporal_last_location plant zeroes
    the last location of each)."""
    assert tta.plan(16, c, 8) == (hc, 2)


# the kernel's work items hold plan()'s lg whole locations: location counts
# that are not a multiple of lg, and F at and around the 16-row tiles
@pytest.mark.parametrize('el,f,h,c', [(333, 1, 8, 1280), (101, 7, 8, 640),
                                      (77, 17, 8, 320), (45, 32, 8, 1280),
                                      (129, 16, 8, 1280), (3, 5, 4, 64),
                                      (1, 32, 1, 8)])
def test_temporal_kernel_tiling_edges(cuda, el, f, h, c):
    hc, lg = tta.plan(f, c, h)
    assert el % lg or el < lg or lg == 1
    _temporal_case(cuda, el, f, h, c)


@pytest.mark.parametrize('d', [8, 16, 40, 80, 160, 512])
@pytest.mark.parametrize('f', [2, 16, 24])
def test_temporal_kernel_takes_every_head_dim(cuda, d, f):
    heads = 8 if d <= 160 else 1
    _temporal_case(cuda, 11, f, heads, heads * d, seed=d + f)


def test_temporal_kernel_level_shapes_are_repeatable(cuda):
    """The swap's C = 1280 shapes (2 x 16 x 16 and 2 x 8 x 8 locations):
    two calls give the same bits, and the launch counter counts one a
    call."""
    for el in (512, 128):
        before = tta.launches
        _temporal_case(cuda, el, 16, 8, 1280, seed=el)
        assert tta.launches == before + 2


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


# every head dim the wrapper takes; Sq not a multiple of the 128-row block,
# Sk = 129 leaves a last key tile of one key (tiles of 128 keys, or of 64
# at d > 128)
@pytest.mark.parametrize('d', tfa.HEAD_DIMS)
def test_flash_kernel_takes_every_head_dim(cuda, d):
    for sq, sk in ((200, 129), (1, 1)):
        q = _randn((2, sq, 3, d), d).to(cuda).bfloat16()
        k, v = (_randn((2, sk, 3, d), d + s).to(cuda).bfloat16()
                for s in (1, 2))
        out, lse = tfa.flash_attention_fwd(q, k, v)
        ref, lse_ref = tfa.flash_attention_plain(q.float(), k.float(),
                                                 v.float())
        assert (out.float() - ref).abs().max().item() < 1e-2, (sq, sk)
        assert (lse - lse_ref).abs().max().item() < 1e-2, (sq, sk)


def test_flash_kernel_full_width_level0(cuda):
    """One (batch, head) pair row of the U-Net's level-0 self-attention:
    B*H = 8, S = 4096, d = 40, and its cross-attention (Sk = 77)."""
    q = _randn((1, 4096, 8, 40), 11).to(cuda).bfloat16()
    for sk in (4096, 77):
        k, v = (_randn((1, sk, 8, 40), s).to(cuda).bfloat16()
                for s in (12, 13))
        out, lse = tfa.flash_attention_fwd(q, k, v)
        ref, lse_ref = tfa.flash_attention_plain(q.float(), k.float(),
                                                 v.float())
        assert (out.float() - ref).abs().max().item() < 1e-2, sk
        assert (lse - lse_ref).abs().max().item() < 1e-2, sk


def test_flash_kernel_reads_a_batch_slice_by_stride(cuda):
    """Every other batch entry of q, k and v: a batch stride twice the
    contiguous one, read through the same tensor maps."""
    q, k, v = (_randn((4, 150, 4, 80), s).to(cuda).bfloat16()[::2]
               for s in (14, 15, 16))
    assert not q.is_contiguous()
    out, lse = tfa.flash_attention_fwd(q, k, v)
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
    # an odd width: neither the fused kernel (C a multiple of 64) nor the
    # gate pass (C even) takes it, on either side of MAX_KERNEL_WIDTH
    for c in (97, 961):
        xb = torch.zeros(4, c, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            tgf.geglu_ffn(xb, torch.zeros(8 * c, c, device=cuda).bfloat16(),
                          torch.zeros(8 * c, device=cuda).bfloat16(),
                          torch.zeros(c, 4 * c, device=cuda).bfloat16(),
                          torch.zeros(c, device=cuda).bfloat16())
    with pytest.raises(TypeError):                           # fp32 h
        tgf.geglu_gate(torch.zeros(4, 8 * 768, device=cuda))
    with pytest.raises(ValueError):                          # odd C
        tgf.geglu_gate(torch.zeros(4, 8 * 961, device=cuda).bfloat16())
    for d in (36, 104, 136, 168):       # d % 8 != 0, or no case for its pad
        q = torch.zeros(1, 8, 2, d, device=cuda, dtype=torch.bfloat16)
        with pytest.raises(ValueError):
            tfa.flash_attention_fwd(q, q, q)
    r = torch.zeros(33 * 4, 64, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # F > 32
        tta.temporal_attention(r, r, r, 4, 33)
    r = torch.zeros(16 * 4, 48, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):                          # d = 12
        tta.temporal_attention(r, r, r, 4, 16)
    r = torch.zeros(16 * 4 * 64 + 8, device=cuda, dtype=torch.bfloat16)
    r = r[4:-4].view(16 * 4, 64)                             # 8-byte offset
    with pytest.raises(ValueError):
        tta.temporal_attention(r, r, r, 4, 16)


def _close(out, ref, tol=1e-2):
    """max |out - ref| <= tol * max |ref|."""
    ref = ref.float()
    return (out.float() - ref).abs().max().item() <= tol * ref.abs().max().item()


def _backward_matches_plain(q, k, v, dout, need_q=True, need_kv=True):
    """The kernels' gradients against the fp32 plain version on the same
    bf16 inputs (out and lse from the forward kernel); a gradient that is
    not needed is None and its kernel does not launch."""
    out, lse = tfa.flash_attention_fwd(q, k, v)
    before = (tfa.bwd_dq_launches, tfa.bwd_dkv_launches)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, dout, need_q, need_kv)
    assert (tfa.bwd_dq_launches, tfa.bwd_dkv_launches) == (
        before[0] + need_q, before[1] + need_kv)
    ref = tfa.flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                        out.float(), lse, dout.float())
    needed = (need_q, need_kv, need_kv)
    for g, r, name, need in zip(grads, ref, 'qkv', needed):
        if not need:
            assert g is None, f'd{name}'
            continue
        assert g.dtype == torch.bfloat16 and g.shape == r.shape
        assert torch.isfinite(g).all(), f'd{name}'
        if k.shape[1] == 1 and name in 'qk':
            # one key: p = 1, out = v, so dP = D and dq = dk = 0 up to the
            # rounding of the two sums; the relative check has no scale
            assert g.float().abs().max().item() <= 1e-3, f'd{name}'
        else:
            assert _close(g, r), f'd{name}'


# Sq and Sk on both sides of the 64-row consumer and the 128-row block,
# with ragged 64-row streamed tiles, at a d of two consumers (40) and of
# one consumer in the dK/dV kernel (96)
RAGGED = (1, 63, 65, 77, 127, 129, 300)


@pytest.mark.parametrize('sq,sk,d', [(300, 77, 40), (257, 257, 80),
                                     (64, 64, 160), (1, 5, 8), (130, 77, 128),
                                     (200, 130, 40)]
                         + [(sq, sk, d) for d in (40, 96) for sq in RAGGED
                            for sk in RAGGED])
def test_flash_backward_kernels_match_plain(cuda, sq, sk, d):
    q = _randn((2, sq, 8, d), 1).to(cuda).bfloat16()
    k, v = (_randn((2, sk, 8, d), s).to(cuda).bfloat16() for s in (2, 3))
    dout = _randn((2, sq, 8, d), 4).to(cuda).bfloat16()
    _backward_matches_plain(q, k, v, dout)


@pytest.mark.parametrize('d', tfa.HEAD_DIMS)
def test_flash_backward_takes_every_head_dim(cuda, d):
    for sq, sk in ((200, 129), (1, 1)):
        q = _randn((2, sq, 3, d), d).to(cuda).bfloat16()
        k, v = (_randn((2, sk, 3, d), d + s).to(cuda).bfloat16()
                for s in (1, 2))
        dout = _randn((2, sq, 3, d), d + 3).to(cuda).bfloat16()
        _backward_matches_plain(q, k, v, dout)


@pytest.mark.parametrize('d', [40, 64, 88])
def test_flash_backward_reads_heads_by_stride(cuda, d):
    """The wide map: q/k/v as (B, S, H, D) views of merged projections
    (a row's heads side by side; d = 40 and 88 leave 8 columns of the next
    head in the last k-step), with a contiguous dO."""
    qkv = _randn((2, 100, 3 * 4 * d), 5).to(cuda).bfloat16()
    q, k, v = (t.view(2, 100, 4, d) for t in qkv.chunk(3, dim=-1))
    assert not q.is_contiguous()
    dout = _randn((2, 100, 4, d), 6).to(cuda).bfloat16()
    _backward_matches_plain(q, k, v, dout)


def test_flash_backward_reads_one_head_at_a_time(cuda):
    """The per-head map: every other batch entry and every other head (the
    heads no longer side by side), and a dO transposed from (B, H, S, D)."""
    q, k, v = (_randn((4, 150, 8, 40), s).to(cuda).bfloat16()[::2, :, ::2]
               for s in (14, 15, 16))
    dout = _randn((2, 4, 150, 40), 17).to(cuda).bfloat16().transpose(1, 2)
    assert not dout.is_contiguous() and q.stride(2) != 40
    _backward_matches_plain(q, k, v, dout)


@pytest.mark.parametrize('need_q,need_kv', [(True, False), (False, True)])
def test_flash_backward_runs_only_the_kernel_needed(cuda, need_q, need_kv):
    q = _randn((2, 130, 8, 40), 7).to(cuda).bfloat16()
    k, v = (_randn((2, 77, 8, 40), s).to(cuda).bfloat16() for s in (8, 9))
    dout = _randn((2, 130, 8, 40), 10).to(cuda).bfloat16()
    _backward_matches_plain(q, k, v, dout, need_q, need_kv)


@pytest.mark.parametrize('sq,sk,d', [(300, 300, 40), (129, 77, 128),
                                     (1000, 1000, 80)])
def test_flash_backward_is_bitwise_deterministic(cuda, sq, sk, d):
    """Each output element is written by one block, with no atomics: two
    calls on the same inputs give the same bits."""
    q = _randn((2, sq, 8, d), 11).to(cuda).bfloat16()
    k, v = (_randn((2, sk, 8, d), s).to(cuda).bfloat16() for s in (12, 13))
    dout = _randn((2, sq, 8, d), 14).to(cuda).bfloat16()
    out, lse = tfa.flash_attention_fwd(q, k, v)
    first = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    second = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    for a, b, name in zip(first, second, 'qkv'):
        assert torch.equal(a, b), f'd{name}'


def test_flash_backward_matches_sdpa_at_level1(cuda):
    """The training step's level-1 self-attention (B = 16 frames, S = 1024,
    8 heads, d = 80): the kernels' gradients against the backward of
    `scaled_dot_product_attention` in fp32 on the same bf16 inputs, within
    1e-2 of the largest |reference| entry."""
    import torch.nn.functional as F
    b, s, h, d = 16, 1024, 8, 80
    q, k, v, dout = (_randn((b, s, h, d), i).to(cuda).bfloat16()
                     for i in (21, 22, 23, 24))
    out, lse = tfa.flash_attention_fwd(q, k, v)
    grads = tfa.flash_attention_bwd(q, k, v, out, lse, dout)
    xs = [t.float().transpose(1, 2).requires_grad_() for t in (q, k, v)]
    ref = torch.autograd.grad(F.scaled_dot_product_attention(*xs), xs,
                              dout.float().transpose(1, 2))
    for g, r, name in zip(grads, ref, 'qkv'):
        assert _close(g, r.transpose(1, 2)), f'd{name}'


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
    # the split route (C > 640)
    _grads_match_plain(tgf.geglu_ffn, tgf.geglu_ffn_plain,
                       _geglu_args(70, 768, cuda),
                       _randn((70, 768), 5).to(cuda).bfloat16())
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
    built = build_models({'models': {
        'unet': {'unet_cfg': dict(block_out_channels=(16, 32, 32, 32),
                                  attention_head_dim=4,
                                  cross_attention_dim=24, norm_num_groups=8,
                                  motion_heads=4)},
        'vae_cfg': dict(block_out_channels=(8, 8, 16, 16), norm_groups=8),
        'text_encoder_cfg': dict(hidden_size=24, num_layers=1, num_heads=4,
                                 intermediate_size=32),
        'adapter': {'adapter_cfg': dict(embedding_channels=12,
                                        channels=(16, 32, 32, 32),
                                        mid_dim=8)}}})
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
    for mode in ('global', 'shared') if entries * 16 <= 48 * 1024 else ():
        acc = torch.ones((entries, 2), device=cuda)
        thg._launch(idx, val, acc, mode)
        assert _close(acc - 1, ref, 1e-5), mode
    one = _randn((rows, 1), 2).to(cuda)                     # F = 1
    assert _close(thg.hash_table_grad(idx, one, entries),
                  thg.hash_table_grad_plain(idx, one, entries), 1e-5)


@pytest.mark.parametrize('rows,entries', [(240000, 289), (240000, 529),
                                          (240000, 23409), (240000, 524288)])
def test_hash_table_grad_kernel_is_deterministic(cuda, rows, entries):
    """Two calls, and both forms of the scatter where the shared one fits,
    give the same bits at the atlas levels' table sizes, and those of the
    fixed-point arithmetic stated in PyTorch."""
    rs = np.random.RandomState(entries + 1)
    idx = torch.from_numpy(rs.randint(-1, entries, rows).astype(np.int32))
    val = _randn((rows, 2), 3, 1e-3)
    idx, val = idx.to(cuda), val.to(cuda)
    outs = [thg.hash_table_grad(idx, val, entries) for _ in range(2)]
    outs += [thg._launch(idx, val, torch.zeros((entries, 2), device=cuda), m)
             for m in ('global', 'shared') if entries * 16 <= 48 * 1024]
    outs.append(thg.hash_table_grad_fixed(idx, val, entries))
    bits = [o.view(torch.int32) for o in outs]
    assert all(torch.equal(bits[0], b) for b in bits[1:])
    assert _close(outs[0], thg.hash_table_grad_plain(idx, val, entries), 1e-5)


@pytest.mark.parametrize('entries', [289, 524288])
def test_hash_table_grad_kernel_keeps_what_is_not_finite(cuda, entries):
    """NaN and infinite rows leave their entries NaN or infinite as the
    plain version leaves them, in both forms of the scatter where the shared
    one fits, with the other entries bit-equal to `hash_table_grad_fixed`;
    the next call on finite rows is unharmed (each call zeroes its own
    buffer)."""
    rows = 240000
    rs = np.random.RandomState(entries + 5)
    idx = torch.from_numpy(rs.randint(-1, entries, rows).astype(np.int32))
    val = _randn((rows, 2), 4, 1e-3)
    idx[10:16] = torch.tensor([5, 5, 6, 7, 7, 8], dtype=torch.int32)
    val[10:16, 0] = torch.tensor([float('inf'), -float('inf'), float('nan'),
                                  float('inf'), float('inf'), -float('inf')])
    idx, val = idx.to(cuda), val.to(cuda)
    plain = thg.hash_table_grad_plain(idx, val, entries)
    fixed = thg.hash_table_grad_fixed(idx, val, entries)
    finite = torch.isfinite(plain)
    assert int(finite.sum()) == plain.numel() - 4
    outs = [thg.hash_table_grad(idx, val, entries)]
    outs += [thg._launch(idx, val, torch.zeros((entries, 2), device=cuda), m)
             for m in ('global', 'shared') if entries * 16 <= 48 * 1024]
    for out in outs:
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(out), f(plain))
        assert torch.equal(out[finite].view(torch.int32),
                           fixed[finite].view(torch.int32))
    good = _randn((rows, 2), 6, 1e-3).to(cuda)
    assert torch.equal(thg.hash_table_grad(idx, good, entries)
                       .view(torch.int32),
                       thg.hash_table_grad_fixed(idx, good, entries)
                       .view(torch.int32))


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
    assert thg.launches == before + 1              # one for all six levels
    for g, r in zip(*grads):
        assert _close(g.cpu(), r, 1e-5)


def _atlas_levels(cuda, points=60000, seed=0):
    """The atlas's 16-level geometry (atlas_swan: base 16, scale 1.38,
    T = 2^19, F = 2) at random UVs in [-0.7, 0.7]: idx (16, 4N) int32, val
    (16, 4N, 2) fp32 and each level's used entries."""
    from videoswap_torch.atlas.imlp import _level_geometry, _level_resolutions
    res = _level_resolutions(16, 16, 1.38)
    rs = np.random.RandomState(seed)
    uv = torch.from_numpy(rs.uniform(-0.7, 0.7, (points, 2))
                          .astype(np.float32)).to(cuda)
    idx, u, v, _ = _level_geometry(uv, res, 2 ** 19)
    g = _randn((16, 1, points, 2), seed + 1).to(cuda)
    val = ((u * v)[..., None] * g).reshape(16, -1, 2).contiguous()
    used = [min((r + 1) ** 2, 2 ** 19) for r in res]
    return idx.to(torch.int32).reshape(16, -1).contiguous(), val, used


def _levels_bits_match_fixed(out, idx, val, used):
    """Each level of out: hash_table_grad_fixed on that level alone, bit for
    bit (NaN and infinite entries where the plain version has them), and 0
    past its used entries."""
    for lv, n in enumerate(used):
        fixed = thg.hash_table_grad_fixed(idx[lv], val[lv], n)
        plain = thg.hash_table_grad_plain(idx[lv], val[lv], n)
        for f in (torch.isnan, torch.isposinf, torch.isneginf):
            assert torch.equal(f(out[lv, :n]), f(plain)), lv
        finite = torch.isfinite(plain)
        assert torch.equal(out[lv, :n][finite].view(torch.int32),
                           fixed[finite].view(torch.int32)), lv
        assert not out[lv, n:].any(), lv


@pytest.mark.parametrize('mode', ['auto', 'global'])
def test_hash_levels_kernel_is_bit_equal_per_level(cuda, mode):
    """All 16 levels of an atlas step in one launch: each level's table is
    `hash_table_grad_fixed` on that level alone, bit for bit, in either
    form of the scatter, and a second call gives the same bits."""
    idx, val, used = _atlas_levels(cuda)
    before = thg.launches
    out = thg._launch_levels(idx, val, used,
                             torch.zeros((16, 2 ** 19, 2), device=cuda), mode)
    assert thg.launches == before + 1
    _levels_bits_match_fixed(out, idx, val, used)
    again = thg.hash_table_grad_levels(
        idx, val, used, torch.zeros((16, 2 ** 19, 2), device=cuda))
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_hash_levels_kernel_keeps_what_is_not_finite(cuda):
    """NaN and infinite rows in two levels leave their entries as the plain
    version leaves them; every other entry of every level is bit-equal to
    `hash_table_grad_fixed` on its level (the bad values take no part in a
    level's scale)."""
    idx, val, used = _atlas_levels(cuda, 20000, seed=3)
    for lv in (0, 13):
        idx[lv, :6] = torch.tensor([5, 5, 6, 7, 7, 8], dtype=torch.int32)
        val[lv, :6, 0] = torch.tensor([float('inf'), -float('inf'),
                                       float('nan'), float('inf'),
                                       float('inf'), -float('inf')])
    out = thg.hash_table_grad_levels(
        idx, val, used, torch.zeros((16, 2 ** 19, 2), device=cuda))
    assert int((~torch.isfinite(out)).sum()) == 8
    _levels_bits_match_fixed(out, idx, val, used)


def test_hash_levels_kernel_drops_a_level_and_accumulates(cuda):
    """A level whose rows are all dropped adds nothing; accumulating into a
    table that is not zero adds to it; a second call, handed the block the
    first call's buffer left dirty by the caching allocator, gives the same
    bits (the kernel zeroes its max words and int64 tables itself)."""
    idx, val, used = _atlas_levels(cuda, 5000, seed=5)
    idx[7] = -1
    base = _randn((16, 2 ** 19, 2), 6).to(cuda)
    out = thg.hash_table_grad_levels(idx, val, used, base.clone())
    assert torch.equal(out[7], base[7])
    ref = thg.hash_table_grad_levels(idx.cpu(), val.cpu(), used,
                                     base.cpu().clone())
    assert _close(out.cpu(), ref, 1e-5)
    again = thg.hash_table_grad_levels(idx, val, used, base.clone())
    assert torch.equal(out.view(torch.int32), again.view(torch.int32))


def test_hash_levels_kernel_refuses_what_it_does_not_take(cuda):
    idx = torch.zeros(2, 8, dtype=torch.int32, device=cuda)
    val = torch.zeros(2, 8, 2, device=cuda)
    out = torch.zeros(2, 16, 2, device=cuda)
    with pytest.raises(ValueError):                         # used > T
        thg.hash_table_grad_levels(idx, val, [16, 17], out)
    with pytest.raises(ValueError):                         # one used short
        thg.hash_table_grad_levels(idx, val, [16], out)
    with pytest.raises(ValueError):
        thg.hash_table_grad_levels(idx, val, [16, 16], out[:1])
    with pytest.raises(TypeError):
        thg.hash_table_grad_levels(idx, val.double(), [16, 16], out)
    many = thg.MAX_LEVELS + 1                       # one launch a call
    with pytest.raises(ValueError):
        thg.hash_table_grad_levels(
            torch.zeros(many, 8, dtype=torch.int32, device=cuda),
            torch.zeros(many, 8, 2, device=cuda), [16] * many,
            torch.zeros(many, 16, 2, device=cuda))


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
    (2, 16, 37, 320, True), (2, 16, 13, 640, False), (1, 8, 9, 64, True),
    (2, 20, 7, 320, True), (3, 24, 5, 640, False)])
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


@pytest.mark.parametrize('locs,f,c,heads,include_ffn', [
    (1, 16, 320, 8, True), (1, 16, 640, 8, False), (5, 16, 320, 8, True),
    (3, 16, 640, 8, False), (1, 24, 128, 4, True), (7, 20, 320, 8, True),
    (9, 8, 640, 8, True), (6, 16, 192, 8, True), (5, 16, 448, 7, False)])
def test_fused_temporal_kernel_row_tile_edges(cuda, locs, f, c, heads,
                                              include_ffn):
    """The kernel's row sets hold 64 // F whole locations (two row sets
    a block at C <= 320, one above): n_loc = 1, and
    location counts that fill neither a row set nor a block, at widths of
    both forms (odd head counts among them); and two calls give the same
    bits."""
    g, x, pe, flat = _fused_args(c, heads, f, (locs * f, c), include_ffn, 6,
                                 cuda)
    out = tft.fused_temporal_transformer(g, x, pe, flat, heads, f,
                                         include_ffn=include_ffn)
    again = tft.fused_temporal_transformer(g, x, pe, flat, heads, f,
                                           include_ffn=include_ffn)
    assert torch.equal(out, again)
    ref = tft.fused_temporal_plain(g.float(), x.float(), pe.float(),
                                   _f32(flat), heads, f, 1, include_ffn)
    assert (out.float() - ref).abs().max().item() < 5e-2


@pytest.mark.parametrize('hw,c,include_ffn', [(4096, 320, True),
                                              (1024, 640, False)])
def test_fused_temporal_level_shapes_both_layouts(cuda, hw, c, include_ffn):
    """U-Net levels 0 and 1 (CFG batch 2 x 16 frames): the frame-major
    layout gives the bits of the (location, frame) layout, two calls give
    the same bits, and both agree with the plain version."""
    b, f = 2, 16
    g, x, pe, flat = _fused_args(c, 8, f, (b, f, hw, c), include_ffn, 7,
                                 cuda)
    out = tft.fused_temporal_transformer_bfhw(g, x, pe, flat, 8, f,
                                              include_ffn=include_ffn)
    assert torch.equal(out, tft.fused_temporal_transformer_bfhw(
        g, x, pe, flat, 8, f, include_ffn=include_ffn))
    g2, x2 = tft.rows_of(g).contiguous(), tft.rows_of(x).contiguous()
    rows = tft.fused_temporal_transformer(g2, x2, pe, flat, 8, f,
                                          include_ffn=include_ffn)
    assert torch.equal(tft.unrows(rows, b, f, hw), out)
    ref = tft.fused_temporal_plain(g2.float(), x2.float(), pe.float(),
                                   _f32(flat), 8, f, 1, include_ffn)
    assert (rows.float() - ref).abs().max().item() < 5e-2


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


@pytest.mark.parametrize('b,s,heads,d', [(2, 256, 8, 40), (1, 300, 4, 80),
                                         (1, 2304, 2, 64), (3, 77, 1, 128),
                                         (2, 129, 2, 8), (1, 64, 4, 24),
                                         (1, 1, 8, 40), (2, 4096, 4, 40)])
def test_spatial_attention_kernel_matches_plain(cuda, b, s, heads, d):
    """Every key attended, the tail of a key tile and of a query block
    masked (a last tile of one key at S = 129, one row at S = 1), head dims
    from 8 to 128, and the level-0 shape at B*H = 8."""
    q, k, v = (_randn((b, s, heads * d), i).to(cuda).bfloat16()
               for i in range(3))
    before = tsa.launches
    out = tsa.spatial_self_attention(q, k, v, heads)
    assert tsa.launches == before + 1
    ref = tsa.spatial_attention_plain(q.float(), k.float(), v.float(), heads)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    assert (out.float() - ref).abs().max().item() < 1e-2


def test_spatial_attention_reads_rows_by_stride(cuda):
    """q, k, v as column slices of one fused projection (row stride 3C)."""
    qkv = _randn((2, 256, 3 * 320), 4).to(cuda).bfloat16()
    q, k, v = qkv.chunk(3, dim=-1)
    assert not q.is_contiguous()
    out = tsa.spatial_self_attention(q, k, v, 8)
    ref = tsa.spatial_attention_plain(q.float(), k.float(), v.float(), 8)
    assert (out.float() - ref).abs().max().item() < 1e-2


def test_spatial_attention_is_differentiable_on_the_card(cuda):
    qkv = [_randn((1, 256, 160), s).to(cuda).bfloat16() for s in range(3)]
    _grads_match_plain(lambda *t: tsa.spatial_self_attention(*t, 4),
                       lambda *t: tsa.spatial_attention_plain(*t, 4), qkv,
                       _randn((1, 256, 160), 3).to(cuda).bfloat16())


def _conv_args(n, h, w, cin, cout, seed, device):
    """x bf16, per-image fp32 scale and shift from x's statistics (32
    groups, or Cin / 8 below that) with a random affine, an OIHW weight on
    a (9 Cin)^-1/2 scale and an fp32 bias."""
    rs = np.random.RandomState(seed)
    x = _randn((n, h, w, cin), seed).to(device).bfloat16()
    gamma = torch.from_numpy((rs.rand(cin) + 0.5).astype(np.float32))
    beta = torch.from_numpy((rs.randn(cin) * 0.3).astype(np.float32))
    scale, shift = tgc.gn_scale_shift(
        *tgc.gn_stats(x, min(32, cin // 8)), gamma.to(device),
        beta.to(device))
    weight = _randn((cout, cin, 3, 3), seed + 1,
                    (9 * cin) ** -0.5).to(device).bfloat16()
    bias = _randn((cout,), seed + 2, 0.1).to(device)
    return x, scale, shift, weight, bias


@pytest.mark.parametrize('n,h,w,cin,cout', [
    (2, 16, 8, 64, 64), (1, 64, 64, 320, 320), (2, 32, 32, 640, 640),
    (1, 32, 32, 320, 640), (3, 7, 5, 32, 8), (2, 12, 48, 48, 24),
    (1, 8, 136, 16, 72), (1, 16, 16, 64, 480), (2, 33, 100, 96, 200),
    (1, 5, 70, 320, 24), (2, 5, 20, 32, 320), (2, 12, 30, 48, 320)])
def test_gn_silu_conv_kernel_matches_plain(cuda, n, h, w, cin, cout):
    """The U-Net's level-0 and level-1 shapes and a Cin != Cout resnet;
    images narrower than a 64-column segment, widths cut into two (100,
    70) or three (136) segments, every last tile of 256 rows partly full;
    Cout past the last whole 160-channel block (8 ... 200) or three
    blocks (480); Cin short of a 64-channel chunk (16 ... 48, and 96).
    Pairs of channel blocks share their activation (a cluster of two):
    at 320 and 640 and in one tile of 110 rows (5 x 20) or a second tile
    of 128 (12 x 30), as at level 0."""
    args = _conv_args(n, h, w, cin, cout, n * h + w, cuda)
    before = tgc.launches
    out = tgc.gn_silu_conv_kernel(*args)
    assert tgc.launches == before + 1
    ref = tgc.gn_silu_conv_plain(*args)
    assert out.dtype == torch.bfloat16 and out.shape == (n, h, w, cout)
    assert _close(out, ref)


def test_gn_silu_conv_zero_pads_after_the_activation(cuda):
    """A channel with gamma = 0 activates to silu(beta) inside the image
    and to 0 in the padding ring."""
    x, scale, shift, weight, bias = _conv_args(2, 16, 16, 64, 64, 7, cuda)
    scale[:, :8] = 0.0
    shift[:, :8] = 2.0
    out = tgc.gn_silu_conv_kernel(x, scale, shift, weight, bias)
    assert _close(out, tgc.gn_silu_conv_plain(x, scale, shift, weight, bias))


@pytest.mark.parametrize('n,h,w,cin,cout', [
    (1, 64, 64, 320, 320), (2, 33, 100, 96, 200)])
def test_gn_silu_conv_is_bitwise_repeatable(cuda, n, h, w, cin, cout):
    """No atomics and a fixed order of products: two calls give the same
    bits."""
    args = _conv_args(n, h, w, cin, cout, 11, cuda)
    first = tgc.gn_silu_conv_kernel(*args)
    assert torch.equal(first.view(torch.int16),
                       tgc.gn_silu_conv_kernel(*args).view(torch.int16))


def test_gn_silu_conv_plan_is_the_kernels(cuda):
    """ops/gn_silu_conv.py `plan` (the CPU tests' tiling and the fault
    plants') is the one the built kernel launches."""
    for h, w in ((64, 64), (32, 32), (7, 5), (33, 100), (8, 136),
                 (1, 1), (300, 65), (5, 1000)):
        assert tgc.library_plan(h, w) == tgc.plan(h, w), (h, w)


def test_unrouted_kernels_refuse_what_they_do_not_take(cuda):
    q = torch.zeros(1, 64, 320, device=cuda)                 # fp32
    with pytest.raises(TypeError):
        tsa.spatial_self_attention(q, q, q, 8)
    qb = q.bfloat16()
    with pytest.raises(ValueError):                          # head dim 160
        tsa.spatial_self_attention(qb, qb, qb, 2)
    with pytest.raises(ValueError):                          # head dim 20
        tsa.spatial_self_attention(qb, qb, qb, 16)
    with pytest.raises(ValueError):                          # cross
        tsa.spatial_self_attention(qb, qb[:, :32], qb[:, :32], 8)
    x, scale, shift, weight, bias = _conv_args(1, 8, 8, 64, 64, 8, cuda)
    with pytest.raises(TypeError):                           # fp32 x
        tgc.gn_silu_conv_kernel(x.float(), scale, shift, weight, bias)
    with pytest.raises(TypeError):                           # bf16 scale
        tgc.gn_silu_conv_kernel(x, scale.bfloat16(), shift, weight, bias)
    with pytest.raises(ValueError):                          # Cin 40
        tgc.gn_silu_conv_kernel(x[..., :40], scale[:, :40], shift[:, :40],
                                weight[:, :40], bias)
    with pytest.raises(ValueError):                          # 1x1 weight
        tgc.gn_silu_conv_kernel(x, scale, shift, weight[:, :, :1, :1], bias)
    many = x[:, :1, :1].expand(65536, 1, 1, 64)              # 65536 images
    with pytest.raises(ValueError):
        tgc.gn_silu_conv_kernel(many, scale.expand(65536, 64),
                                shift.expand(65536, 64), weight, bias)


# the ED-LoRA path's shapes: one 512x512 image, 8 heads (B.H = 8), each
# U-Net level's self-attention and cross-attention (Sk = 77) and its GEGLU
# rows
EDLORA_ATTN = [(s, sk, d) for s, d in ((4096, 40), (1024, 80), (256, 160),
                                       (64, 160)) for sk in (s, 77)]


@pytest.mark.parametrize('s,sk,d', EDLORA_ATTN)
def test_flash_kernels_at_the_edlora_shapes(cuda, s, sk, d):
    q = _randn((1, s, 8, d), 1).to(cuda).bfloat16()
    k, v = (_randn((1, sk, 8, d), seed).to(cuda).bfloat16()
            for seed in (2, 3))
    out, _ = tfa.flash_attention_fwd(q, k, v)
    ref, _ = tfa.flash_attention_plain(q.float(), k.float(), v.float())
    assert (out.float() - ref).abs().max().item() < 1e-2
    dout = _randn((1, s, 8, d), 4).to(cuda).bfloat16()
    _backward_matches_plain(q, k, v, dout)


@pytest.mark.parametrize('n,c', [(4096, 320), (1024, 640), (256, 1280),
                                 (64, 1280)])
def test_geglu_at_the_edlora_shapes(cuda, n, c):
    """The forward by its width's route, and the autograd Function's
    gradients, the weights' too (ED-LoRA's 'full' scope trains factors on
    both FFN products), against autograd through the fp32 plain version,
    relative to each gradient's largest entry."""
    args = _geglu_args(n, c, cuda)
    out = tgf.geglu_ffn(*args)
    ref = tgf.geglu_ffn_plain(*(a.float() for a in args))
    assert (out.float() - ref).abs().max().item() < 3e-2
    xs = [a.detach().requires_grad_() for a in args]
    dout = _randn((n, c), 5).to(cuda).bfloat16()
    grads = torch.autograd.grad(tgf.geglu_ffn(*xs), xs, dout)
    refs = [a.detach().float().requires_grad_() for a in args]
    ref_grads = torch.autograd.grad(tgf.geglu_ffn_plain(*refs), refs,
                                    dout.float())
    for name, g, r in zip(('x', 'w1', 'b1', 'w2', 'b2'), grads, ref_grads):
        assert g.dtype == torch.bfloat16, name
        assert _close(g, r, 2e-2), name


# ------------------------------------------------------------- long video
def _seeded(module, seed, device):
    """`module` with seeded weights (non-zero vectors too), bf16 on
    `device`, frozen."""
    from videoswap_torch.utils.init import init_weights
    gen = torch.Generator().manual_seed(seed)
    init_weights(module, gen)
    with torch.no_grad():
        for p in module.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen), alpha=0.1)
    return module.to(device, torch.bfloat16).requires_grad_(False).eval()


@pytest.mark.parametrize('c,stride', [(320, 8), (320, 6), (640, 8),
                                      (1280, 8)])
def test_windowed_motion_module_matches_plain(cuda, c, stride):
    """32 frames through windows of 16 (stride 6: a flush window and
    frames in three windows): layer-wise on the card (temporal attention
    on the windows, GEGLU on the FFN, no fused launch), against the same
    module in fp32 on the CPU (the plain versions), relative to the
    largest |plain| entry as the fused module's (5e-2: x + the module
    through about ten bf16 roundings), and the same bits twice."""
    from videoswap_torch.models.motion_module import VanillaTemporalModule
    module = _seeded(VanillaTemporalModule(c, window=16, stride=stride), 0,
                     cuda)
    x = _randn((2, 32, 4, 4, c), 1).to(cuda).bfloat16()
    before = (tft.launches, tta.launches, tgf.launches + tgf.gate_launches)
    with torch.no_grad():
        out = module(x)
        again = module(x)
        ref = module.to('cpu', torch.float32)(x.float().cpu())
    assert tft.launches == before[0]
    assert tta.launches > before[1] and \
        tgf.launches + tgf.gate_launches > before[2]
    assert torch.equal(out, again)
    err = (out.float().cpu() - ref).abs().max() / ref.abs().max()
    assert err.item() < 5e-2


@pytest.mark.parametrize('mode', [False, True, 'edges', 'save_flash',
                                  'edges_sf'])
def test_recompute_modes_launch_the_flash_forward(cuda, mode):
    """A small U-Net on the card with a sample that needs a gradient (so
    every block recomputes under True): one forward and backward launches
    the flash forward once a site, twice at the recomputed sites under
    True ('edges': the level-0 blocks'), once under the save_flash
    policies, whose gradients equal True's."""
    from videoswap_torch.models import AnimateDiffUNet3DModel, UNet3DConfig
    cfg = UNet3DConfig(block_out_channels=(64, 64, 128, 128),
                       attention_head_dim=8, cross_attention_dim=64,
                       motion_heads=8)
    unet = _seeded(AnimateDiffUNet3DModel(cfg), 2, cuda)
    x = _randn((1, 2, 16, 16, 4), 3).to(cuda).bfloat16()
    text = _randn((1, 77, 64), 4).to(cuda).bfloat16()

    def run(m):
        unet.set_gradient_checkpointing(m)
        xs = x.clone().requires_grad_()
        before = tfa.launches
        out = unet(xs, torch.tensor([500], device=cuda), text)
        sites = tfa.launches - before
        out.float().square().mean().backward()
        return sites, tfa.launches - before, xs.grad

    sites, _, ref_grad = run(True)
    level0 = sum(2 * len(t.transformer_blocks)
                 for b in (unet.down_blocks[0], unet.up_blocks[-1])
                 for t in b.attentions)
    _, total, grad = run(mode)
    expected = {False: sites, True: 2 * sites, 'edges': sites + level0,
                'save_flash': sites, 'edges_sf': sites}[mode]
    assert total == expected, (mode, total, sites, level0)
    assert torch.equal(grad, ref_grad)
