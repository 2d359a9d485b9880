"""Frame-axis (temporal) attention: a hand-written Hopper kernel and its
plain PyTorch version.

`temporal_attention(q2, k2, v2, heads, f)` takes (L*F, C) rows ordered
(location, frame) and runs multi-head self-attention over the F frames of
each location. A CUDA tensor launches `csrc/temporal_attention.cu` (bf16,
F <= 32, a head dim that is a multiple of 8, 16-byte aligned rows) or
raises; a CPU tensor takes `temporal_attention_plain`. The kernel cuts the
work into items of `lg` whole locations by `hc` heads, about 32 KB of q, k
and v a location, which one block copies into shared memory while it
computes the item before; `plan` asks the kernel's library for (hc, lg).

`temporal_attention` is differentiable. Its backward,
`temporal_attention_bwd_plain`, recomputes the (tiny-F) attention in fp32
plain PyTorch on either device, as the JAX package's custom VJP does in
plain XLA.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

MAX_FRAMES = 32


def plan(f: int, c: int, heads: int) -> tuple[int, int]:
    """(hc, lg): the heads and whole locations of one of the kernel's work
    items at F = f, C = c (csrc/temporal_attention.cu `plan_item`). Needs
    the built library, so the card."""
    hc_lg = (ctypes.c_int * 2)()
    _build.check(_build.library().vs_temporal_attention_plan(f, c, heads,
                                                             hc_lg),
                 'vs_temporal_attention_plan')
    return hc_lg[0], hc_lg[1]


def temporal_attention_plain(q2, k2, v2, heads: int, f: int):
    n, c = q2.shape
    d = c // heads
    qh, kh, vh = (t.reshape(n // f, f, heads, d).float() for t in (q2, k2, v2))
    # the scale on q, as ops.attention.attention_with_probs and
    # flash_attention_plain take it: a site gives the same bits on any
    s = torch.einsum('lfhd,lghd->lhfg', qh * d ** -0.5, kh)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum('lhfg,lghd->lfhd', p, vh)
    return out.reshape(n, c).to(q2.dtype)


def temporal_attention_bwd_plain(q2, k2, v2, dout, heads: int, f: int):
    """(dq2, dk2, dv2) of temporal_attention_plain, computed in fp32."""
    n, c = q2.shape
    d = c // heads
    scale = d ** -0.5
    qh, kh, vh, do = (t.reshape(n // f, f, heads, d).float()
                      for t in (q2, k2, v2, dout))
    p = torch.softmax(torch.einsum('lfhd,lghd->lfgh', qh, kh) * scale, dim=2)
    dv = torch.einsum('lfgh,lfhd->lghd', p, do)
    dp = torch.einsum('lfhd,lghd->lfgh', do, vh)
    ds = p * (dp - (p * dp).sum(dim=2, keepdim=True))
    dq = torch.einsum('lfgh,lghd->lfhd', ds, kh) * scale
    dk = torch.einsum('lfgh,lfhd->lghd', ds, qh) * scale
    return (dq.reshape(n, c).to(q2.dtype), dk.reshape(n, c).to(k2.dtype),
            dv.reshape(n, c).to(v2.dtype))


def temporal_attention_kernel(q2, k2, v2, heads: int, f: int):
    global launches
    n, c = q2.shape
    if any(t.device != q2.device for t in (k2, v2)):
        raise ValueError('temporal_attention: tensors on different devices')
    if any(t.dtype != torch.bfloat16 for t in (q2, k2, v2)):
        raise TypeError('temporal_attention kernel takes bf16 tensors')
    if any(tuple(t.shape) != (n, c) for t in (k2, v2)):
        raise ValueError('temporal_attention: q, k, v shapes differ')
    if not all(t.is_contiguous() for t in (q2, k2, v2)):
        raise ValueError('temporal_attention kernel takes contiguous tensors')
    if not 1 <= f <= MAX_FRAMES or n % f or c % heads or (c // heads) % 8:
        raise ValueError(f'temporal_attention kernel: F={f} (<= {MAX_FRAMES})'
                         f', rows={n}, C={c}, heads={heads} (a head dim that '
                         'is a multiple of 8)')
    ptrs = q2.data_ptr(), k2.data_ptr(), v2.data_ptr()
    if (ptrs[0] | ptrs[1] | ptrs[2]) % 16:
        raise ValueError('temporal_attention kernel takes 16-byte aligned '
                         'tensors')
    out = torch.empty_like(q2)
    if n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(q2.device).cuda_stream
    status = lib.vs_temporal_attention(*ptrs, out.data_ptr(), n // f, f, c,
                                       heads, stream)
    _build.check(status, 'vs_temporal_attention')
    launches += 1
    return out


class TemporalAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q2, k2, v2, heads, f):
        ctx.save_for_backward(q2, k2, v2)
        ctx.heads, ctx.f = heads, f
        if q2.is_cuda:
            return temporal_attention_kernel(q2, k2, v2, heads, f)
        return temporal_attention_plain(q2, k2, v2, heads, f)

    @staticmethod
    def backward(ctx, dout):
        return (*temporal_attention_bwd_plain(*ctx.saved_tensors, dout,
                                              ctx.heads, ctx.f), None, None)


def temporal_attention(q2, k2, v2, heads: int, f: int):
    """q2/k2/v2: (L*F, C), rows (location, frame) -> (L*F, C)."""
    return TemporalAttention.apply(q2, k2, v2, heads, f)
