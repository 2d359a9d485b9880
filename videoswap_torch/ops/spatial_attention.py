"""Spatial self-attention with merged heads: a hand-written Hopper kernel and
its plain PyTorch version (the port of videoswap_tpu/ops/spatial_attention.py).

Unrouted, as in the JAX package: the U-Net's spatial self-attention sites go
through `ops/attention.py`'s flash route; this op is the counterpart of the
JAX package's max-free kernel, run by `chip_smoke.py`'s `unrouted` phase at
the benchmark's shapes and on the U-Net's own level-0 and level-1 inputs.

`spatial_self_attention(q, k, v, heads)` takes q, k, v (B, S, C) with the
heads merged in C (d = C / heads) and returns (B, S, C): per head,
exp(min(q.k d^-1/2, 60)) over all S keys divided by its row sum, which is
softmax attention wherever the scaled logits stay <= 60 (LayerNorm-scale
inputs). A CUDA tensor launches `csrc/spatial_attention.cu` (bf16, d a
multiple of 8 up to 128) or raises; a CPU tensor takes
`spatial_attention_plain`. It is differentiable: the backward is
`spatial_attention_bwd_plain`, the fp32 softmax gradient the JAX package's
custom VJP computes in plain XLA (there is no backward kernel).

The TPU kernel's key loop drops the keys past the last whole 2048-key
block; the port attends over every key. `supported` keeps the JAX gate.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

BQ = 256             # the JAX kernel's query block: S must be a multiple
MAX_HEAD_DIM = 128
CLIP = 60.0          # scaled logits are clipped here before the exp


def _heads(t, heads):
    b, s, c = t.shape
    return t.reshape(b, s, heads, c // heads)


def spatial_attention_plain(q, k, v, heads: int,
                            batch_chunk: int | None = None):
    """The kernel's arithmetic in fp32: e = exp(min(s, 60)) rounded to v's
    dtype, out = (e v) / sum(e). `batch_chunk` bounds the (chunk, heads, S,
    S) fp32 logits at large shapes."""
    b, s, c = q.shape
    d = c // heads
    chunk = batch_chunk or b
    outs = []
    for i in range(0, b, chunk):
        qh, kh, vh = (_heads(t[i:i + chunk], heads).float() for t in (q, k, v))
        logits = torch.einsum('bqhd,bkhd->bhqk', qh, kh) * d ** -0.5
        e = torch.exp(logits.clamp_max_(CLIP)).to(v.dtype).float()
        del logits
        num = torch.einsum('bhqk,bkhd->bqhd', e, vh)
        inv = 1.0 / e.sum(dim=-1).transpose(1, 2)[..., None]
        outs.append((num * inv).reshape(-1, s, c))
    return torch.cat(outs).to(q.dtype)


def spatial_attention_bwd_plain(q, k, v, dout, heads: int):
    """(dq, dk, dv) of softmax attention in fp32, as the JAX package's
    custom VJP computes them."""
    b, s, c = q.shape
    d = c // heads
    scale = d ** -0.5
    qh, kh, vh, do = (_heads(t, heads).float() for t in (q, k, v, dout))
    p = torch.softmax(torch.einsum('bqhd,bkhd->bhqk', qh, kh) * scale,
                      dim=-1)
    dv = torch.einsum('bhqk,bqhd->bkhd', p, do)
    dp = torch.einsum('bqhd,bkhd->bhqk', do, vh)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    dq = torch.einsum('bhqk,bkhd->bqhd', ds, kh) * scale
    dk = torch.einsum('bhqk,bqhd->bkhd', ds, qh) * scale
    return (dq.reshape(b, s, c).to(q.dtype), dk.reshape(b, s, c).to(k.dtype),
            dv.reshape(b, s, c).to(v.dtype))


def supported(q, k, heads: int) -> bool:
    """The JAX package's gate: self-attention (the same query and key
    length, a multiple of its 256-row query block) with head dim <= 128."""
    b, sq, c = q.shape
    return (sq == k.shape[1] and sq % BQ == 0 and c % heads == 0
            and c // heads <= MAX_HEAD_DIM)


def _launch(q, k, v, out, heads: int):
    """Launch the kernel on checked tensors; k and v may be shorter than q
    (the kernel masks its key tail)."""
    global launches
    b, sq, c = q.shape
    strides = (ctypes.c_longlong * 8)(
        *(s for t in (q, k, v, out) for s in t.stride()[:2]))
    status = _build.library().vs_spatial_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, heads,
        sq, k.shape[1], c // heads, strides,
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, 'vs_spatial_attention')
    launches += 1


def spatial_attention_kernel(q, k, v, heads: int):
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f'spatial_self_attention: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}: self-'
                         'attention over (B, S, C) tensors')
    if any(t.device != q.device for t in (k, v)):
        raise ValueError('spatial_self_attention: tensors on different '
                         'devices')
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError('spatial_self_attention kernel takes bf16 tensors')
    b, s, c = q.shape
    if c % heads or (c // heads) % 8 or c // heads > MAX_HEAD_DIM:
        raise ValueError(f'spatial_self_attention kernel: head dim '
                         f'{c}/{heads} must be a multiple of 8 up to '
                         f'{MAX_HEAD_DIM}')
    for t in (q, k, v):
        if t.stride(2) != 1 or any(st % 8 for st in t.stride()[:2]) \
                or t.data_ptr() % 16:
            raise ValueError('spatial_self_attention kernel needs unit '
                             'stride on C, other strides a multiple of 8 '
                             'and 16-byte aligned data')
    out = torch.empty((b, s, c), dtype=q.dtype, device=q.device)
    if b * s == 0:
        return out
    _launch(q, k, v, out, heads)
    return out


class SpatialSelfAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, heads):
        ctx.save_for_backward(q, k, v)
        ctx.heads = heads
        if q.is_cuda:
            return spatial_attention_kernel(q, k, v, heads)
        return spatial_attention_plain(q, k, v, heads)

    @staticmethod
    def backward(ctx, dout):
        return (*spatial_attention_bwd_plain(*ctx.saved_tensors, dout,
                                             ctx.heads), None)


def spatial_self_attention(q, k, v, heads: int):
    """q, k, v: (B, S, C) merged-head projections -> (B, S, C)."""
    return SpatialSelfAttention.apply(q, k, v, heads)
