"""Flash-attention forward: a hand-written Hopper kernel and its plain
PyTorch version.

`flash_attention_fwd(q, k, v)` takes q (B, Sq, H, D) and k, v (B, Sk, H, D)
and returns (out (B, Sq, H, D), lse (B*H, Sq) fp32), non-causal. A CUDA
tensor launches `csrc/flash_attention.cu` (bf16, D a multiple of 8 whose
multiple of 16 the kernel is built for, read through its strides) or raises; a CPU tensor takes
`flash_attention_plain`. `flash_attention` returns only `out`.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

# D rounded up to a multiple of 16: the head dims csrc/flash_attention.cu
# instantiates (its VS_FLASH_CASE list)
PADDED_HEAD_DIMS = (16, 32, 48, 64, 80, 96, 128, 160)


def flash_attention_plain(q, k, v, batch_chunk: int | None = None):
    """Materialised-softmax statement of the same function. `batch_chunk`
    bounds the (chunk, H, Sq, Sk) fp32 logits at large shapes."""
    b, sq, h, d = q.shape
    chunk = batch_chunk or b
    outs, lses = [], []
    for i in range(0, b, chunk):
        qc, kc, vc = q[i:i + chunk], k[i:i + chunk], v[i:i + chunk]
        logits = torch.einsum('bqhd,bkhd->bhqk', qc.float(),
                              kc.float()) * d ** -0.5
        lses.append(torch.logsumexp(logits, dim=-1).reshape(-1, sq))
        probs = torch.softmax(logits, dim=-1)
        outs.append(torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), vc))
    return torch.cat(outs).to(q.dtype), torch.cat(lses)


def _check_kernel_args(q, k, v):
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError('flash_attention takes (B, S, H, D) tensors')
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f'flash_attention: q {tuple(q.shape)}, k '
                         f'{tuple(k.shape)}, v {tuple(v.shape)}')
    if any(t.device != q.device for t in (k, v)):
        raise ValueError('flash_attention: tensors on different devices')
    if any(t.dtype != torch.bfloat16 for t in (q, k, v)):
        raise TypeError('flash_attention kernel takes bf16 tensors')
    if d % 8 or (d + 15) // 16 * 16 not in PADDED_HEAD_DIMS:
        raise ValueError(f'flash_attention kernel: head dim {d} must be a '
                         f'multiple of 8 that rounds up to one of '
                         f'{PADDED_HEAD_DIMS}')
    for t in (q, k, v):
        if t.stride(3) != 1 or any(s % 8 for s in t.stride()[:3]) \
                or t.data_ptr() % 16:
            raise ValueError('flash_attention kernel needs unit stride on D, '
                             'other strides a multiple of 8 and 16-byte '
                             'aligned data')


def flash_attention_kernel(q, k, v):
    global launches
    _check_kernel_args(q, k, v)
    b, sq, h, d = q.shape
    sk = k.shape[1]
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b * h, sq), dtype=torch.float32, device=q.device)
    if b * sq * sk == 0:
        return out, lse
    strides = (ctypes.c_longlong * 12)(
        *(s for t in (q, k, v, out) for s in t.stride()[:3]))
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.vs_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, strides, stream)
    _build.check(status, 'vs_flash_attention_fwd')
    launches += 1
    return out, lse


def flash_attention_fwd(q, k, v):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (out, lse (B*H, Sq))."""
    if q.is_cuda:
        return flash_attention_kernel(q, k, v)
    return flash_attention_plain(q, k, v)


def flash_attention(q, k, v):
    return flash_attention_fwd(q, k, v)[0]
