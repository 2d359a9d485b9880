"""Flash attention, forward and backward: hand-written Hopper kernels and
their plain PyTorch versions.

`flash_attention_fwd(q, k, v)` takes q (B, Sq, H, D) and k, v (B, Sk, H, D)
and returns (out (B, Sq, H, D), lse (B*H, Sq) fp32), non-causal. A CUDA
tensor launches `csrc/flash_attention.cu` (bf16, a head dim of
`HEAD_DIMS`, read through its strides) or raises; a CPU tensor takes
`flash_attention_plain`.

`flash_attention_bwd(q, k, v, out, lse, dout)` returns (dq, dk, dv): on
CUDA tensors the two kernels of `csrc/flash_attention_bwd.cu`, built like
the forward on `csrc/attention_sm90.cuh` (TMA, wgmma, warp-specialised):
the dQ kernel (128 query rows a block, K and V streamed) and the dK/dV
kernel (128 keys a block, Q and dO streamed), each recomputing P from the
forward's lse, with no atomics; D = rowsum(dO * O) is a plain op before
them. On CPU tensors `flash_attention_bwd_plain`.

`flash_attention(q, k, v)` returns `out` and is differentiable: it runs as
the `FlashAttention` autograd Function, which saves q, k, v, out and lse
and takes `flash_attention_bwd` as its backward (no graph is recorded when
nothing needs a gradient).

The forward is the operator `torch.ops.videoswap.flash_fwd(q, k, v) ->
(out, lse)` (`flash_attention_fwd` calls it): its CUDA implementation is
`flash_attention_kernel`, its CPU implementation `flash_attention_plain`.
As an operator it is seen by a selective-checkpoint policy, which can keep
its outputs through a recompute (the U-Net's 'save_flash' mode; the JAX
package's `checkpoint_name(out, 'flash_out')` / `'flash_lse'` tags).
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

# launches of the CUDA kernels since the last reset: the forward, the dQ
# kernel and the dK/dV kernel
launches = 0
bwd_dq_launches = 0
bwd_dkv_launches = 0

# the head dims the wrappers take, forward and backward alike. Both kernel
# files instantiate these and 112 (their VS_FLASH_CASE lists), which the
# wrappers have never admitted.
HEAD_DIMS = (8, 16, 24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 120, 128, 152,
             160)


def flash_attention_plain(q, k, v, batch_chunk: int | None = None):
    """Materialised-softmax statement of the same function, with the
    arithmetic of `ops.attention.attention_with_probs` (the controlled
    sites' route), so that a site gives the same bits on either.
    `batch_chunk` bounds the (chunk, H, Sq, Sk) fp32 logits at large
    shapes."""
    b, sq, h, d = q.shape
    chunk = batch_chunk or b
    outs, lses = [], []
    for i in range(0, b, chunk):
        qc, kc, vc = q[i:i + chunk], k[i:i + chunk], v[i:i + chunk]
        logits = torch.einsum('bqhd,bkhd->bhqk', qc.float() * d ** -0.5,
                              kc.float())
        probs = torch.softmax(logits, dim=-1)
        # the largest probability is exp(max - lse): the logsumexp from two
        # reads of the logits-sized tensors, not four passes of its own
        lse = logits.amax(dim=-1) - probs.amax(dim=-1).log()
        lses.append(lse.reshape(-1, sq))
        outs.append(torch.einsum('bhqk,bkhd->bqhd', probs.to(v.dtype), vc))
    return torch.cat(outs).to(q.dtype), torch.cat(lses)


def flash_attention_bwd_plain(q, k, v, out, lse, dout,
                              batch_chunk: int | None = None):
    """The backward's decomposition in fp32: D = rowsum(dO * O),
    p = exp(q k^T s - lse), dv = p^T dO, ds = p (dO v^T - D), dq = ds k s,
    dk = ds^T q s. Returns (dq, dk, dv) in the dtypes of q, k, v.
    `batch_chunk` bounds the (chunk, H, Sq, Sk) fp32 temporaries."""
    b, sq, h, d = q.shape
    scale = d ** -0.5
    chunk = batch_chunk or b
    lse = lse.reshape(b, h, sq)
    dqs, dks, dvs = [], [], []
    for i in range(0, b, chunk):
        qc, kc, vc, oc, gc = (t[i:i + chunk].float()
                              for t in (q, k, v, out, dout))
        delta = torch.einsum('bqhd,bqhd->bhq', gc, oc)
        p = torch.exp(torch.einsum('bqhd,bkhd->bhqk', qc, kc) * scale
                      - lse[i:i + chunk, :, :, None].float())
        dvs.append(torch.einsum('bhqk,bqhd->bkhd', p, gc))
        ds = p * (torch.einsum('bqhd,bkhd->bhqk', gc, vc) - delta[..., None])
        del p
        dqs.append(torch.einsum('bhqk,bkhd->bqhd', ds, kc) * scale)
        dks.append(torch.einsum('bhqk,bqhd->bkhd', ds, qc) * scale)
    return (torch.cat(dqs).to(q.dtype), torch.cat(dks).to(k.dtype),
            torch.cat(dvs).to(v.dtype))


def _strides(*tensors):
    """The (batch, seq, head) element strides of each tensor, in order."""
    return (ctypes.c_longlong * (3 * len(tensors)))(
        *(s for t in tensors for s in t.stride()[:3]))


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
    if d not in HEAD_DIMS:
        raise ValueError(f'flash_attention kernel: head dim {d} must be one '
                         f'of {HEAD_DIMS}')
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
    lib = _build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    status = lib.vs_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr(), b, h, sq, sk, d, _strides(q, k, v, out), stream)
    _build.check(status, 'vs_flash_attention_fwd')
    launches += 1
    return out, lse


def _launch_bwd_dq(q, k, v, dout, lse, delta, dq):
    global bwd_dq_launches
    b, sq, h, d = q.shape
    status = _build.library().vs_flash_attention_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), b, h, sq, k.shape[1],
        d, _strides(q, k, v, dout, dq, dq, dq),   # no dk/dv: dq's slots
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, 'vs_flash_attention_bwd_dq')
    bwd_dq_launches += 1


def _launch_bwd_dkv(q, k, v, dout, lse, delta, dk, dv):
    global bwd_dkv_launches
    b, sq, h, d = q.shape
    status = _build.library().vs_flash_attention_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h,
        sq, k.shape[1], d, _strides(q, k, v, dout, dk, dk, dv),  # no dq
        torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(status, 'vs_flash_attention_bwd_dkv')
    bwd_dkv_launches += 1


def flash_attention_bwd_kernel(q, k, v, out, lse, dout, need_q=True,
                               need_kv=True):
    """(dq, dk, dv); the dQ kernel runs only if `need_q`, the dK/dV kernel
    only if `need_kv`, and a skipped gradient is None."""
    _check_kernel_args(q, k, v)
    b, sq, h, d = q.shape
    if out.shape != q.shape or lse.shape != (b * h, sq):
        raise ValueError(f'flash_attention backward: out {tuple(out.shape)}, '
                         f'lse {tuple(lse.shape)} for q {tuple(q.shape)}')
    if dout.shape != q.shape or dout.dtype != torch.bfloat16:
        raise ValueError(f'flash_attention backward: dout {dout.dtype} '
                         f'{tuple(dout.shape)} for q {tuple(q.shape)}')
    if dout.stride(3) != 1 or any(s % 8 for s in dout.stride()[:3]) \
            or dout.data_ptr() % 16:
        dout = dout.contiguous()
    # D = rowsum(dO * O), (B*H, Sq) fp32: a small plain op, as in the JAX
    # package, read by both kernels
    delta = torch.einsum('bqhd,bqhd->bhq', dout.float(), out.float()) \
        .reshape(b * h, sq).contiguous()
    lse = lse.float().contiguous()
    launch = b * sq * k.shape[1] > 0
    alloc = torch.empty_like if launch else torch.zeros_like
    dq = dk = dv = None
    if need_q:
        dq = alloc(q, memory_format=torch.contiguous_format)
        if launch:
            _launch_bwd_dq(q, k, v, dout, lse, delta, dq)
    if need_kv:
        dk, dv = (alloc(t, memory_format=torch.contiguous_format)
                  for t in (k, v))
        if launch:
            _launch_bwd_dkv(q, k, v, dout, lse, delta, dk, dv)
    return dq, dk, dv


@torch.library.custom_op('videoswap::flash_fwd', mutates_args=(),
                         device_types='cpu')
def flash_fwd(q: torch.Tensor, k: torch.Tensor,
              v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_plain(q, k, v)


@flash_fwd.register_kernel('cuda')
def _flash_fwd_cuda(q, k, v):
    return flash_attention_kernel(q, k, v)


@flash_fwd.register_fake
def _flash_fwd_fake(q, k, v):
    b, sq, h, _ = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b * h, sq), dtype=torch.float32))


def flash_attention_fwd(q, k, v):
    """q: (B, Sq, H, D); k, v: (B, Sk, H, D) -> (out, lse (B*H, Sq))."""
    return torch.ops.videoswap.flash_fwd(q, k, v)


def flash_attention_bwd(q, k, v, out, lse, dout, need_q=True,
                        need_kv=True):
    """The forward's saved tensors and dO -> (dq, dk, dv). On CUDA tensors
    a kernel whose gradients are not needed does not run (its outputs are
    None): at the cross-attention sites of adapter training k and v come
    from the frozen text encoder."""
    if q.is_cuda:
        return flash_attention_bwd_kernel(q, k, v, out, lse, dout, need_q,
                                          need_kv)
    return flash_attention_bwd_plain(q, k, v, out, lse, dout)


class FlashAttention(torch.autograd.Function):
    """out = softmax(q k^T / sqrt(D)) v with the flash backward."""

    @staticmethod
    def forward(ctx, q, k, v):
        out, lse = flash_attention_fwd(q, k, v)
        ctx.save_for_backward(q, k, v, out, lse)
        return out

    @staticmethod
    def backward(ctx, dout):
        need_q, need_k, need_v = ctx.needs_input_grad
        return flash_attention_bwd(*ctx.saved_tensors, dout, need_q,
                                   need_k or need_v)


def flash_attention(q, k, v):
    return FlashAttention.apply(q, k, v)
