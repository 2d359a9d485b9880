"""Fused AnimateDiff temporal transformer: a hand-written Hopper kernel and
its plain PyTorch version (the port of videoswap_tpu/ops/fused_temporal.py).

`fused_temporal_transformer(g2, x2, pe, flat, heads, f)` runs everything
`TemporalTransformer3DModel` does after its per-frame GroupNorm, for one
transformer block: proj_in -> 2 x [LayerNorm + sinusoidal PE -> frame-axis
attention -> out-proj -> residual] -> ff_norm -> GEGLU FFN (gelu_fast) ->
residual -> proj_out -> + x2. g2 (the GroupNorm output) and x2 (the
residual) are (L*F, C), rows ordered (location, frame). With
`include_ffn=False` it returns the hidden state after the attention blocks,
and `ffn_tail` finishes through the GEGLU kernel (the C = 640 split of the
JAX package). `fused_temporal_transformer_bfhw` takes the model's natural
frame-major (B, F, HW, C) layout instead.

`flat` holds the parameters in the order of the JAX package's
`flatten_tt_params`, torch `Linear` layout ([out, in]) for matrices;
`flat_params(module, include_ffn)` reads them from the port's module.
Matrices are in the compute dtype, vectors (LayerNorm scales and biases,
biases) in fp32; `pe` is the (F, C) position table in the compute dtype.

A CUDA tensor launches `csrc/fused_temporal.cu` (bf16; C a multiple of 64
up to 640, head dim a multiple of 8 up to 80) or raises; a CPU tensor takes
`fused_temporal_plain`, the port of `_xla_reference`. Both entry points are
differentiable: their backward differentiates the plain version by
recompute, as the JAX custom VJPs do, a chunk of locations at a time.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from .geglu_ffn import geglu_ffn, gelu_fast

# launches of the CUDA kernel since the last reset: rows ordered (location,
# frame), and the frame-major (B, F, HW, C) layout
launches = 0
bfhw_launches = 0

MAX_HEAD_DIM = 80
N_FLAT = {True: 24, False: 16}     # parameters of one block, with(out) FFN
# locations a backward recompute takes at a time (bounds its activations)
_BWD_LOCATIONS = 2048


def kernel_supports(c: int, heads: int, f: int) -> bool:
    d = c // heads if heads else 0
    return (c % 64 == 0 and c <= 640 and c % heads == 0 and d % 8 == 0
            and d <= MAX_HEAD_DIM and 1 <= f <= (64 if c <= 320 else 32))


def flat_params(tt, include_ffn: bool) -> list:
    """A `TemporalTransformer3DModel`'s parameters (one block) in the order
    of `flatten_tt_params`: matrices as they are, vectors in fp32."""
    blk = tt.transformer_blocks[0]
    ps = [tt.proj_in.weight, tt.proj_in.bias]
    for norm, attn in zip(blk.norms, blk.attention_blocks):
        ps += [norm.weight, norm.bias, attn.to_q.weight, attn.to_k.weight,
               attn.to_v.weight, attn.to_out[0].weight, attn.to_out[0].bias]
    if include_ffn:
        proj, out = blk.ff.net[0].proj, blk.ff.net[2]
        ps += [blk.ff_norm.weight, blk.ff_norm.bias, proj.weight, proj.bias,
               out.weight, out.bias, tt.proj_out.weight, tt.proj_out.bias]
    return [p if p.dim() == 2 else p.float() for p in ps]


def _layer_norm(h, g, b, eps: float = 1e-6):
    h32 = h.float()
    mu = h32.mean(-1, keepdim=True)
    var = ((h32 - mu) ** 2).mean(-1, keepdim=True)
    return (h32 - mu) * torch.rsqrt(var + eps) * g + b


def fused_temporal_plain(g2, x2, pe, flat, heads: int, f: int,
                         n_blocks: int = 1, include_ffn: bool = True):
    """The same function in plain PyTorch (`_xla_reference`): products in
    the input dtype, LayerNorm, softmax and the hidden state in fp32."""
    n, c = x2.shape
    d = c // heads
    dt = x2.dtype
    ps = list(flat)

    def take(k):
        vals = ps[:k]
        del ps[:k]
        return vals

    w_in, b_in = take(2)
    h = F.linear(g2, w_in.to(dt)).float() + b_in
    pe_rows = pe[:f].float().repeat(n // f, 1)
    for _ in range(n_blocks):
        for _ in (0, 1):
            ln_g, ln_b, wq, wk, wv, wo, bo = take(7)
            a_in = (_layer_norm(h, ln_g, ln_b) + pe_rows).to(dt)
            q, k, v = (F.linear(a_in, w.to(dt)).reshape(n // f, f, heads, d)
                       for w in (wq, wk, wv))
            s = torch.einsum('lfhd,lghd->lfgh', q.float(), k.float()) \
                * d ** -0.5
            p = torch.softmax(s, dim=2)
            o = torch.einsum('lfgh,lghd->lfhd', p.to(dt), v).reshape(n, c)
            h = h + F.linear(o, wo.to(dt)).float() + bo
        if include_ffn:
            fn_g, fn_b, w1, b1, w2, b2 = take(6)
            ln = _layer_norm(h, fn_g, fn_b).to(dt)
            a, gate = (F.linear(ln, w1.to(dt)).float() + b1).chunk(2, dim=-1)
            gg = a * gelu_fast(gate)
            h = h + F.linear(gg.to(dt), w2.to(dt)).float() + b2
    if not include_ffn:
        return h.to(dt)
    w_out, b_out = take(2)
    return (x2.float() + F.linear(h.to(dt), w_out.to(dt)).float()
            + b_out).to(dt)


def rows_of(a4):
    """(B, F, HW, C) -> (B*HW*F, C), rows ordered (location, frame)."""
    b, f, hw, c = a4.shape
    return a4.permute(0, 2, 1, 3).reshape(b * hw * f, c)


def unrows(a2, b: int, f: int, hw: int):
    return a2.reshape(b, hw, f, a2.shape[-1]).permute(0, 2, 1, 3)


def fused_temporal_plain_bfhw(g4, x4, pe, flat, heads: int, f: int,
                              n_blocks: int = 1, include_ffn: bool = True):
    b, _, hw, _ = x4.shape
    out = fused_temporal_plain(rows_of(g4), rows_of(x4), pe, flat, heads, f,
                               n_blocks, include_ffn)
    return unrows(out, b, f, hw).contiguous()


def _check_kernel_args(g, x, pe, flat, heads, f, n_blocks, include_ffn):
    c = x.shape[-1]
    if n_blocks != 1:
        raise ValueError('fused_temporal kernel runs one transformer block, '
                         f'got {n_blocks}')
    if len(flat) != N_FLAT[include_ffn]:
        raise ValueError(f'fused_temporal: expected {N_FLAT[include_ffn]} '
                         f'parameters, got {len(flat)}')
    tensors = (g, x, pe, *flat)
    if any(t.device != x.device for t in tensors):
        raise ValueError('fused_temporal: all tensors must be on one device')
    for t in (g, x, pe, *(p for p in flat if p.dim() == 2)):
        if t.dtype != torch.bfloat16:
            raise TypeError(f'fused_temporal kernel takes bf16 activations '
                            f'and matrices, got {t.dtype}')
    if any(p.dtype != torch.float32 for p in flat if p.dim() == 1):
        raise TypeError('fused_temporal kernel takes fp32 vectors')
    if not kernel_supports(c, heads, f):
        raise ValueError(f'fused_temporal kernel: C={c} (a multiple of 64 '
                         f'<= 640), heads={heads} (head dim a multiple of 8 '
                         f'<= {MAX_HEAD_DIM}), F={f}')
    if g.shape != x.shape or tuple(pe.shape) != (f, c):
        raise ValueError(f'fused_temporal: g {tuple(g.shape)}, x '
                         f'{tuple(x.shape)}, pe {tuple(pe.shape)}')
    shapes = [(c, c), (c,)] + [(c,), (c,), (c, c), (c, c), (c, c), (c, c),
                               (c,)] * 2
    if include_ffn:
        shapes += [(c,), (c,), (8 * c, c), (8 * c,), (c, 4 * c), (c,),
                   (c, c), (c,)]
    for t, shape in zip(flat, shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f'fused_temporal: parameter {tuple(t.shape)}, '
                             f'expected {shape}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('fused_temporal kernel takes contiguous tensors')
    if g.data_ptr() % 16:
        raise ValueError('fused_temporal kernel needs a 16-byte aligned g')


def _launch(g, x, pe, flat, heads, f, include_ffn, layout, n_loc, batch):
    global launches, bfhw_launches
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    c = x.shape[-1]
    ptrs = [t.data_ptr() for t in (g, x, out, pe, *flat)]
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.vs_fused_temporal(
        (ctypes.c_void_p * len(ptrs))(*ptrs), len(ptrs), c, heads, f,
        int(include_ffn), layout, n_loc, batch, (c // heads) ** -0.5, stream)
    _build.check(status, 'vs_fused_temporal')
    if layout:
        bfhw_launches += 1
    else:
        launches += 1
    return out


def fused_temporal_kernel(g2, x2, pe, flat, heads: int, f: int,
                          n_blocks: int = 1, include_ffn: bool = True):
    _check_kernel_args(g2, x2, pe, flat, heads, f, n_blocks, include_ffn)
    n = x2.shape[0]
    if n % f:
        raise ValueError(f'fused_temporal: {n} rows are not whole '
                         f'locations of {f} frames')
    return _launch(g2, x2, pe, flat, heads, f, include_ffn, 0, n // f, 1)


def fused_temporal_kernel_bfhw(g4, x4, pe, flat, heads: int, f: int,
                               n_blocks: int = 1, include_ffn: bool = True):
    _check_kernel_args(g4, x4, pe, flat, heads, f, n_blocks, include_ffn)
    b, f_, hw, _ = x4.shape
    if f_ != f:
        raise ValueError(f'fused_temporal_bfhw: {f_} frames, expected {f}')
    return _launch(g4, x4, pe, flat, heads, f, include_ffn, 1, hw, b)


def _plain_grads(plain, inputs, dout, needs, rows, chunk):
    """Gradients of `plain(g, x, *flat)` for the inputs that need them,
    by recompute, `chunk` rows at a time (rows are independent between
    locations): the graph of one chunk is alive at a time."""
    g, x, flat = inputs[0], inputs[1], inputs[2:]
    grads = [torch.zeros_like(t) if need else None
             for t, need in zip(inputs, needs)]
    for i in range(0, rows, chunk):
        sl = slice(i, i + chunk)
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(need)
                      for t, need in zip((g[sl], x[sl], *flat), needs)]
            out = plain(*leaves)
            want = [t for t in leaves if t.requires_grad]
            got = iter(torch.autograd.grad(out, want, dout[sl],
                                           allow_unused=True))
        for j, t in enumerate(leaves):
            if not t.requires_grad:
                continue
            gj = next(got)
            if gj is None:
                continue
            if j < 2:
                grads[j][sl] = gj
            else:
                grads[j] += gj
    return grads


class FusedTemporal(torch.autograd.Function):
    """Both layouts: `bfhw` False takes (L*F, C) rows, True (B, F, HW, C)."""

    @staticmethod
    def forward(ctx, g, x, pe, heads, f, n_blocks, include_ffn, bfhw, *flat):
        ctx.save_for_backward(g, x, pe, *flat)
        ctx.args = (heads, f, n_blocks, include_ffn)
        ctx.bfhw = bfhw
        if bfhw:
            fn = (fused_temporal_kernel_bfhw if x.is_cuda
                  else fused_temporal_plain_bfhw)
        else:
            fn = fused_temporal_kernel if x.is_cuda else fused_temporal_plain
        return fn(g, x, pe, list(flat), heads, f, n_blocks, include_ffn)

    @staticmethod
    def backward(ctx, dout):
        g, x, pe, *flat = ctx.saved_tensors
        heads, f, n_blocks, inc = ctx.args
        needs = (*ctx.needs_input_grad[:2], *ctx.needs_input_grad[8:])
        if ctx.bfhw:
            b, _, hw, _ = x.shape
            g, x, dout = rows_of(g), rows_of(x), rows_of(dout)
        grads = _plain_grads(
            lambda g_, x_, *fp: fused_temporal_plain(g_, x_, pe, fp, heads,
                                                     f, n_blocks, inc),
            (g, x, *flat), dout, needs, x.shape[0], _BWD_LOCATIONS * f)
        if ctx.bfhw:
            grads[:2] = [None if t is None else unrows(t, b, f, hw)
                         .contiguous() for t in grads[:2]]
        return (grads[0], grads[1], None, None, None, None, None, None,
                *grads[2:])


def fused_temporal_transformer(g2, x2, pe, flat, heads: int, f: int,
                               n_blocks: int = 1, include_ffn: bool = True):
    """g2, x2: (L*F, C), rows (location, frame) -> (L*F, C)."""
    return FusedTemporal.apply(g2, x2, pe, heads, f, n_blocks, include_ffn,
                               False, *flat)


def fused_temporal_transformer_bfhw(g4, x4, pe, flat, heads: int, f: int,
                                    n_blocks: int = 1,
                                    include_ffn: bool = True):
    """g4, x4: (B, F, HW, C) -> (B, F, HW, C)."""
    return FusedTemporal.apply(g4, x4, pe, heads, f, n_blocks, include_ffn,
                               True, *flat)


def ffn_tail(h2, x2, tt):
    """ff_norm -> GEGLU FFN (the GEGLU kernel) -> residual -> proj_out -> +
    x2: the continuation after an include_ffn=False call. h2 arrives in the
    compute dtype, as the JAX package's does (the residual stream is rounded
    between the two halves)."""
    blk = tt.transformer_blocks[0]
    dt = x2.dtype
    ln = _layer_norm(h2, blk.ff_norm.weight.float(),
                     blk.ff_norm.bias.float()).to(dt)
    proj, out = blk.ff.net[0].proj, blk.ff.net[2]
    h2 = h2 + geglu_ffn(ln, proj.weight, proj.bias, out.weight,
                        out.bias).to(h2.dtype)
    o = F.linear(h2.to(dt), tt.proj_out.weight.to(dt)).float() \
        + tt.proj_out.bias.float()
    return (x2.float() + o).to(dt)
