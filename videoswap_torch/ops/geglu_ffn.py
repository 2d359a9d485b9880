"""Fused GEGLU feed-forward: a hand-written Hopper kernel and its plain
PyTorch version.

`geglu_ffn(x, w1, b1, w2, b2)` computes `(a * gelu_fast(gate)) @ w2.T + b2`
with `[a | gate] = x @ w1.T + b1`, for x (N, C), w1 (8C, C), w2 (C, 4C) in
the torch `Linear` layout. The result has x's dtype.

A CUDA tensor launches `csrc/geglu_ffn.cu` (bf16 only; C a multiple of 128
up to 1280, or of 64 up to 320) or raises; a CPU tensor takes
`geglu_ffn_plain`. The kernel uses the same `gelu_fast` polynomial as the
plain version.

`geglu_ffn` is differentiable. Its backward, `geglu_ffn_bwd_plain`, is plain
PyTorch on either device, as the JAX package's is plain XLA: it recomputes
the projection and writes out the derivative of `gelu_fast`, so it keeps
no autograd graph of the polynomial, and it computes only the gradients
asked for (dX alone when the weights are frozen).
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

# erf(u) ~ u * q(u^2/9) on |u| <= 3, sign(u) outside: the Horner form of the
# degree-10 fit in videoswap_tpu/ops/geglu_ffn.py (|gelu error| <= 4.7e-5)
_ERF_HORNER = (1.4207271411, -8.8140112788, 24.913610011, -43.054002726,
               51.767980495, -46.861629272, 33.590318391, -19.508373138,
               9.1353631098, -3.3850338503, 1.1283787715)

MAX_KERNEL_WIDTH = 1280   # register accumulator: <= 80 floats a thread


def kernel_supports(c: int) -> bool:
    return (c % 128 == 0 and c <= MAX_KERNEL_WIDTH) or (c % 64 == 0
                                                        and c <= 320)


def _erf_fast(u: torch.Tensor) -> torch.Tensor:
    u = u.float()
    s = torch.clamp(u * u * (1.0 / 9.0), max=1.0)
    q = torch.full_like(s, _ERF_HORNER[0])
    for c in _ERF_HORNER[1:]:
        q = q * s + c
    return torch.clamp(u * q, -1.0, 1.0)


def gelu_fast(x: torch.Tensor) -> torch.Tensor:
    """Division/exp-free GELU (|err| <= 4.7e-5), fp32 inside, result in the
    input dtype."""
    return (0.5 * x.float() * (1.0 + _erf_fast(x * (2.0 ** -0.5)))).to(x.dtype)


def _gelu_fast_and_grad(x: torch.Tensor):
    """gelu_fast(x) and its derivative, both fp32 (x fp32)."""
    u = x * (2.0 ** -0.5)
    s_raw = u * u * (1.0 / 9.0)
    s = torch.clamp(s_raw, max=1.0)
    q = torch.full_like(s, _ERF_HORNER[0])
    dq = torch.zeros_like(s)
    for c in _ERF_HORNER[1:]:
        dq = dq * s + q
        q = q * s + c
    e_raw = u * q
    erf = torch.clamp(e_raw, -1.0, 1.0)
    # d(u q(s))/du, with s = min(u^2/9, 1) and the clamp of erf to [-1, 1]
    derf = q + u * dq * torch.where(s_raw < 1.0, u * (2.0 / 9.0), 0.0)
    derf = torch.where(e_raw.abs() <= 1.0, derf, 0.0)
    return (0.5 * x * (1.0 + erf),
            0.5 * (1.0 + erf) + 0.5 * x * derf * (2.0 ** -0.5))


def geglu_ffn_plain(x, w1, b1, w2, b2):
    # biases promote as in the JAX package (fp32 biases give an fp32
    # intermediate); the result has x's dtype
    h = torch.nn.functional.linear(x, w1.to(x.dtype)) + b1
    a, gate = h.chunk(2, dim=-1)
    g = a * gelu_fast(gate)
    return (torch.nn.functional.linear(g, w2.to(g.dtype)) + b2).to(x.dtype)


def _check_kernel_args(x, w1, b1, w2, b2):
    n, c = x.shape
    tensors = (x, w1, b1, w2, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError('geglu_ffn: all tensors must be on one device')
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError('geglu_ffn kernel takes bf16 tensors, got '
                        f'{[str(t.dtype) for t in tensors]}')
    if not kernel_supports(c):
        raise ValueError(f'geglu_ffn kernel needs C a multiple of 128 up to '
                         f'{MAX_KERNEL_WIDTH}, or of 64 up to 320; got C={c}')
    shapes = ((8 * c, c), (8 * c,), (c, 4 * c), (c,))
    for t, shape in zip(tensors[1:], shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f'geglu_ffn: expected {shape}, got '
                             f'{tuple(t.shape)}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('geglu_ffn kernel takes contiguous tensors')
    if x.data_ptr() % 16:
        raise ValueError('geglu_ffn kernel needs a 16-byte aligned x')


def geglu_ffn_kernel(x, w1, b1, w2, b2):
    global launches
    _check_kernel_args(x, w1, b1, w2, b2)
    n, c = x.shape
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.vs_geglu_ffn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                              w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                              n, c, stream)
    _build.check(status, 'vs_geglu_ffn')
    launches += 1
    return out


def geglu_ffn_bwd_plain(x, w1, b1, w2, b2, dout,
                        needs=(True, True, True, True, True)):
    """Gradients of geglu_ffn_plain for (x, w1, b1, w2, b2), None where
    `needs` is False. Products run in x's dtype, the gate's derivative in
    fp32; rows go in chunks so that the (rows, 4C) fp32 temporaries stay
    bounded at the largest U-Net level."""
    n, c = x.shape
    inner = w2.shape[1]
    dt = x.dtype
    w1c, w2c = w1.to(dt), w2.to(dt)
    dx = torch.empty_like(x) if needs[0] else None
    acc = [torch.zeros(t.shape, dtype=torch.float32, device=x.device)
           if need else None
           for t, need in zip((w1, b1, w2, b2), needs[1:])]
    rows = max(1, (1 << 24) // inner)
    for i in range(0, n, rows):
        xs, gs = x[i:i + rows], dout[i:i + rows].to(dt)
        a, gate = (torch.nn.functional.linear(xs, w1c) + b1).chunk(2, dim=-1)
        af = a.float()
        gelu, dgelu = _gelu_fast_and_grad(gate.float())
        dg = (gs @ w2c).float()
        dh = torch.cat([dg * gelu, dg * af * dgelu], dim=-1).to(dt)
        if dx is not None:
            dx[i:i + rows] = dh @ w1c
        if acc[0] is not None:
            acc[0] += (dh.t() @ xs).float()
        if acc[1] is not None:
            acc[1] += dh.float().sum(0)
        if acc[2] is not None:
            acc[2] += (gs.t() @ (af * gelu).to(dt)).float()
        if acc[3] is not None:
            acc[3] += gs.float().sum(0)
    return (dx, *(g.to(t.dtype) if g is not None else None
                  for g, t in zip(acc, (w1, b1, w2, b2))))


class GegluFFN(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, b1, w2, b2):
        ctx.save_for_backward(x, w1, b1, w2, b2)
        if x.is_cuda:
            return geglu_ffn_kernel(x, w1, b1, w2, b2)
        return geglu_ffn_plain(x, w1, b1, w2, b2)

    @staticmethod
    def backward(ctx, dout):
        return geglu_ffn_bwd_plain(*ctx.saved_tensors, dout,
                                   ctx.needs_input_grad)


def geglu_ffn(x, w1, b1, w2, b2):
    """x: (N, C); w1: (8C, C); b1: (8C,); w2: (C, 4C); b2: (C,)."""
    return GegluFFN.apply(x, w1, b1, w2, b2)
