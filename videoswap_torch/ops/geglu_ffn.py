"""GEGLU feed-forward: hand-written Hopper kernels and their plain PyTorch
versions.

`geglu_ffn(x, w1, b1, w2, b2)` computes `(a * gelu_fast(gate)) @ w2.T + b2`
with `[a | gate] = x @ w1.T + b1`, for x (N, C), w1 (2H, C), w2 (C, H) in
the torch `Linear` layout: H = 4C hidden units, or a tensor-parallel rank's
4C / tp (parallel/sharding.py), a multiple of 32 for the fused kernel. The
result has x's dtype.

A CUDA tensor (bf16 only) takes one of two routes, chosen by width alone as
the JAX package's `geglu_ffn` chooses between its Pallas kernel and XLA:

- C <= MAX_KERNEL_WIDTH (640): the fused kernel `csrc/geglu_ffn.cu`, which
  keeps the 4C intermediate on chip (C a multiple of 64 up to 320, or of
  128 up to 640);
- wider: the split route, `F.linear(x, w1, b1)`, the hand-written gate pass
  (`geglu_gate`, same file) and `F.linear(g, w2, b2)`.

Either launches its kernel or raises. A CPU tensor takes `geglu_ffn_plain`
(and `geglu_gate` takes `geglu_gate_plain`). The kernels use the same
`gelu_fast` polynomial as the plain versions.

`geglu_ffn` is differentiable. Its backward, `geglu_ffn_bwd_plain`, is plain
PyTorch on either device, as the JAX package's is plain XLA: it recomputes
the projection and writes out the derivative of `gelu_fast`, so it keeps
no autograd graph of the polynomial, and it computes only the gradients
asked for (dX alone when the weights are frozen).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

# launches of the fused kernel and of the split route's gate pass since the
# last reset
launches = 0
gate_launches = 0

# erf(u) ~ u * q(u^2/9) on |u| <= 3, sign(u) outside: the Horner form of the
# degree-10 fit in videoswap_tpu/ops/geglu_ffn.py (|gelu error| <= 4.7e-5)
_ERF_HORNER = (1.4207271411, -8.8140112788, 24.913610011, -43.054002726,
               51.767980495, -46.861629272, 33.590318391, -19.508373138,
               9.1353631098, -3.3850338503, 1.1283787715)

# the JAX package's gate (videoswap_tpu/ops/geglu_ffn.py): wider FFNs take
# the split route
MAX_KERNEL_WIDTH = 640
# the fused kernel walks the hidden units in chunks of this many
FUSED_CHUNK = 32


def takes_fused_route(c: int) -> bool:
    return c <= MAX_KERNEL_WIDTH


def fused_supports(c: int) -> bool:
    """Widths the fused kernel has an instantiation for."""
    return c % 64 == 0 and 0 < c <= MAX_KERNEL_WIDTH and (c <= 320
                                                          or c % 128 == 0)


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


def geglu_gate_plain(h: torch.Tensor) -> torch.Tensor:
    """h (N, 2H) -> a * gelu_fast(gate) (N, H), in h's dtype: in bf16
    gate / sqrt(2) is rounded before the polynomial, then gelu_fast(gate)
    and the product, as the JAX package's `_xla_reference` rounds them
    (which scales by 1/sqrt(2) rounded to bf16)."""
    a, gate = h.chunk(2, dim=-1)
    return a * gelu_fast(gate)


def geglu_ffn_plain(x, w1, b1, w2, b2):
    # biases promote as in the JAX package (fp32 biases give an fp32
    # intermediate); the result has x's dtype
    h = F.linear(x, w1.to(x.dtype)) + b1
    g = geglu_gate_plain(h)
    return (F.linear(g, w2.to(g.dtype)) + b2).to(x.dtype)


def _check_kernel_args(x, w1, b1, w2, b2):
    n, c = x.shape
    tensors = (x, w1, b1, w2, b2)
    if any(t.device != x.device for t in tensors):
        raise ValueError('geglu_ffn: all tensors must be on one device')
    if any(t.dtype != torch.bfloat16 for t in tensors):
        raise TypeError('geglu_ffn kernels take bf16 tensors, got '
                        f'{[str(t.dtype) for t in tensors]}')
    if takes_fused_route(c) and not fused_supports(c):
        raise ValueError('geglu_ffn: the fused kernel (C <= '
                         f'{MAX_KERNEL_WIDTH}) needs C a multiple of 64 up '
                         f'to 320, or of 128; got C={c}')
    if not takes_fused_route(c) and c % 2:
        raise ValueError(f'geglu_ffn: the gate pass (C > {MAX_KERNEL_WIDTH})'
                         f' needs an even C; got C={c}')
    hid = w2.shape[1]
    if takes_fused_route(c) and (hid <= 0 or hid % FUSED_CHUNK):
        raise ValueError('geglu_ffn: the fused kernel needs a hidden width '
                         f'that is a multiple of {FUSED_CHUNK}; got {hid}')
    shapes = ((2 * hid, c), (2 * hid,), (c, hid), (c,))
    for t, shape in zip(tensors[1:], shapes):
        if tuple(t.shape) != shape:
            raise ValueError(f'geglu_ffn: expected {shape}, got '
                             f'{tuple(t.shape)}')
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError('geglu_ffn kernels take contiguous tensors')
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError('geglu_ffn kernels need 16-byte aligned x, w1, w2')


def geglu_gate_kernel(h):
    """The split route's gate pass on the card: h (N, 8C) bf16 ->
    bf16 a * gelu_fast(gate) (N, 4C)."""
    global gate_launches
    if h.dtype != torch.bfloat16:
        raise TypeError(f'geglu_gate kernel takes bf16, got {h.dtype}')
    if (h.dim() != 2 or h.shape[1] % 16 or not h.is_contiguous()
            or h.data_ptr() % 16):
        raise ValueError('geglu_gate kernel takes a contiguous, 16-byte '
                         'aligned (N, 8C) tensor with C even, got '
                         f'{tuple(h.shape)}')
    n, inner = h.shape[0], h.shape[1] // 2
    g = h.new_empty((n, inner))
    if n == 0:
        return g
    lib = _build.library()
    stream = torch.cuda.current_stream(h.device).cuda_stream
    _build.check(lib.vs_geglu_gate(h.data_ptr(), g.data_ptr(), n, inner,
                                   stream), 'vs_geglu_gate')
    gate_launches += 1
    return g


def geglu_gate(h):
    if h.is_cuda:
        return geglu_gate_kernel(h)
    return geglu_gate_plain(h)


def geglu_ffn_split(x, w1, b1, w2, b2):
    """The route above MAX_KERNEL_WIDTH, as the JAX package's XLA route:
    two cuBLAS products around the gate pass."""
    return F.linear(geglu_gate(F.linear(x, w1, b1)), w2, b2)


def geglu_ffn_kernel(x, w1, b1, w2, b2):
    global launches
    _check_kernel_args(x, w1, b1, w2, b2)
    n, c = x.shape
    if not takes_fused_route(c):
        return geglu_ffn_split(x, w1, b1, w2, b2)
    out = torch.empty_like(x)
    if n == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    status = lib.vs_geglu_ffn(x.data_ptr(), w1.data_ptr(), b1.data_ptr(),
                              w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                              n, c, w2.shape[1], stream)
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
        a, gate = (F.linear(xs, w1c) + b1).chunk(2, dim=-1)
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
    """x: (N, C); w1: (2H, C); b1: (2H,); w2: (C, H); b2: (C,), with H =
    4C, or 4C / tp on a tensor-parallel rank."""
    return GegluFFN.apply(x, w1, b1, w2, b2)
