"""Fused GroupNorm affine -> SiLU -> 3x3 convolution: a hand-written Hopper
kernel and its plain PyTorch version (the port of the JAX package's
`fused_gn_silu_conv` experiment, scripts/bench_resnet_fused.py).

Unrouted, as in the JAX package: the U-Net's resnets run GroupNorm, SiLU
and the convolution layer by layer (`models/resnet3d.py`); this op is the
counterpart of the JAX package's fused kernel, run by `chip_smoke.py`'s
`unrouted` phase at the benchmark's shapes and on the U-Net's own level-0
and level-1 resnet inputs.

The GroupNorm statistics are plain ops outside the kernel (`gn_stats`), as
in the JAX package, folded with the affine into per-(image, channel) fp32
`scale` and `shift` (`gn_scale_shift`). `gn_silu_conv_kernel(x, scale,
shift, weight, bias)` takes x (N, H, W, Cin) bf16 on the card (Cin a
multiple of 16, Cout of 8), the weight in torch's OIHW layout (that of
`InflatedConv`'s `nn.Conv2d`), and returns (N, H, W, Cout) bf16; it raises
on what it does not take. `gn_silu_conv_plain` is the same arithmetic in
fp32: the activation is rounded to bf16 before the convolution, as the
kernel does, and the zero padding is applied after the activation. (The JAX
kernel pads x with the value whose affine image is 0, which fails for a
channel with gamma = 0; the port follows the JAX package's XLA version.)

The kernel (csrc/gn_silu_conv.cu) reads the weight packed by
`pack_weight` (Cout, 3, 3, Cin) and tiles each image by `plan`: column
segments flattened at a pitch of their width + 2, blocks of ROWS such
virtual rows, the taps shifted windows of one staged halo. Both are plain
Python here, so that the CPU tests hold the arithmetic on that tiling to
the plain version (tests/test_torch_unrouted.py) and the card's tests the
library's plan to this one. At most 65535 images and 65535 tiles an image
a call; more raise.

`fused_gn_silu_conv(x, gamma, beta, weight, bias)` is the per-image wrapper
with the JAX signature: statistics over each image's (H, W). The U-Net's
`ResnetBlock3D` takes them over a video's (F, H, W) instead: give
`gn_silu_conv_kernel` the video's scale and shift repeated over its frames.
Forward only: the JAX function has no VJP.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0


def gn_stats(x, groups: int, eps: float = 1e-5):
    """Per-sample GroupNorm statistics of a channels-last (N, ..., C)
    tensor over every non-batch axis: (mean, rstd), each (N, groups) fp32."""
    n, c = x.shape[0], x.shape[-1]
    xg = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xg, dim=(1, 3), correction=0)
    return mean, torch.rsqrt(var + eps)


def gn_scale_shift(mean, rstd, gamma, beta):
    """(N, G) statistics and the (C,) affine -> per-(sample, channel) fp32
    scale and shift with GroupNorm(x) = x * scale + shift."""
    rep = gamma.shape[0] // mean.shape[1]
    scale = rstd.repeat_interleave(rep, dim=1) * gamma.float()
    shift = beta.float() - mean.repeat_interleave(rep, dim=1) * scale
    return scale.contiguous(), shift.contiguous()


def gn_silu_conv_plain(x, scale, shift, weight, bias):
    """x (N, H, W, Cin), scale/shift (N, Cin), weight (Cout, Cin, 3, 3),
    bias (Cout,) -> (N, H, W, Cout) in x's dtype, computed in fp32."""
    y = x.float() * scale[:, None, None, :] + shift[:, None, None, :]
    a = F.silu(y).to(torch.bfloat16).float()
    out = F.conv2d(a.permute(0, 3, 1, 2), weight.float(), bias.float(),
                   padding=1)
    return out.permute(0, 2, 3, 1).to(x.dtype)


def pack_weight(weight):
    """OIHW (Cout, Cin, 3, 3) -> the kernel's (Cout, 3, 3, Cin) bf16: each
    output channel's K = 9 * Cin row, (ky * 3 + kx) * Cin + ci, contiguous
    (the K-major B operand its weight tiles are read from)."""
    return weight.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


# the kernel's tiling (csrc/gn_silu_conv.cu `plan`): blocks of ROWS
# virtual output rows, column segments of at most SEGMENT_MAX columns
ROWS = 256
SEGMENT_MAX = 64
GRID_MAX = 65535


def plan(h: int, w: int) -> tuple[int, int, int, int]:
    """(tw, pw, segments, tiles) of an h x w image: `segments` column
    segments of tw columns (the last may hold fewer), each a flattened
    zero-padded image of pitch pw = tw + 2 in which output pixel (y, x) is
    virtual row y * pw + x, and `tiles` blocks of ROWS virtual rows a
    segment (the last one partly full). Tap (dy, dx) of virtual row v reads
    the padded position v + dy * pw + dx."""
    segments = -(-w // SEGMENT_MAX)
    tw = -(-w // segments)
    return tw, tw + 2, segments, -(-h * (tw + 2) // ROWS)


def library_plan(h: int, w: int) -> tuple[int, int, int, int]:
    """`plan` as the built library computes it (the card's tests hold the
    two equal). Needs the built library, so the card."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().vs_gn_silu_conv_plan(h, w, out),
                 'vs_gn_silu_conv_plan')
    return tuple(out)


def _launch(x, scale, shift, w_packed, bias, out):
    """Launch the kernel on checked tensors."""
    global launches
    n, h, w, cin = x.shape
    status = _build.library().vs_gn_silu_conv(
        x.data_ptr(), scale.data_ptr(), shift.data_ptr(), w_packed.data_ptr(),
        bias.data_ptr(), out.data_ptr(), n, h, w, cin, out.shape[-1],
        torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(status, 'vs_gn_silu_conv')
    launches += 1


def gn_silu_conv_kernel(x, scale, shift, weight, bias):
    if x.dim() != 4 or weight.dim() != 4 or weight.shape[2:] != (3, 3):
        raise ValueError(f'gn_silu_conv: x {tuple(x.shape)} (N, H, W, C), '
                         f'weight {tuple(weight.shape)} (Cout, Cin, 3, 3)')
    n, h, w, cin = x.shape
    cout = weight.shape[0]
    if weight.shape[1] != cin or scale.shape != (n, cin) \
            or shift.shape != (n, cin) or bias.shape != (cout,):
        raise ValueError(f'gn_silu_conv: x {tuple(x.shape)}, scale '
                         f'{tuple(scale.shape)}, shift {tuple(shift.shape)}, '
                         f'weight {tuple(weight.shape)}, bias '
                         f'{tuple(bias.shape)}')
    if any(t.device != x.device for t in (scale, shift, weight, bias)):
        raise ValueError('gn_silu_conv: tensors on different devices')
    if x.dtype != torch.bfloat16:
        raise TypeError('gn_silu_conv kernel takes a bf16 input')
    if any(t.dtype != torch.float32 for t in (scale, shift)):
        raise TypeError('gn_silu_conv kernel takes fp32 scale and shift')
    if cin % 16 or cout % 8:
        raise ValueError(f'gn_silu_conv kernel: Cin {cin} must be a multiple '
                         f'of 16 and Cout {cout} of 8')
    x, scale, shift = (t.contiguous() for t in (x, scale, shift))
    if any(t.data_ptr() % 16 for t in (x, scale, shift)):
        raise ValueError('gn_silu_conv kernel needs 16-byte aligned x, '
                         'scale and shift')
    out = torch.empty((n, h, w, cout), dtype=torch.bfloat16, device=x.device)
    if out.numel() == 0:
        return out
    _, _, segments, tiles = plan(h, w)
    if n > GRID_MAX or segments * tiles > GRID_MAX:
        raise ValueError(f'gn_silu_conv kernel: at most {GRID_MAX} images '
                         f'and {GRID_MAX} tiles an image, not {n} images of '
                         f'{segments * tiles} tiles ({h} x {w})')
    _launch(x, scale, shift, pack_weight(weight),
            bias.float().contiguous(), out)
    return out


def fused_gn_silu_conv(x, gamma, beta, weight, bias, groups: int = 32,
                       eps: float = 1e-5):
    """GroupNorm over each image's (H, W) -> SiLU -> 3x3 conv, pad 1:
    x (N, H, W, Cin), gamma/beta (Cin,), weight OIHW, bias (Cout,)."""
    scale, shift = gn_scale_shift(*gn_stats(x, groups, eps), gamma, beta)
    if x.is_cuda:
        return gn_silu_conv_kernel(x, scale, shift, weight, bias)
    return gn_silu_conv_plain(x, scale, shift, weight, bias)
