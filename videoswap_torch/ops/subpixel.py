"""Nearest-2x upsample + 3x3 conv as four 2x2 phase convs (the port of
videoswap_tpu/ops/subpixel.py).

Nearest upsampling makes x_up[p] = x[p // 2], so per output phase
(p mod 2, q mod 2) the 3x3 conv over the upsampled grid is a 2x2 conv over
the low-resolution input whose taps are sums of the original taps:

    a=0: offsets (-1, 0, 0) -> taps [w0, w1+w2], pad (1, 0)
    a=1: offsets ( 0, 0, 1) -> taps [w0+w1, w2], pad (0, 1)

per axis. Same function, 2.25x fewer conv flops and no 4x intermediate.
The tap sums are taken in fp32 before the cast to the compute dtype. Set
VS_NO_SUBPIXEL=1 for the repeat-then-conv statement.

Layout: channels-last (N, h, w, C) in and out; the conv kernel and bias are
in the torch Conv2d layout (Cout, Cin, 3, 3).
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

_GROUPS = (((0,), (1, 2)),      # a = 0: offsets (-1, 0)
           ((0, 1), (2,)))      # a = 1: offsets (0, +1)
_PADS = ((1, 0), (0, 1))        # zero padding per phase (lo, hi)


def subpixel_enabled() -> bool:
    return os.environ.get('VS_NO_SUBPIXEL', '') != '1'


def _phase_kernel(weight: torch.Tensor, a: int, b: int) -> torch.Tensor:
    """(Cout, Cin, 3, 3) -> the (Cout, Cin, 2, 2) kernel of phase (a, b)."""
    w = weight.float()
    rows, cols = _GROUPS[a], _GROUPS[b]
    return torch.stack([
        torch.stack([sum(w[:, :, k, l] for k in rows[p] for l in cols[q])
                     for q in range(2)], dim=-1)
        for p in range(2)], dim=-2)


def subpixel_upsample_conv(x: torch.Tensor, weight: torch.Tensor,
                           bias: torch.Tensor) -> torch.Tensor:
    """(N, h, w, Cin) -> (N, 2h, 2w, Cout), == nearest-2x then conv3x3."""
    n, h, w, _ = x.shape
    xc = x.permute(0, 3, 1, 2)
    phases = []
    for a in range(2):
        row = []
        for b in range(2):
            k_ab = _phase_kernel(weight, a, b).to(x.dtype)
            xp = F.pad(xc, (*_PADS[b], *_PADS[a]))
            row.append(F.conv2d(xp, k_ab, bias.to(x.dtype)))
        phases.append(torch.stack(row, dim=-1))     # (N, Cout, h, w, 2)
    y = torch.stack(phases, dim=3)                  # (N, Cout, h, 2, w, 2)
    cout = y.shape[1]
    return y.reshape(n, cout, 2 * h, 2 * w).permute(0, 2, 3, 1)


def naive_upsample_conv(x: torch.Tensor, weight: torch.Tensor,
                        bias: torch.Tensor, out_hw: tuple[int, int]):
    """Nearest-upsample to out_hw (ceil repeat + crop), then conv3x3 pad 1."""
    _, h, w, _ = x.shape
    th, tw = out_hw
    x = x.repeat_interleave((th + h - 1) // h, dim=1)
    x = x.repeat_interleave((tw + w - 1) // w, dim=2)[:, :th, :tw]
    y = F.conv2d(x.permute(0, 3, 1, 2), weight.to(x.dtype), bias.to(x.dtype),
                 padding=1)
    return y.permute(0, 2, 3, 1)
