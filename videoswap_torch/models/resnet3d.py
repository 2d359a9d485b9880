"""Frame-folded 2D conv blocks of the inflated U-Net (the port of
videoswap_tpu/models/resnet3d.py). Layout: (B, F, H, W, C)."""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from videoswap_torch.ops.subpixel import (naive_upsample_conv,
                                          subpixel_enabled,
                                          subpixel_upsample_conv)

from .layers import GroupNorm, conv_over_frames


class InflatedConv(nn.Conv2d):
    """A Conv2d mapped over the frames of a (B, F, H, W, C) video."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int = 3,
                 stride: int = 1, padding: int = 1):
        super().__init__(in_channels, out_channels, kernel, stride=stride,
                         padding=padding)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return conv_over_frames(super().forward, x)


class Upsample3D(nn.Module):
    """Nearest 2x spatial upsample + 3x3 conv (frames untouched), as a
    subpixel phase decomposition for clean 2x targets."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, out_channels, 3, padding=1)

    def forward(self, x: torch.Tensor,
                output_size: Optional[tuple[int, int]] = None):
        b, f, h, w, c = x.shape
        th, tw = output_size if output_size is not None else (h * 2, w * 2)
        x2 = x.reshape(b * f, h, w, c)
        if (th, tw) == (h * 2, w * 2) and subpixel_enabled():
            y = subpixel_upsample_conv(x2, self.conv.weight, self.conv.bias)
        else:
            y = naive_upsample_conv(x2, self.conv.weight, self.conv.bias,
                                    (th, tw))
        return y.reshape(b, f, th, tw, -1)


class Downsample3D(nn.Module):
    """Stride-2 3x3 conv spatial downsample (frames untouched)."""

    def __init__(self, channels: int, out_channels: int):
        super().__init__()
        self.conv = InflatedConv(channels, out_channels, stride=2)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv(x)


class ResnetBlock3D(nn.Module):
    """GN-SiLU-conv (+temb) GN-SiLU-conv with a 1x1 shortcut. Its GroupNorm
    statistics span the frames, as the reference's 5-D GroupNorm does."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int], eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(groups, in_channels, eps=eps)
        self.conv1 = InflatedConv(in_channels, out_channels)
        self.time_emb_proj = (nn.Linear(temb_channels, out_channels)
                              if temb_channels is not None else None)
        self.norm2 = GroupNorm(groups, out_channels, eps=eps)
        self.conv2 = InflatedConv(out_channels, out_channels)
        self.conv_shortcut = (
            InflatedConv(in_channels, out_channels, kernel=1, padding=0)
            if in_channels != out_channels else None)

    def forward(self, x: torch.Tensor,
                temb: Optional[torch.Tensor] = None) -> torch.Tensor:
        h = self.conv1(F.silu(self.norm1(x)))
        if temb is not None:
            t = self.time_emb_proj(F.silu(temb))
            h = h + t[:, None, None, None, :]
        h = self.conv2(F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = self.conv_shortcut(x)
        return x + h
