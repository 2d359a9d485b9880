"""AnimateDiff temporal motion modules (the port of the layer-wise path of
videoswap_tpu/models/motion_module.py).

VanillaTemporalModule wraps a TemporalTransformer3DModel: per-frame
GroupNorm -> proj_in -> N x TemporalTransformerBlock -> proj_out + residual.
Each block runs two self-attentions over the FRAME axis of every spatial
location, with a sinusoidal position encoding (max_len 24), through the
temporal-attention kernel, then a GEGLU FFN through the GEGLU kernel.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Attention, FeedForward, GroupNorm


def sinusoidal_position_table(max_len: int, d_model: int) -> np.ndarray:
    """pe[p, 2i] = sin(p / 10000^(2i/d)), pe[p, 2i+1] = cos(...)."""
    position = np.arange(max_len, dtype=np.float64)[:, None]
    div_term = np.exp(np.arange(0, d_model, 2, dtype=np.float64)
                      * (-math.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), dtype=np.float32)
    pe[:, 0::2] = np.sin(position * div_term)
    pe[:, 1::2] = np.cos(position * div_term)
    return pe


class TemporalTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, max_len: int = 24,
                 num_attention_blocks: int = 2):
        super().__init__()
        self.max_len = max_len
        self.attention_blocks = nn.ModuleList([
            Attention(dim, heads, dim // heads)
            for _ in range(num_attention_blocks)])
        self.norms = nn.ModuleList([nn.LayerNorm(dim, eps=1e-6)
                                    for _ in range(num_attention_blocks)])
        self.ff_norm = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)
        self.register_buffer(
            'pe', torch.from_numpy(sinusoidal_position_table(max_len, dim)),
            persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B*H*W, F, C): attention across frames per spatial location
        f = x.shape[1]
        if f > self.max_len:
            raise ValueError(
                f'temporal sequence {f} exceeds positional-encoding max_len '
                f'{self.max_len}; windowed long video is not ported yet')
        pe = self.pe[:f].to(x.dtype)
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(norm(x) + pe[None]) + x
        return self.ff(self.ff_norm(x)) + x


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, channels: int, heads: int, num_layers: int = 1,
                 max_len: int = 24, norm_groups: int = 32):
        super().__init__()
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, heads, max_len=max_len)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, F, H, W, C); GroupNorm statistics per FRAME
        b, f, hh, ww, c = x.shape
        h = self.norm(x.reshape(b * f, hh, ww, c)).reshape(x.shape)
        h = F.linear(h, self.proj_in.weight, self.proj_in.bias)
        # (B, F, H, W, C) -> (B*H*W, F, C): a frame sequence per location
        h = h.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c)
        for block in self.transformer_blocks:
            h = block(h)
        h = h.reshape(b, hh, ww, f, c).permute(0, 3, 1, 2, 4)
        return self.proj_out(h) + x


class VanillaTemporalModule(nn.Module):
    def __init__(self, channels: int, heads: int = 8,
                 num_transformer_block: int = 1, max_len: int = 24,
                 norm_groups: int = 32):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(
            channels, heads, num_layers=num_transformer_block,
            max_len=max_len, norm_groups=norm_groups)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal_transformer(x)
