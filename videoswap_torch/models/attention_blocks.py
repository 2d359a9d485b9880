"""Spatial transformer applied per frame (the port of
videoswap_tpu/models/attention_blocks.py, without the prompt-to-prompt
control hooks): self-attention, cross-attention and GEGLU FFN over the
tokens of each frame, text repeated per frame.

CFG-prefix dedup (`forward(..., cfg_expand=True)`): x enters as the single
shared CFG half and is doubled to [uncond; cond] right before the first
cross-attention, where text (the only difference between the halves) first
enters.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Attention, FeedForward, GroupNorm


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int, cross_layer_idx: int = 0):
        super().__init__()
        self.cross_layer_idx = cross_layer_idx
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, dim_head,
                               cross_attention_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                cfg_expand: bool = False) -> torch.Tensor:
        # x: (B*F, S, dim); text: (B*F, 77, D) or layer-wise (B*F, L, 77, D)
        if text.dim() == 4:
            text = text[:, self.cross_layer_idx]
        x = self.attn1(self.norm1(x)) + x
        if cfg_expand:
            x = torch.cat([x, x], dim=0)
        x = self.attn2(self.norm2(x), text) + x
        return self.ff(self.norm3(x)) + x


class Transformer3DModel(nn.Module):
    """GroupNorm -> 1x1-conv proj_in -> blocks -> 1x1-conv proj_out, + res."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 cross_attention_dim: int, num_layers: int = 1,
                 cross_layer_idx: int = 0, norm_groups: int = 32):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(norm_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                inner, heads, dim_head, cross_attention_dim,
                cross_layer_idx=cross_layer_idx + i)
            for i in range(num_layers)])
        self.proj_out = nn.Conv2d(inner, in_channels, 1)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                cfg_expand: bool = False) -> torch.Tensor:
        # x: (B, F, H, W, C); text: (B', 77, D), B' = 2B under cfg_expand
        b, f, hh, ww, c = x.shape
        residual = x
        text = text.repeat_interleave(f, dim=0)       # per-frame text
        h = self.norm(x.reshape(b * f, hh, ww, c))    # per-frame statistics
        h = F.linear(h, self.proj_in.weight.flatten(1), self.proj_in.bias)
        h = h.reshape(b * f, hh * ww, -1)
        for i, block in enumerate(self.transformer_blocks):
            h = block(h, text, cfg_expand=cfg_expand and i == 0)
        bf_out = h.shape[0]                           # b*f, or 2*b*f
        h = F.linear(h, self.proj_out.weight.flatten(1), self.proj_out.bias)
        h = h.reshape(bf_out // f, f, hh, ww, c)
        if h.shape[0] != residual.shape[0]:
            residual = torch.cat([residual, residual], dim=0)
        return h + residual
