"""AnimateDiff temporal motion modules (the port of
videoswap_tpu/models/motion_module.py).

VanillaTemporalModule wraps a TemporalTransformer3DModel: per-frame
GroupNorm -> proj_in -> N x TemporalTransformerBlock -> proj_out + residual.
Each block runs two self-attentions over the FRAME axis of every spatial
location, with a sinusoidal position encoding (max_len 24), then a GEGLU
FFN.

Two paths, chosen by `use_fused` as the JAX package chooses on its
accelerator: on the card, modules with C <= 640 run through the fused
temporal-transformer kernel (ops/fused_temporal.py; at C = 640 its
attention half, then `ffn_tail`); wider modules, and every module on the
CPU, run layer-wise, the attention through the temporal-attention kernel
and the FFN through the GEGLU kernel. `FT_DISABLE` forces the layer-wise
path and `FT_4D` the fused kernel's frame-major layout, as in the JAX
package.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videoswap_torch.ops.fused_temporal import (
    ffn_tail, flat_params, fused_temporal_transformer,
    fused_temporal_transformer_bfhw)

from .layers import Attention, FeedForward, GroupNorm


def use_fused(x: torch.Tensor, channels: int, frames: int, num_layers: int,
              max_len: int) -> bool:
    """The fused-path gate of videoswap_tpu/models/motion_module.py, with a
    tensor on the card in place of the TPU backend."""
    return (x.is_cuda and channels <= 640 and num_layers == 1
            and frames <= max_len and not os.environ.get('FT_DISABLE'))


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
                f'{self.max_len}; windowed long video is not ported yet '
                '(ROADMAP.md Queue 1 item 4)')
        pe = self.pe[:f].to(x.dtype)
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(norm(x) + pe[None]) + x
        return self.ff(self.ff_norm(x)) + x


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, channels: int, heads: int, num_layers: int = 1,
                 max_len: int = 24, norm_groups: int = 32):
        super().__init__()
        self.heads, self.num_layers, self.max_len = heads, num_layers, max_len
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, heads, max_len=max_len)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, F, H, W, C); GroupNorm statistics per FRAME
        b, f, hh, ww, c = x.shape
        gn = self.norm(x.reshape(b * f, hh, ww, c)).reshape(x.shape)
        if use_fused(x, c, f, self.num_layers, self.max_len):
            return self._fused(x, gn)
        return self._layerwise(x, gn)

    def _layerwise(self, x: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        h = F.linear(gn, self.proj_in.weight, self.proj_in.bias)
        # (B, F, H, W, C) -> (B*H*W, F, C): a frame sequence per location
        h = h.permute(0, 2, 3, 1, 4).reshape(b * hh * ww, f, c)
        for block in self.transformer_blocks:
            h = block(h)
        h = h.reshape(b, hh, ww, f, c).permute(0, 3, 1, 2, 4)
        return self.proj_out(h) + x

    def _fused(self, x: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        include_ffn = c <= 320
        flat = flat_params(self, include_ffn)
        pe = self.transformer_blocks[0].pe[:f].to(x.dtype)
        if os.environ.get('FT_4D'):
            x4 = x.reshape(b, f, hh * ww, c)
            out = fused_temporal_transformer_bfhw(
                gn.reshape(x4.shape), x4, pe, flat, self.heads, f,
                include_ffn=include_ffn)
            if not include_ffn:
                out = ffn_tail(out.reshape(-1, c), x4.reshape(-1, c), self)
            return out.reshape(x.shape)
        x2 = x.permute(0, 2, 3, 1, 4).reshape(-1, c)
        g2 = gn.permute(0, 2, 3, 1, 4).reshape(-1, c)
        out = fused_temporal_transformer(g2, x2, pe, flat, self.heads, f,
                                         include_ffn=include_ffn)
        if not include_ffn:
            out = ffn_tail(out, x2, self)
        return out.reshape(b, hh, ww, f, c).permute(0, 3, 1, 2, 4) \
            .contiguous()


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
