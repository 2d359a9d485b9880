"""AnimateDiff temporal motion modules (the port of
videoswap_tpu/models/motion_module.py).

VanillaTemporalModule wraps a TemporalTransformer3DModel: per-frame
GroupNorm -> proj_in -> N x TemporalTransformerBlock -> proj_out + residual.
Each block runs two self-attentions over the FRAME axis of every spatial
location, with a sinusoidal position encoding (max_len 24), then a GEGLU
FFN.

Long video: with a `window` (the config's `long_video_config`, U-Net
`motion_window` / `motion_window_stride`), a block over more frames than
the window attends overlapping windows of `window` frames (`window_index`:
starts `stride` apart, the default `window // 2`, and a last window flush
to the end), each with the table's first `window` rows. Per attention
sublayer, the windows' outputs are added back at their static starts, in
a fixed order (the sum is the same bits run to run), and divided by each
frame's window count; the FFN then runs once a frame. The window adds no
parameter.

Two paths, chosen by `use_fused` as the JAX package chooses on its
accelerator: on the card, modules with C <= 640 that do not window run
through the fused temporal-transformer kernel (ops/fused_temporal.py; at
C = 640 its attention half, then `ffn_tail`); wider modules, windowed
modules, and every module on the CPU, run layer-wise, the attention
through the temporal-attention kernel and the FFN through the GEGLU
kernel. `FT_DISABLE` forces the layer-wise path and `FT_4D` the fused
kernel's frame-major layout, as in the JAX package.

Sharded (a sharded U-Net call whose frames are split over sp, or tp > 1):
after the per-frame GroupNorm, x and its norm go from frame sharding to
location sharding through an all-to-all over sp (Ulysses), each rank runs
its chunk of the locations, split over the whole (sp, tp) group, with every
frame, and the result goes back the inverse way
(`parallel.sharding.frames_to_locations`). The weights stay replicated over
tp, and a windowed block sees every frame, so its windows stay local.
"""

from __future__ import annotations

import math
import os
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from videoswap_torch.ops.fused_temporal import (
    ffn_tail, flat_params, fused_temporal_transformer,
    fused_temporal_transformer_bfhw)
from videoswap_torch.parallel import sharding

from .layers import Attention, FeedForward, GroupNorm


def use_fused(x: torch.Tensor, channels: int, frames: int, num_layers: int,
              max_len: int, window: Optional[int] = None) -> bool:
    """The fused-path gate of videoswap_tpu/models/motion_module.py, with a
    tensor on the card in place of the TPU backend."""
    return (x.is_cuda and channels <= 640 and num_layers == 1
            and frames <= max_len and (window is None or frames <= window)
            and not os.environ.get('FT_DISABLE'))


def window_index(f: int, window: int, stride: int) -> np.ndarray:
    """Static [n_windows, window] frame indices for sliding-window temporal
    attention: stride-spaced starts plus a final window flush to the end so
    every frame is covered."""
    if not (window <= f and stride >= 1):
        raise AssertionError(f'window {window} of {f} frames, stride '
                             f'{stride}')
    if stride > window:
        raise AssertionError(
            f'stride {stride} > window {window} would leave frames with no '
            'attention window')
    starts = list(range(0, f - window + 1, stride))
    if starts[-1] != f - window:
        starts.append(f - window)
    return np.asarray([[s + j for j in range(window)] for s in starts],
                      dtype=np.int32)


def window_weights(idx: np.ndarray, f: int) -> np.ndarray:
    """(f,) fp32: 1 / the number of windows of `idx` that hold each frame,
    the weights of the windows' average."""
    counts = np.zeros((f,), np.float32)
    np.add.at(counts, idx.reshape(-1), 1.0)
    return 1.0 / counts


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
                 num_attention_blocks: int = 2, window: Optional[int] = None,
                 stride: Optional[int] = None):
        super().__init__()
        self.max_len, self.window, self.stride = max_len, window, stride
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
        b, f, c = x.shape
        windowed = self.window is not None and f > self.window
        w = self.window if windowed else f
        if w > self.max_len:
            raise ValueError(
                f'temporal sequence {w} exceeds positional-encoding max_len '
                f'{self.max_len}; set a motion window (long_video_cfg) for '
                f'videos longer than {self.max_len} frames')
        if not windowed:
            pe = self.pe[:f].to(x.dtype)
            for attn, norm in zip(self.attention_blocks, self.norms):
                x = attn(norm(x) + pe[None]) + x
            return self.ff(self.ff_norm(x)) + x
        idx = window_index(f, w, self.stride or max(1, w // 2))
        starts = idx[:, 0].tolist()
        inv_counts = torch.from_numpy(window_weights(idx, f)).to(
            x.device, x.dtype)[None, :, None]
        for attn, norm in zip(self.attention_blocks, self.norms):
            h = norm(x)
            a = attn(self.windows(h, starts, w)).reshape(
                b, len(starts), w, c)
            # whole windows added at their static starts, one after
            # another: no atomics, so the sum is the same bits every run
            acc = torch.zeros_like(h)
            for j, s in enumerate(starts):
                acc[:, s:s + w] += a[:, j]
            x = acc * inv_counts + x
        return self.ff(self.ff_norm(x)) + x

    def windows(self, h: torch.Tensor, starts: list, w: int) -> torch.Tensor:
        """The windows of h (B, F, C) at `starts`, (B * n_windows, w, C),
        each with the position table's first w rows added."""
        pe = self.pe[:w].to(h.dtype)
        hw = torch.stack([h[:, s:s + w] for s in starts], dim=1)
        return hw.reshape(-1, w, h.shape[-1]) + pe[None]


class TemporalTransformer3DModel(nn.Module):
    def __init__(self, channels: int, heads: int, num_layers: int = 1,
                 max_len: int = 24, norm_groups: int = 32,
                 window: Optional[int] = None, stride: Optional[int] = None):
        super().__init__()
        self.heads, self.num_layers, self.max_len = heads, num_layers, max_len
        self.window = window
        self.norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList([
            TemporalTransformerBlock(channels, heads, max_len=max_len,
                                     window=window, stride=stride)
            for _ in range(num_layers)])
        self.proj_out = nn.Linear(channels, channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, F, H, W, C); GroupNorm statistics per FRAME
        b, f, hh, ww, c = x.shape
        gn = self.norm(x.reshape(b * f, hh, ww, c)).reshape(x.shape)
        split = sharding.location_split()
        if split is None:
            return self._run(x, gn)
        # frames -> locations: this rank's chunk of the locations, with
        # every frame, as a (b, F, q, 1, c) video
        both = torch.cat([x, gn], dim=-1).reshape(b, f, hh * ww, 2 * c)
        loc, el = sharding.frames_to_locations(both, split)
        loc = loc.unsqueeze(3)
        out = self._run(loc[..., :c].contiguous(),
                        loc[..., c:].contiguous()).squeeze(3)
        return sharding.locations_to_frames(out, split, el).reshape(x.shape)

    def _run(self, x: torch.Tensor, gn: torch.Tensor) -> torch.Tensor:
        b, f, hh, ww, c = x.shape
        if use_fused(x, c, f, self.num_layers, self.max_len, self.window):
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
                 norm_groups: int = 32, window: Optional[int] = None,
                 stride: Optional[int] = None):
        super().__init__()
        self.temporal_transformer = TemporalTransformer3DModel(
            channels, heads, num_layers=num_transformer_block,
            max_len=max_len, norm_groups=norm_groups, window=window,
            stride=stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.temporal_transformer(x)
