"""Shared building blocks for the SD-1.5 / AnimateDiff models (the port of
videoswap_tpu/models/layers.py).

Submodules carry the diffusers names (`to_q`, `to_out.0`,
`time_embedding.linear_1`, `ff.net.0.proj`, ...), so a JAX parameter tree
converts to their `state_dict` by a mechanical key rewrite
(models/converters.py). Video activations are channels-last (B, F, H, W, C);
convolutions see (N, C, H, W) views of that memory (PyTorch's channels_last
format), so no layout copies are made around them.
"""

from __future__ import annotations

import math
from typing import Callable, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from videoswap_torch.ops import attention_with_probs, dot_product_attention
from videoswap_torch.ops.geglu_ffn import geglu_ffn
from videoswap_torch.parallel import sharding


def timestep_sinusoidal(timesteps: torch.Tensor, dim: int) -> torch.Tensor:
    """[B] timesteps -> [B, dim] float32 features (diffusers `Timesteps` as
    SD-1.5 configures it: flip_sin_to_cos, no frequency shift)."""
    half = dim // 2
    exponent = -math.log(10000.0) * torch.arange(
        half, dtype=torch.float32, device=timesteps.device)
    emb = torch.exp(exponent / half)[None, :] * timesteps.float()[:, None]
    return torch.cat([torch.cos(emb), torch.sin(emb)], dim=-1)


class TimestepEmbedding(nn.Module):
    """Two-layer SiLU MLP over sinusoidal features."""

    def __init__(self, in_features: int, time_embed_dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_features, time_embed_dim)
        self.linear_2 = nn.Linear(time_embed_dim, time_embed_dim)

    def forward(self, sample: torch.Tensor) -> torch.Tensor:
        return self.linear_2(F.silu(self.linear_1(sample)))


class Attention(nn.Module):
    """Multi-head attention with the diffusers parameter layout: to_q, to_k,
    to_v without bias, to_out.0 with bias. Heads are merged in the
    projections' output, (B, S, heads * dim_head).

    The attention-control tap: with `edit_fn` or `want_probs` the
    probabilities are materialised (`attention_with_probs`; the controllers
    use it only at sites below 32^2 tokens); `edit_fn` rewrites them before
    the value contraction, and `want_probs` returns (out, probs before the
    edit).

    Tensor parallel (`parallel.sharding.shard_unet` sets `tp_group`): the
    module holds `heads` of the heads and the matching rows of to_q, to_k,
    to_v and columns of to_out.0; the inputs enter through the
    column-parallel entry (their gradient summed over the tp group), the
    out-projection's partial sums are all-reduced over the tp group in
    their own dtype, its bias held by tp rank 0 alone. (The partials are
    rounded to bf16 on the card already, and where ranks share a card gloo
    stages every byte through the host: a bf16 sum moves half the bytes of
    an fp32 one; PERF.md, PR 18.)"""

    tp_group = None

    def __init__(self, query_dim: int, heads: int = 8, dim_head: int = 64,
                 cross_attention_dim: Optional[int] = None):
        super().__init__()
        inner = heads * dim_head
        ctx_dim = cross_attention_dim or query_dim
        self.heads = heads
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx_dim, inner, bias=False)
        self.to_v = nn.Linear(ctx_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, query_dim)])

    def forward(self, hidden_states: torch.Tensor,
                encoder_hidden_states: Optional[torch.Tensor] = None,
                edit_fn: Optional[Callable] = None, want_probs: bool = False):
        hidden_states = sharding.copy_to_tp(hidden_states, self.tp_group)
        ctx = (hidden_states if encoder_hidden_states is None
               else sharding.copy_to_tp(encoder_hidden_states,
                                        self.tp_group))
        q = self.to_q(hidden_states)
        k = self.to_k(ctx)
        v = self.to_v(ctx)
        if edit_fn is None and not want_probs:
            return self._out(dot_product_attention(q, k, v, self.heads))
        out, probs = attention_with_probs(q, k, v, self.heads,
                                          edit_fn=edit_fn)
        out = self._out(out)
        return (out, probs) if want_probs else out

    def _out(self, h: torch.Tensor) -> torch.Tensor:
        y = self.to_out[0](h)
        if self.tp_group is None:
            return y
        return sharding.all_reduce_sum(y, self.tp_group, y.dtype)


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, inner: int):
        super().__init__()
        self.proj = nn.Linear(dim, 2 * inner)


class FeedForward(nn.Module):
    """GEGLU feed-forward, diffusers layout (net.0.proj, net.2), run through
    the fused GEGLU kernel (ops/geglu_ffn.py). Tensor parallel (`tp_group`
    set): the module holds H = 4C / tp hidden units, net.0.proj's rows as
    [a | gate] of those units; its input enters through the column-parallel
    entry and the kernel's partial result is all-reduced in its own dtype,
    as Attention's (net.2's bias on tp rank 0 alone)."""

    tp_group = None

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.dim = dim
        self.net = nn.ModuleList([_GEGLUProj(dim, inner), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        c = x.shape[-1]
        x = sharding.copy_to_tp(x, self.tp_group)
        proj, out = self.net[0].proj, self.net[2]
        y = geglu_ffn(x.reshape(-1, c).contiguous(), proj.weight, proj.bias,
                      out.weight, out.bias)
        if self.tp_group is not None:
            y = sharding.all_reduce_sum(y, self.tp_group, y.dtype)
        return y.reshape(*x.shape[:-1], self.dim)


def group_norm(x: torch.Tensor, groups: int, weight: torch.Tensor,
               bias: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm over a channels-last tensor (N, ..., C): statistics per
    sample over every non-batch axis of the group, in fp32, as flax's
    GroupNorm computes them. The result has x's dtype."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    var, mean = torch.var_mean(xf, dim=(1, 3), correction=0, keepdim=True)
    y = ((xf - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    return (y * weight.float() + bias.float()).to(x.dtype)


def group_norm_reduced(x: torch.Tensor, groups: int, weight: torch.Tensor,
                       bias: torch.Tensor, eps: float, group) -> torch.Tensor:
    """`group_norm` of a tensor whose non-batch axes are split over the
    ranks of `group` (equal parts): the mean, then the variance about it,
    each summed in fp32 over the ranks (and their gradients summed back:
    every rank's part consumes the global statistics)."""
    n, c = x.shape[0], x.shape[-1]
    xf = x.float().reshape(n, -1, groups, c // groups)
    count = xf.shape[1] * xf.shape[3] * dist.get_world_size(group)
    mean = sharding.reduce_stats(xf.sum(dim=(1, 3)), group) / count
    d = xf - mean[:, None, :, None]
    var = sharding.reduce_stats((d * d).sum(dim=(1, 3)), group) / count
    y = (d * torch.rsqrt(var + eps)[:, None, :, None]).reshape(x.shape)
    return (y * weight.float() + bias.float()).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """nn.GroupNorm's parameters, applied to channels-last input. A video
    (B, F, H, W, C) whose frames are sharded over sp in a sharded U-Net call
    takes its statistics over every rank's frames."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        group = sharding.stats_group() if x.dim() == 5 else None
        if group is not None:
            return group_norm_reduced(x, self.num_groups, self.weight,
                                      self.bias, self.eps, group)
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps)


def conv_over_frames(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply a 2D conv to a (B, F, H, W, C) video with frames folded into
    the batch: the reference's InflatedConv3d as a reshape."""
    b, f, h, w, c = x.shape
    y = conv2d_cl(conv, x.reshape(b * f, h, w, c))
    return y.reshape(b, f, *y.shape[1:])


def conv2d_cl(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Conv2d on channels-last (N, H, W, C) input -> (N, H', W', C')."""
    return conv(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
