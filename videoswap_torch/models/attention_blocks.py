"""Spatial transformer applied per frame (the port of
videoswap_tpu/models/attention_blocks.py): self-attention, cross-attention
and GEGLU FFN over the tokens of each frame, text repeated per frame.

Attention control: each block's self- and cross-attention site has a
static `SiteKey` (place, kind, index); the `AttnCtrl` passed down decides
whether a site's probabilities are captured into `store` (a dict the U-Net
call fills) and whether they are rewritten (p2p/ctrl.py).

CFG-prefix dedup (`forward(..., cfg_expand=True)`): x enters as the single
shared CFG half and is doubled to [uncond; cond] right before the first
cross-attention, where text (the only difference between the halves) first
enters. In a sharded U-Net call the doubling keeps this rank's part of the
doubled batch (`parallel.sharding.double_cfg`), and stored maps are
gathered over the ranks' rows and frames (`gather_folded`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from videoswap_torch.p2p import NO_CTRL, AttnCtrl, SiteKey
from videoswap_torch.parallel import sharding

from .layers import Attention, FeedForward, GroupNorm


def _run_attn(attn, h, context, site: SiteKey, tokens: int, ctrl: AttnCtrl,
              store):
    edit_fn = ctrl.get_edit_fn(site, tokens)
    if ctrl.wants_store(site, tokens):
        out, probs = attn(h, context, edit_fn=edit_fn, want_probs=True)
        store[site.name] = sharding.gather_folded(probs)
        return out
    return attn(h, context, edit_fn=edit_fn)


class BasicTransformerBlock(nn.Module):
    def __init__(self, dim: int, heads: int, dim_head: int,
                 cross_attention_dim: int, cross_layer_idx: int = 0,
                 place: str = 'down', attn_index: int = 0):
        super().__init__()
        self.cross_layer_idx = cross_layer_idx
        self.site_self = SiteKey(place, 'self', attn_index)
        self.site_cross = SiteKey(place, 'cross', attn_index)
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn1 = Attention(dim, heads, dim_head)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.attn2 = Attention(dim, heads, dim_head,
                               cross_attention_dim=cross_attention_dim)
        self.norm3 = nn.LayerNorm(dim, eps=1e-6)
        self.ff = FeedForward(dim)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                cfg_expand: bool = False, ctrl: AttnCtrl = NO_CTRL,
                store: dict | None = None) -> torch.Tensor:
        # x: (B*F, S, dim); text: (B*F, 77, D) or layer-wise (B*F, L, 77, D)
        if text.dim() == 4:
            text = text[:, self.cross_layer_idx]
        tokens = x.shape[1]
        x = _run_attn(self.attn1, self.norm1(x), None, self.site_self, tokens,
                      ctrl, store) + x
        if cfg_expand:
            x = sharding.double_cfg(x)
        x = _run_attn(self.attn2, self.norm2(x), text, self.site_cross,
                      tokens, ctrl, store) + x
        return self.ff(self.norm3(x)) + x


class Transformer3DModel(nn.Module):
    """GroupNorm -> 1x1-conv proj_in -> blocks -> 1x1-conv proj_out, + res."""

    def __init__(self, in_channels: int, heads: int, dim_head: int,
                 cross_attention_dim: int, num_layers: int = 1,
                 cross_layer_idx: int = 0, norm_groups: int = 32,
                 place: str = 'down', attn_index: int = 0):
        super().__init__()
        inner = heads * dim_head
        self.norm = GroupNorm(norm_groups, in_channels, eps=1e-6)
        self.proj_in = nn.Conv2d(in_channels, inner, 1)
        self.transformer_blocks = nn.ModuleList([
            BasicTransformerBlock(
                inner, heads, dim_head, cross_attention_dim,
                cross_layer_idx=cross_layer_idx + i, place=place,
                attn_index=attn_index + i)
            for i in range(num_layers)])
        self.proj_out = nn.Conv2d(inner, in_channels, 1)

    def forward(self, x: torch.Tensor, text: torch.Tensor,
                cfg_expand: bool = False, ctrl: AttnCtrl = NO_CTRL,
                store: dict | None = None) -> torch.Tensor:
        # x: (B, F, H, W, C); text: (B', 77, D), B' = 2B under cfg_expand
        b, f, hh, ww, c = x.shape
        residual = x
        f_out = sharding.frames_after_expand(f) if cfg_expand else f
        text = text.repeat_interleave(f_out, dim=0)   # per-frame text
        h = self.norm(x.reshape(b * f, hh, ww, c))    # per-frame statistics
        h = F.linear(h, self.proj_in.weight.flatten(1), self.proj_in.bias)
        h = h.reshape(b * f, hh * ww, -1)
        for i, block in enumerate(self.transformer_blocks):
            h = block(h, text, cfg_expand=cfg_expand and i == 0, ctrl=ctrl,
                      store=store)
        bf_out = h.shape[0]                           # b*f, or 2*b*f
        h = F.linear(h, self.proj_out.weight.flatten(1), self.proj_out.bias)
        h = h.reshape(bf_out // f_out, f_out, hh, ww, c)
        if cfg_expand:
            residual = sharding.double_cfg(residual)
            sharding.finish_cfg_expand()
        return h + residual
