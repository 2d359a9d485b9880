"""Spatial blending masks from cross-attention maps (the port of
videoswap_tpu/p2p/blend.py).

Word-selected cross-attention maps are head-averaged, 3x3-max-pooled,
nearest-resized to the latent resolution, max-normalised per map and
thresholded (reference spatial_blend.py). 'both' unions the source and
target masks. Masks gate latent blending x = x_src + m * (x_tgt - x_src)
and masked self-attention replacement.

Maps are per-frame batched: (P, F, heads, S, 77), P = 1 (source) or 2
(source, running sum of the target's). In a sharded swap the maps hold this
rank's tp heads: the head mean sums them over tp
(`parallel.sharding.head_sum`).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from videoswap_torch.parallel import sharding


def reshape_maps(maps: torch.Tensor, height: int,
                 width: int) -> torch.Tensor:
    """(P, F, heads, S, W77) -> (P, F, heads, rh, rw, W77), the map size
    inferred from S and the image aspect (reference spatial_blend.py)."""
    p, f, h, s, w77 = maps.shape
    rh = int(round((s * height / width) ** 0.5))
    rw = s // rh
    if rh * rw != s:
        raise ValueError(f'cannot factor {s} tokens at aspect '
                         f'{height}/{width}')
    return maps.reshape(p, f, h, rh, rw, w77)


def max_pool_3x3(x: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 max pool over the trailing two axes, SAME padding."""
    lead = x.shape[:-2]
    y = F.max_pool2d(x.reshape(-1, 1, *x.shape[-2:]), 3, stride=1,
                     padding=1)
    return y.reshape(*lead, *x.shape[-2:])


def blend_mask(site_maps: list[torch.Tensor], alpha_layers: torch.Tensor,
               th: float, out_hw: tuple[int, int], height: int,
               width: int) -> torch.Tensor:
    """site_maps: list of (P, F, heads, S, 77) with one S; alpha_layers:
    (P, 77) word selection. Returns a bool (P, F, h, w) mask."""
    stacked = torch.cat([reshape_maps(m.float(), height, width)
                         for m in site_maps], dim=2)    # (P,F,H*,rh,rw,77)
    alpha = alpha_layers[:, None, None, None, None, :].float()
    total, count = sharding.head_sum((stacked * alpha).sum(-1), 2)
    maps = max_pool_3x3(total / count)                 # (P, F, rh, rw)
    # jax.image.resize's 'nearest' samples at half-pixel centres
    mask = F.interpolate(maps, size=tuple(out_hw), mode='nearest-exact')
    denom = mask.amax(dim=(-2, -1), keepdim=True)
    mask = mask / torch.where(denom == 0, torch.ones_like(denom), denom)
    return mask > th


def union_both(mask: torch.Tensor) -> torch.Tensor:
    """'both' mode: the target mask becomes source | target."""
    return mask[:1] | mask


def latent_blend(x_src: torch.Tensor, x_tgt: torch.Tensor,
                 mask: torch.Tensor) -> torch.Tensor:
    """x = x_src + m * (x_tgt - x_src); mask (F, h, w) broadcast over
    (B, F, h, w, C)."""
    m = mask[None, :, :, :, None].to(x_tgt.dtype)
    return x_src + m * (x_tgt - x_src)
