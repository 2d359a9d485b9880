"""SparsePointAdapter: semantic point embeddings -> multi-resolution U-Net
residual maps (the port of videoswap_tpu/models/adapter.py).

The bilinear splat of every (frame, point, corner) is one vectorised
scatter-add per level: corner indices clipped to the map independently,
weights from the unclipped fractional offsets, points with x < 0 or y < 0
invisible, `point_mask` selecting a subset of points. With `loss_type` the adapter
also returns the training loss mask: all ones ('global') or the union of
radius-2 boxes around the visible points at the /8 resolution ('local').
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
from torch import nn

from videoswap_torch.utils.registry import MODEL_REGISTRY


class AdapterConfig(NamedTuple):
    embedding_channels: int = 1280
    channels: Sequence[int] = (320, 640, 1280, 1280)
    downsample_rate: Sequence[int] = (8, 16, 32, 64)
    mid_dim: int = 128
    radius: int = 2


def bilinear_splat(feat: torch.Tensor, tracks: torch.Tensor,
                   valid: torch.Tensor, height: int, width: int,
                   rate: int) -> torch.Tensor:
    """feat [P, C]; tracks [F, P, 2] pixel (x, y); valid [F, P] bool ->
    [F, height, width, C]."""
    f, p, _ = tracks.shape
    pos = tracks.float() / rate
    px, py = pos[..., 0], pos[..., 1]
    x1, y1 = torch.floor(px), torch.floor(py)
    xf, yf = px - x1, py - y1

    def clip(v, hi):
        return v.to(torch.int64).clamp(0, hi - 1)

    xs = torch.stack([clip(x1, width), clip(x1 + 1, width),
                      clip(x1, width), clip(x1 + 1, width)], dim=-1)
    ys = torch.stack([clip(y1, height), clip(y1, height),
                      clip(y1 + 1, height), clip(y1 + 1, height)], dim=-1)
    ws = torch.stack([(1 - xf) * (1 - yf), xf * (1 - yf),
                      (1 - xf) * yf, xf * yf], dim=-1)        # [F, P, 4]
    ws = ws * valid[..., None].to(ws.dtype)
    frame_idx = torch.arange(f, device=tracks.device)[:, None, None] \
        .expand(f, p, 4)
    contrib = (ws[..., None] * feat.float()[None, :, None, :]).to(feat.dtype)
    out = torch.zeros((f, height, width, feat.shape[-1]), dtype=feat.dtype,
                      device=feat.device)
    out.index_put_((frame_idx.reshape(-1), ys.reshape(-1), xs.reshape(-1)),
                   contrib.reshape(f * p * 4, -1), accumulate=True)
    return out


def local_loss_mask(tracks: torch.Tensor, valid: torch.Tensor, height: int,
                    width: int, rate: int, radius: int) -> torch.Tensor:
    """Union over frames and points of the half-open boxes
    [p - radius, p + radius) (ends clipped to [0, size - 1]) around every
    visible point: a [height, width] fp32 mask, the same for every frame."""
    pos = torch.floor(tracks.float() / rate).to(torch.int64)
    px, py = pos[..., 0].reshape(-1), pos[..., 1].reshape(-1)   # [F*P]
    v = valid.reshape(-1)
    x1, x2 = ((px + o).clamp(0, width - 1) for o in (-radius, radius))
    y1, y2 = ((py + o).clamp(0, height - 1) for o in (-radius, radius))
    gx = torch.arange(width, device=tracks.device)[None, None, :]
    gy = torch.arange(height, device=tracks.device)[None, :, None]
    inside = ((gx >= x1[:, None, None]) & (gx < x2[:, None, None])
              & (gy >= y1[:, None, None]) & (gy < y2[:, None, None])
              & v[:, None, None])
    return inside.any(dim=0).float()


class _MLP(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int):
        super().__init__()
        self.mlp = nn.Sequential(nn.Linear(cin, mid), nn.SiLU(),
                                 nn.Linear(mid, cout))

    def forward(self, x):
        return self.mlp(x)


@MODEL_REGISTRY.register()
class SparsePointAdapter(nn.Module):
    def __init__(self, cfg: AdapterConfig = AdapterConfig()):
        super().__init__()
        self.cfg = cfg
        self.model_list = nn.ModuleList([
            _MLP(cfg.embedding_channels, cfg.mid_dim, ch)
            for ch in cfg.channels])

    def forward(self, pred_tracks: torch.Tensor, size: tuple[int, int],
                point_embedding: torch.Tensor,
                point_mask: Optional[torch.Tensor] = None,
                loss_type: Optional[str] = None):
        """pred_tracks [F, P, 2] (x, y) pixels; size (W, H); point_embedding
        [P, E]; point_mask [P] bool. Returns the per-level residuals
        [F, H/r, W/r, C_l]; with `loss_type` ('global' or 'local') returns
        (residuals, [F, H/8, W/8, 1] fp32 loss mask)."""
        cfg = self.cfg
        w, h = size
        visible = (pred_tracks[..., 0] >= 0) & (pred_tracks[..., 1] >= 0)
        if point_mask is not None:
            visible = visible & point_mask[None, :]
        dtype = self.model_list[0].mlp[0].weight.dtype
        emb = point_embedding.to(dtype)
        states = [bilinear_splat(mlp(emb), pred_tracks, visible, h // rate,
                                 w // rate, rate)
                  for mlp, rate in zip(self.model_list, cfg.downsample_rate)]
        if loss_type is None:
            return states
        f, rate = pred_tracks.shape[0], cfg.downsample_rate[0]
        h8, w8 = h // rate, w // rate
        if loss_type == 'global':
            mask = torch.ones((h8, w8), device=pred_tracks.device)
        else:
            mask = local_loss_mask(pred_tracks, visible, h8, w8, rate,
                                   cfg.radius)
        return states, mask[None, :, :, None].expand(f, h8, w8, 1)
