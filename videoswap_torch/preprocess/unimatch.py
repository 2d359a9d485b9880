"""UniMatch (GMFlow scale2 + regrefine6) bidirectional optical flow: the port
of videoswap_tpu/preprocess/unimatch.py, whose docstring gives the
architecture and the reference's inference knobs (attention splits [2, 8],
correlation radius [-1, 4], propagation radius [-1, 1], 6 refinements,
bidirectional).

Activations are channels-last (B, H, W, C) as in the JAX package; the
convolutions see them as channels-last NCHW views. The modules carry the
published checkpoint's names (`backbone.*`, `transformer.layers.N.*`,
`feature_flow_attn.*`, `refine_proj.*`, `refine.*`), so that
`gmflow-scale2-regrefine6-mixdata-train320x576-*.pth` loads into
`UniMatchFlow` strictly, as it is. The numerics are the JAX package's:
align-corners bilinear (`resize_ac`, the pixel-coordinate `grid_sample`
with zero padding), biased instance-norm variance, exact GELU, and its
LayerNorm epsilon (flax's default 1e-6; the published model's torch
default is 1e-5). Products and convolutions run in fp32 with TF32 off
(`UniMatchWrapper`).

The shared helpers (`resize_ac`, `grid_sample`, `instance_norm`,
`coords_grid`, `ResidualBlock`) serve CoTracker too (cotracker_native.py).
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .flow import fp32_math

# inference config pinned by the reference wrapper (extract_flow.py:44-53)
ATTN_SPLITS = (2, 8)
CORR_RADIUS = (-1, 4)
PROP_RADIUS = (-1, 1)
NUM_REG_REFINE = 6
UPSAMPLE_FACTOR = 4
PADDING_FACTOR = 32
MAX_LONG_EDGE = 768

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


# ---------------------------------------------------------------------------
# torch-matched primitives, channels-last
# ---------------------------------------------------------------------------


def resize_ac(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """Bilinear resize with align_corners=True semantics (src = dst * (in -
    1) / (out - 1)); x is (..., H, W, C)."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                      size=(out_h, out_w), mode='bilinear',
                      align_corners=True)
    return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)


def grid_sample(img: torch.Tensor, x: torch.Tensor,
                y: torch.Tensor) -> torch.Tensor:
    """F.grid_sample(mode='bilinear', padding_mode='zeros',
    align_corners=True) in PIXEL coordinates. img (B, H, W, C); x, y (B,
    ...) -> (B, ..., C): the four taps weighted as the JAX package weights
    them, a tap outside the image reading 0."""
    b, h, w, c = img.shape
    flat = img.reshape(b, h * w, c)
    rows = torch.arange(b, device=img.device)[:, None]
    x0, y0 = torch.floor(x), torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]

    def tap(xi, yi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        idx = (yi.clamp(0, h - 1).long() * w
               + xi.clamp(0, w - 1).long()).reshape(b, -1)
        v = flat[rows, idx].reshape(*x.shape, c)
        return v * valid[..., None]

    x1, y1 = x0 + 1, y0 + 1
    return (tap(x0, y0) * (1 - wx) * (1 - wy) + tap(x1, y0) * wx * (1 - wy)
            + tap(x0, y1) * (1 - wx) * wy + tap(x1, y1) * wx * wy)


def instance_norm(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """InstanceNorm2d(affine=False) of (B, H, W, C): per sample and channel
    over (H, W), biased variance."""
    mean = x.mean(dim=(1, 2), keepdim=True)
    var = ((x - mean) ** 2).mean(dim=(1, 2), keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def coords_grid(b: int, h: int, w: int, device=None) -> torch.Tensor:
    """(B, H, W, 2) pixel coordinates in (x, y) order."""
    ys, xs = torch.meshgrid(torch.arange(h, dtype=torch.float32,
                                         device=device),
                            torch.arange(w, dtype=torch.float32,
                                         device=device), indexing='ij')
    return torch.stack([xs, ys], -1).expand(b, h, w, 2)


def unfold3x3(x: torch.Tensor) -> torch.Tensor:
    """F.unfold(k=3, pad=1) of (B, H, W, C) -> (B, H, W, 9, C), taps in
    (dy, dx) row-major order."""
    pad = F.pad(x, (0, 0, 1, 1, 1, 1))
    h, w = x.shape[1], x.shape[2]
    return torch.stack([pad[:, dy:dy + h, dx:dx + w] for dy in range(3)
                        for dx in range(3)], dim=3)


def conv(m: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """A Conv2d on channels-last (B, H, W, C)."""
    return m(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)


def position_embedding_sine(h: int, w: int, num_pos_feats: int = 64,
                            temperature: float = 10000.0,
                            device=None) -> torch.Tensor:
    """DETR sine embedding, normalize=True, scale=2pi -> (H, W, 2F), the y
    block first (gmflow position.py)."""
    scale = 2 * math.pi
    ones = torch.ones((h, w), device=device)
    y_embed = torch.arange(1, h + 1, dtype=torch.float32,
                           device=device)[:, None]
    x_embed = torch.arange(1, w + 1, dtype=torch.float32,
                           device=device)[None, :]
    y_embed = y_embed / (h + 1e-6) * scale * ones
    x_embed = x_embed / (w + 1e-6) * scale * ones
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=device)
    dim_t = temperature ** (2 * torch.div(dim_t, 2, rounding_mode='floor')
                            / num_pos_feats)
    pos_x = x_embed[..., None] / dim_t
    pos_y = y_embed[..., None] / dim_t
    pos_x = torch.stack([torch.sin(pos_x[..., 0::2]),
                         torch.cos(pos_x[..., 1::2])], -1).reshape(h, w, -1)
    pos_y = torch.stack([torch.sin(pos_y[..., 0::2]),
                         torch.cos(pos_y[..., 1::2])], -1).reshape(h, w, -1)
    return torch.cat([pos_y, pos_x], dim=-1)


def split_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    """(B, H, W, C) -> (B*k*k, H/k, W/k, C), window-major row order."""
    b, h, w, c = x.shape
    x = x.reshape(b, k, h // k, k, w // k, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b * k * k, h // k, w // k, c)


def merge_windows(x: torch.Tensor, k: int) -> torch.Tensor:
    bkk, hh, ww, c = x.shape
    b = bkk // (k * k)
    x = x.reshape(b, k, k, hh, ww, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, k * hh, k * ww, c)


def shift_window_attn_mask(h: int, w: int, win_h: int, win_w: int,
                           shift_h: int, shift_w: int) -> np.ndarray:
    """Swin shifted-window mask: (K*K, win, win), 0 within a region, -100
    across regions (gmflow geometry.generate_shift_window_attn_mask)."""
    img = np.zeros((h, w), np.float32)
    cnt = 0
    for hs in (slice(0, -win_h), slice(-win_h, -shift_h),
               slice(-shift_h, None)):
        for ws in (slice(0, -win_w), slice(-win_w, -shift_w),
                   slice(-shift_w, None)):
            img[hs, ws] = cnt
            cnt += 1
    k = w // win_w
    wins = img.reshape(k, win_h, k, win_w).transpose(0, 2, 1, 3).reshape(
        k * k, win_h * win_w)
    mask = wins[:, None, :] - wins[:, :, None]
    return np.where(mask != 0, -100.0, 0.0).astype(np.float32)


# ---------------------------------------------------------------------------
# modules (names are the published checkpoint's)
# ---------------------------------------------------------------------------


class ResidualBlock(nn.Module):
    """RAFT's residual block with instance norms (no parameters); a 1x1
    `downsample` where the stride or the width changes."""

    def __init__(self, in_planes: int, planes: int, stride: int = 1):
        super().__init__()
        self.conv1 = nn.Conv2d(in_planes, planes, 3, stride, 1)
        self.conv2 = nn.Conv2d(planes, planes, 3, 1, 1)
        self.downsample = (nn.Sequential(nn.Conv2d(in_planes, planes, 1,
                                                   stride))
                           if stride != 1 or in_planes != planes else None)

    def forward(self, x):
        y = F.relu(instance_norm(conv(self.conv1, x)))
        y = F.relu(instance_norm(conv(self.conv2, y)))
        if self.downsample is not None:
            x = instance_norm(conv(self.downsample[0], x))
        return F.relu(x + y)


class TridentConv(nn.Module):
    """The backbone's weight-shared, bias-free 3x3 conv applied at several
    strides (MultiScaleTridentConv)."""

    def __init__(self, channels: int):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, channels, 3, 3))
        nn.init.kaiming_uniform_(self.weight, a=1)

    def forward(self, x, stride: int):
        return F.conv2d(x.permute(0, 3, 1, 2), self.weight, None, stride,
                        1).permute(0, 2, 3, 1)


class CNNEncoder(nn.Module):
    """(B, H, W, 3) -> [f_1/8, f_1/4] (coarsest first)."""

    def __init__(self, output_dim: int = 128):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64),
                                    ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2),
                                    ResidualBlock(96, 96))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128),
                                    ResidualBlock(128, 128))
        self.conv2 = nn.Conv2d(128, output_dim, 1)
        self.trident_conv = TridentConv(output_dim)

    def forward(self, x):
        x = F.relu(instance_norm(conv(self.conv1, x)))
        x = self.layer3(self.layer2(self.layer1(x)))
        x = conv(self.conv2, x)
        return [self.trident_conv(x, 2), self.trident_conv(x, 1)]


class TransformerLayer(nn.Module):
    def __init__(self, d_model: int = 128, no_ffn: bool = False,
                 ffn_expansion: int = 4):
        super().__init__()
        self.no_ffn = no_ffn
        self.q_proj = nn.Linear(d_model, d_model)
        self.k_proj = nn.Linear(d_model, d_model)
        self.v_proj = nn.Linear(d_model, d_model)
        self.merge = nn.Linear(d_model, d_model)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-6)
        if not no_ffn:
            hidden = 2 * d_model * ffn_expansion
            self.mlp = nn.Sequential(
                nn.Linear(2 * d_model, hidden, bias=False), nn.GELU(),
                nn.Linear(hidden, d_model, bias=False))
            self.norm2 = nn.LayerNorm(d_model, eps=1e-6)

    def forward(self, source, target, h, w, splits, with_shift, attn_mask):
        q, k, v = self.q_proj(source), self.k_proj(target), \
            self.v_proj(target)
        c = q.shape[-1]
        b = source.shape[0]
        if splits > 1:
            win_h, win_w = h // splits, w // splits
            qg, kg, vg = (t.reshape(b, h, w, c) for t in (q, k, v))
            if with_shift:
                sh, sw = win_h // 2, win_w // 2
                qg, kg, vg = (torch.roll(t, (-sh, -sw), dims=(1, 2))
                              for t in (qg, kg, vg))
            qs, ks, vs = (split_windows(t, splits).reshape(
                -1, win_h * win_w, c) for t in (qg, kg, vg))
            scores = torch.matmul(qs, ks.transpose(1, 2)) / (c ** 0.5)
            if with_shift:
                scores = scores + attn_mask.repeat(b, 1, 1)
            out = torch.matmul(torch.softmax(scores, dim=-1), vs)
            out = merge_windows(out.reshape(-1, win_h, win_w, c), splits)
            if with_shift:
                out = torch.roll(out, (win_h // 2, win_w // 2), dims=(1, 2))
            message = out.reshape(b, h * w, c)
        else:
            scores = torch.matmul(q, k.transpose(1, 2)) / (c ** 0.5)
            message = torch.matmul(torch.softmax(scores, dim=-1), v)
        message = self.norm1(self.merge(message))
        if not self.no_ffn:
            message = self.norm2(self.mlp(torch.cat([source, message], -1)))
        return source + message


class TransformerBlock(nn.Module):
    def __init__(self, d_model: int = 128, ffn_expansion: int = 4):
        super().__init__()
        self.self_attn = TransformerLayer(d_model, no_ffn=True)
        self.cross_attn_ffn = TransformerLayer(d_model,
                                               ffn_expansion=ffn_expansion)

    def forward(self, source, target, h, w, splits, with_shift, attn_mask):
        source = self.self_attn(source, source, h, w, splits, with_shift,
                                attn_mask)
        return self.cross_attn_ffn(source, target, h, w, splits, with_shift,
                                   attn_mask)


class FeatureTransformer(nn.Module):
    def __init__(self, num_layers: int = 6, d_model: int = 128,
                 ffn_expansion: int = 4):
        super().__init__()
        self.layers = nn.ModuleList(TransformerBlock(d_model, ffn_expansion)
                                    for _ in range(num_layers))

    def forward(self, feature0, feature1, splits: int):
        """(B, H, W, C) pair -> both directions via the [f0; f1] / [f1; f0]
        batch."""
        b, h, w, c = feature0.shape
        mask = None
        if splits > 1:
            mask = torch.from_numpy(shift_window_attn_mask(
                h, w, h // splits, w // splits, h // splits // 2,
                w // splits // 2)).to(feature0.device)
        concat0 = torch.cat([feature0, feature1]).reshape(2 * b, h * w, c)
        concat1 = torch.cat([feature1, feature0]).reshape(2 * b, h * w, c)
        for i, layer in enumerate(self.layers):
            with_shift = splits > 1 and i % 2 == 1
            concat0 = layer(concat0, concat1, h, w, splits, with_shift, mask)
            concat1 = torch.cat([concat0[b:], concat0[:b]])
        return (concat0[:b].reshape(b, h, w, c),
                concat0[b:].reshape(b, h, w, c))


class SelfAttnPropagation(nn.Module):
    """Flow propagation: feature self-attention with the flow as value. In
    the global path the key projection takes the ALREADY q-projected
    features, as the published model does."""

    def __init__(self, in_channels: int = 128):
        super().__init__()
        self.q_proj = nn.Linear(in_channels, in_channels)
        self.k_proj = nn.Linear(in_channels, in_channels)

    def forward(self, feature, flow, local_radius: int):
        b, h, w, c = feature.shape
        if local_radius <= 0:
            q = self.q_proj(feature.reshape(b, h * w, c))
            k = self.k_proj(q)
            v = flow.reshape(b, h * w, flow.shape[-1])
            scores = torch.matmul(q, k.transpose(1, 2)) / (c ** 0.5)
            out = torch.matmul(torch.softmax(scores, dim=-1), v)
            return out.reshape(b, h, w, -1)
        if local_radius != 1:
            raise ValueError('the reference config propagates at radius 1')
        q = self.q_proj(feature)
        k_win = unfold3x3(self.k_proj(feature))        # (B, H, W, 9, C)
        v_win = unfold3x3(flow)                        # (B, H, W, 9, D)
        scores = torch.einsum('bhwc,bhwkc->bhwk', q, k_win) / (c ** 0.5)
        return torch.einsum('bhwk,bhwkd->bhwd',
                            torch.softmax(scores, dim=-1), v_win)


class BasicMotionEncoder(nn.Module):
    def __init__(self, corr_channels: int = 81, flow_dim: int = 2):
        super().__init__()
        self.convc1 = nn.Conv2d(corr_channels, 256, 1)
        self.convc2 = nn.Conv2d(256, 192, 3, padding=1)
        self.convf1 = nn.Conv2d(flow_dim, 128, 7, padding=3)
        self.convf2 = nn.Conv2d(128, 64, 3, padding=1)
        self.conv = nn.Conv2d(64 + 192, 128 - flow_dim, 3, padding=1)

    def forward(self, flow, corr):
        cor = F.relu(conv(self.convc2, F.relu(conv(self.convc1, corr))))
        flo = F.relu(conv(self.convf2, F.relu(conv(self.convf1, flow))))
        out = F.relu(conv(self.conv, torch.cat([cor, flo], -1)))
        return torch.cat([out, flow], -1)


class SepConvGRU(nn.Module):
    def __init__(self, hidden_dim: int = 128, input_dim: int = 256):
        super().__init__()
        hi = hidden_dim + input_dim
        for name, k, p in (('1', (1, 5), (0, 2)), ('2', (5, 1), (2, 0))):
            for gate in 'zrq':
                setattr(self, f'conv{gate}{name}',
                        nn.Conv2d(hi, hidden_dim, k, padding=p))

    def forward(self, h, x):
        for name in '12':
            hx = torch.cat([h, x], -1)
            z = torch.sigmoid(conv(getattr(self, f'convz{name}'), hx))
            r = torch.sigmoid(conv(getattr(self, f'convr{name}'), hx))
            q = torch.tanh(conv(getattr(self, f'convq{name}'),
                                torch.cat([r * h, x], -1)))
            h = (1 - z) * h + z * q
        return h


class FlowHead(nn.Module):
    def __init__(self, input_dim: int = 128, hidden_dim: int = 256,
                 out_dim: int = 2):
        super().__init__()
        self.conv1 = nn.Conv2d(input_dim, hidden_dim, 3, padding=1)
        self.conv2 = nn.Conv2d(hidden_dim, out_dim, 3, padding=1)

    def forward(self, x):
        return conv(self.conv2, F.relu(conv(self.conv1, x)))


class BasicUpdateBlock(nn.Module):
    def __init__(self, corr_channels: int = 81, downsample_factor: int = 4,
                 flow_dim: int = 2):
        super().__init__()
        self.encoder = BasicMotionEncoder(corr_channels, flow_dim)
        self.gru = SepConvGRU(128, 256)
        self.flow_head = FlowHead(128, 256, flow_dim)
        self.mask = nn.Sequential(
            nn.Conv2d(128, 256, 3, padding=1), nn.ReLU(),
            nn.Conv2d(256, downsample_factor ** 2 * 9, 1))

    def forward(self, net, inp, corr, flow):
        inp = torch.cat([inp, self.encoder(flow, corr)], -1)
        net = self.gru(net, inp)
        return net, conv(self.mask, net), self.flow_head(net)


# ---------------------------------------------------------------------------
# matching / propagation math
# ---------------------------------------------------------------------------


def global_correlation_softmax_bidir(f0, f1):
    """(B, H, W, C) pair -> bidirectional flow (2B, H, W, 2): forward, then
    backward (the correlation's transpose)."""
    b, h, w, c = f0.shape
    corr = torch.matmul(f0.reshape(b, -1, c),
                        f1.reshape(b, -1, c).transpose(1, 2)) / (c ** 0.5)
    corr = torch.cat([corr, corr.transpose(1, 2)])
    grid = coords_grid(1, h, w, f0.device).reshape(1, -1, 2)
    prob = torch.softmax(corr, dim=-1)
    correspondence = torch.matmul(prob, grid.expand(2 * b, h * w, 2))
    return (correspondence.reshape(2 * b, h, w, 2)
            - coords_grid(2 * b, h, w, f0.device))


def _window_offsets(radius: int, device=None) -> torch.Tensor:
    r = torch.arange(-radius, radius + 1, dtype=torch.float32,
                     device=device)
    dy, dx = torch.meshgrid(r, r, indexing='ij')
    return torch.stack([dx.reshape(-1), dy.reshape(-1)], -1)  # (K^2, 2)


def local_correlation_softmax(f0, f1, radius: int):
    """Local matching: a softmax over the (2r+1)^2 window, candidates
    outside the image masked out; the residual flow (f1 pre-warped)."""
    b, h, w, c = f0.shape
    grid = coords_grid(b, h, w, f0.device)
    sample = grid[:, :, :, None, :] + _window_offsets(radius, f0.device)
    valid = ((sample[..., 0] >= 0) & (sample[..., 0] < w)
             & (sample[..., 1] >= 0) & (sample[..., 1] < h))
    window = grid_sample(f1, sample[..., 0], sample[..., 1])
    corr = torch.einsum('bhwc,bhwkc->bhwk', f0, window) / (c ** 0.5)
    corr = torch.where(valid, corr, torch.tensor(-1e9, device=f0.device))
    prob = torch.softmax(corr, dim=-1)
    return torch.einsum('bhwk,bhwkd->bhwd', prob, sample) - grid


def local_correlation_with_flow(f0, f1, flow, radius: int):
    """(B, H, W, (2r+1)^2) correlation at flow-shifted windows (the
    refinement's input; no masking, zero padding)."""
    b, h, w, c = f0.shape
    grid = coords_grid(b, h, w, f0.device)
    sample = (grid + flow)[:, :, :, None, :] + _window_offsets(radius,
                                                               f0.device)
    window = grid_sample(f1, sample[..., 0], sample[..., 1])
    return torch.einsum('bhwc,bhwkc->bhwk', f0, window) / (c ** 0.5)


def flow_warp(feature, flow):
    b, h, w, _ = feature.shape
    grid = coords_grid(b, h, w, feature.device) + flow
    return grid_sample(feature, grid[..., 0], grid[..., 1])


def upsample_flow_with_mask(flow, mask, factor: int):
    """RAFT's convex upsampling; mask (B, H, W, 9 f f), flow (B, H, W,
    2)."""
    b, h, w, _ = flow.shape
    m = mask.permute(0, 3, 1, 2).reshape(b, 9, factor, factor, h, w)
    m = torch.softmax(m, dim=1)
    taps = unfold3x3(factor * flow).permute(0, 3, 4, 1, 2)  # (B, 9, 2, H, W)
    up = (m[:, :, None] * taps[:, :, :, None, None]).sum(1)
    up = up.permute(0, 4, 2, 5, 3, 1)             # (B, H, f, W, f, 2)
    return up.reshape(b, h * factor, w * factor, 2)


# ---------------------------------------------------------------------------
# full model
# ---------------------------------------------------------------------------


class UniMatchFlow(nn.Module):
    """GMFlow scale2 + regrefine6, bidirectional. Input: two (B, H, W, 3)
    images in 0..255, H and W multiples of 32. Output (2B, H, W, 2) pixel
    flow, the forward half first."""

    def __init__(self, num_reg_refine: int = NUM_REG_REFINE):
        super().__init__()
        self.num_reg_refine = num_reg_refine
        self.backbone = CNNEncoder(128)
        self.transformer = FeatureTransformer(6, 128, 4)
        self.feature_flow_attn = SelfAttnPropagation(128)
        self.refine_proj = nn.Conv2d(128, 256, 1)
        self.refine = BasicUpdateBlock(corr_channels=(2 * 4 + 1) ** 2,
                                       downsample_factor=UPSAMPLE_FACTOR)

    def forward(self, img0, img1):
        b = img0.shape[0]
        dev = img0.device
        mean = torch.tensor(_IMAGENET_MEAN, device=dev)
        std = torch.tensor(_IMAGENET_STD, device=dev)
        feats = self.backbone(torch.cat([(img0 / 255.0 - mean) / std,
                                         (img1 / 255.0 - mean) / std]))
        f0_list = [f[:b] for f in feats]
        f1_list = [f[b:] for f in feats]

        flow = None
        for scale_idx in range(2):
            f0, f1 = f0_list[scale_idx], f1_list[scale_idx]
            if scale_idx > 0:
                # bidirectional: the batch doubled after the global matching
                f0, f1 = torch.cat([f0, f1]), torch.cat([f1, f0])
            f0_ori, f1_ori = f0, f1
            if scale_idx > 0:
                flow = resize_ac(flow, f0.shape[1], f0.shape[2]) * 2
                f1 = flow_warp(f1, flow)

            splits = ATTN_SPLITS[scale_idx]
            hh, ww = f0.shape[1], f0.shape[2]
            pos = position_embedding_sine(hh // splits, ww // splits, 64,
                                          device=dev)
            if splits > 1:
                pos = pos.repeat(splits, splits, 1)
            f0, f1 = self.transformer(f0 + pos, f1 + pos, splits)

            if CORR_RADIUS[scale_idx] == -1:
                flow_pred = global_correlation_softmax_bidir(f0, f1)
            else:
                flow_pred = local_correlation_softmax(f0, f1,
                                                      CORR_RADIUS[scale_idx])
            flow = flow_pred if flow is None else flow + flow_pred

            if scale_idx == 0:
                f0 = torch.cat([f0, f1])              # bidir propagation
            flow = self.feature_flow_attn(f0, flow, PROP_RADIUS[scale_idx])

            if scale_idx == 1:
                net, inp = conv(self.refine_proj, f0).chunk(2, dim=-1)
                net, inp = torch.tanh(net), F.relu(inp)
                for _ in range(self.num_reg_refine):
                    corr = local_correlation_with_flow(f0_ori, f1_ori, flow,
                                                       radius=4)
                    net, up_mask, delta = self.refine(net, inp, corr, flow)
                    flow = flow + delta
                flow = upsample_flow_with_mask(flow, up_mask,
                                               UPSAMPLE_FACTOR)
        return flow


# ---------------------------------------------------------------------------
# checkpoint + wrapper
# ---------------------------------------------------------------------------


def unwrap_state_dict(sd: dict) -> dict:
    """A published checkpoint's state dict: under 'model' where it is
    wrapped, without DataParallel's 'module.' prefixes."""
    if 'model' in sd and isinstance(sd['model'], dict):
        sd = sd['model']
    return {k[len('module.'):] if k.startswith('module.') else k: v
            for k, v in sd.items()}


def expected_checkpoint_keys() -> list:
    """The published checkpoint's key set."""
    return sorted(UniMatchFlow().state_dict())


class UniMatchWrapper:
    """The reference wrapper protocol (extract_flow.py:55-133): the long
    edge resized to <= 768 (align-corners bilinear), the frames transposed
    when H > W (the model is trained on landscape frames), resized to
    multiples of 32, a bidirectional run, the flow resized back with its
    components rescaled. compute_flow(img0, img1) -> (2, H, W, 2) float32
    numpy (forward, backward). Runs in fp32 with TF32 off on the model's
    device."""

    def __init__(self, model: UniMatchFlow):
        self.model = model.eval()

    @classmethod
    def from_checkpoint(cls, path: str, device=None,
                        num_reg_refine: int = NUM_REG_REFINE
                        ) -> 'UniMatchWrapper':
        """The checkpoint at `path` loaded strictly (device None: 'cuda')."""
        sd = unwrap_state_dict(torch.load(path, map_location='cpu',
                                          weights_only=False))
        model = UniMatchFlow(num_reg_refine)
        model.load_state_dict(sd, strict=True)
        return cls(model.to(torch.device(device or 'cuda'), torch.float32))

    @property
    def device(self) -> torch.device:
        return self.model.refine_proj.weight.device

    @torch.no_grad()
    def compute_flow(self, img0, img1) -> np.ndarray:
        dev = self.device
        img0 = torch.as_tensor(np.asarray(img0, np.float32)).to(dev)
        img1 = torch.as_tensor(np.asarray(img1, np.float32)).to(dev)
        if float(img0.max()) <= 1.5:             # [0, 1] inputs too
            img0, img1 = img0 * 255.0, img1 * 255.0
        h, w = img0.shape[:2]
        with fp32_math():
            factor = max(h, w) / MAX_LONG_EDGE
            if factor > 1:
                nh, nw = int(h // factor), int(w // factor)
                img0, img1 = resize_ac(img0, nh, nw), resize_ac(img1, nh, nw)
            else:
                nh, nw = h, w
            transpose = nh > nw
            if transpose:
                img0, img1 = img0.transpose(0, 1), img1.transpose(0, 1)
                nh, nw = nw, nh
            ih = int(np.ceil(nh / PADDING_FACTOR)) * PADDING_FACTOR
            iw = int(np.ceil(nw / PADDING_FACTOR)) * PADDING_FACTOR
            flow = self.model(resize_ac(img0[None], ih, iw),
                              resize_ac(img1[None], ih, iw))
            if (ih, iw) != (nh, nw):
                flow = resize_ac(flow, nh, nw) * torch.tensor(
                    [nw / iw, nh / ih], device=dev)
            if transpose:
                # the reference transposes the SPATIAL axes back
                # (extract_flow.py:128-129) without swapping the (x, y)
                # components: kept as it is (portrait clips only)
                flow = flow.transpose(1, 2)
            if factor > 1:
                flow = resize_ac(flow, h, w) * torch.tensor(
                    [w / flow.shape[2], h / flow.shape[1]], device=dev)
        return flow.cpu().numpy().astype(np.float32)
