"""CoTracker v1 (stride 4, window 8) point tracker: the port of
videoswap_tpu/preprocess/cotracker_native.py, whose docstring gives the
architecture (a stride-4 feature encoder, a 4-level correlation pyramid
sampled on a 7x7 window, an update transformer alternating attention over
time and over tracks, 6 iterations a window) and the v1 predictor protocol
(frames resized to 384x512, windows of 8 frames at stride 4, backward
tracking on the time-reversed video for the frames before a query).

The modules carry the published `cotracker_stride_4_wind_8.pth` names
(`fnet.*`, `updateformer.{time,space}_blocks.N.*`, `norm.*`,
`ffeat_updater.0.*`, `vis_predictor.0.*`), so that the file loads into
`CoTrackerCore` strictly, as it is. Activations are channels-last, as in
the JAX package; the attention blocks' LayerNorm has no affine and their
MLP uses the tanh GELU, the feature updater the exact one. Everything runs
in fp32 with TF32 off on the model's device.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .flow import fp32_math
from .unimatch import (ResidualBlock, conv, grid_sample, instance_norm,
                       resize_ac, unwrap_state_dict)

WINDOW = 8
STRIDE = 4
LATENT_DIM = 128
CORR_LEVELS = 4
CORR_RADIUS = 3
INPUT_DIM = 456
HIDDEN_SIZE = 384
NUM_HEADS = 8
DEPTH = 6
INTERP_SHAPE = (384, 512)
ITERS = 6


class BasicEncoder(nn.Module):
    """(B, H, W, 3) in [-1, 1] -> (B, H/4, W/4, 128)."""

    def __init__(self, output_dim: int = LATENT_DIM):
        super().__init__()
        self.conv1 = nn.Conv2d(3, 64, 7, 2, 3)
        self.layer1 = nn.Sequential(ResidualBlock(64, 64),
                                    ResidualBlock(64, 64))
        self.layer2 = nn.Sequential(ResidualBlock(64, 96, 2),
                                    ResidualBlock(96, 96))
        self.layer3 = nn.Sequential(ResidualBlock(96, 128, 2),
                                    ResidualBlock(128, 128))
        self.layer4 = nn.Sequential(ResidualBlock(128, 128, 2),
                                    ResidualBlock(128, 128))
        self.conv2 = nn.Conv2d(64 + 96 + 128 + 128, output_dim * 2, 3,
                               padding=1)
        self.conv3 = nn.Conv2d(output_dim * 2, output_dim, 1)

    def forward(self, x):
        h, w = x.shape[1], x.shape[2]
        x = F.relu(instance_norm(conv(self.conv1, x)))
        a = self.layer1(x)
        b = self.layer2(a)
        c = self.layer3(b)
        d = self.layer4(c)
        ho, wo = h // STRIDE, w // STRIDE
        cat = torch.cat([resize_ac(t, ho, wo) for t in (a, b, c, d)], -1)
        x = F.relu(instance_norm(conv(self.conv2, cat)))
        return conv(self.conv3, x)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int):
        super().__init__()
        self.heads = heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)

    def forward(self, x):
        b, n, c = x.shape
        dh = c // self.heads
        qkv = self.qkv(x).reshape(b, n, 3, self.heads, dh).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv[0], qkv[1], qkv[2]
        logits = torch.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
        out = torch.matmul(torch.softmax(logits, dim=-1), v)
        return self.proj(out.permute(0, 2, 1, 3).reshape(b, n, c))


class Mlp(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate='tanh'))


class AttnBlock(nn.Module):
    """Pre-LN (no affine, eps 1e-6) attention and tanh-GELU MLP x4."""

    def __init__(self, hidden: int = HIDDEN_SIZE, heads: int = NUM_HEADS):
        super().__init__()
        self.attn = Attention(hidden, heads)
        self.mlp = Mlp(hidden, 4 * hidden)

    def forward(self, x):
        c = x.shape[-1]
        x = x + self.attn(F.layer_norm(x, (c,), eps=1e-6))
        return x + self.mlp(F.layer_norm(x, (c,), eps=1e-6))


class UpdateFormer(nn.Module):
    def __init__(self, depth: int = DEPTH):
        super().__init__()
        self.input_transform = nn.Linear(INPUT_DIM, HIDDEN_SIZE)
        self.flow_head = nn.Linear(HIDDEN_SIZE, LATENT_DIM + 2)
        self.time_blocks = nn.ModuleList(AttnBlock() for _ in range(depth))
        self.space_blocks = nn.ModuleList(AttnBlock() for _ in range(depth))

    def forward(self, x):
        """x: (B, N, T, INPUT_DIM) -> (B, N, T, LATENT_DIM + 2)."""
        b, n, t, _ = x.shape
        x = self.input_transform(x)
        for tb, sb in zip(self.time_blocks, self.space_blocks):
            x = tb(x.reshape(b * n, t, HIDDEN_SIZE)).reshape(
                b, n, t, HIDDEN_SIZE)
            xs = x.permute(0, 2, 1, 3).reshape(b * t, n, HIDDEN_SIZE)
            x = sb(xs).reshape(b, t, n, HIDDEN_SIZE).permute(0, 2, 1, 3)
        return self.flow_head(x)


# ---------------------------------------------------------------------------
# embeddings (pips / MAE conventions)
# ---------------------------------------------------------------------------


def get_2d_embedding(xy: torch.Tensor, C: int = 64) -> torch.Tensor:
    """pips get_2d_embedding(cat_coords=True): [.., 2] -> [.., 2 + 2C], the
    coordinates first, then interleaved sin / cos of x, then of y, at the
    linear frequencies arange(0, C, 2) * (1000 / C)."""
    x, y = xy[..., 0:1], xy[..., 1:2]
    div = torch.from_numpy(np.arange(0, C, 2, dtype=np.float32)
                           * (1000.0 / C)).to(xy.device)
    pe_x = torch.stack([torch.sin(x * div), torch.cos(x * div)],
                       -1).reshape(*xy.shape[:-1], C)
    pe_y = torch.stack([torch.sin(y * div), torch.cos(y * div)],
                       -1).reshape(*xy.shape[:-1], C)
    return torch.cat([xy, pe_x, pe_y], dim=-1)


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    omega = np.arange(embed_dim // 2, dtype=np.float64)
    omega = 1.0 / 10000 ** (omega / (embed_dim / 2.0))
    out = np.einsum('m,d->md', pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)],
                          axis=1).astype(np.float32)


def get_2d_sincos_pos_embed(embed_dim: int, gh: int, gw: int) -> np.ndarray:
    """MAE grid embedding -> (gh, gw, embed_dim); the first half embeds the
    W mesh (MAE's meshgrid(w, h) order)."""
    grid_w, grid_h = np.meshgrid(np.arange(gw, dtype=np.float32),
                                 np.arange(gh, dtype=np.float32))
    emb_a = _sincos_1d(embed_dim // 2, grid_w)
    emb_b = _sincos_1d(embed_dim // 2, grid_h)
    return np.concatenate([emb_a, emb_b], axis=1).reshape(gh, gw, embed_dim)


# ---------------------------------------------------------------------------
# core model
# ---------------------------------------------------------------------------


def _corr_pyramid(fmaps: torch.Tensor) -> list:
    """fmaps (S, H, W, C) -> CORR_LEVELS 2x2-average-pooled levels."""
    pyr = [fmaps]
    x = fmaps
    for _ in range(CORR_LEVELS - 1):
        x = F.avg_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
        pyr.append(x)
    return pyr


def _corr_offsets(device=None) -> torch.Tensor:
    """The (2r+1)^2 window's offsets in RAFT's stack(meshgrid(dy, dx)) order
    (the first axis is added to x)."""
    r = CORR_RADIUS
    k = 2 * r + 1
    da, db = np.meshgrid(np.linspace(-r, r, k), np.linspace(-r, r, k),
                         indexing='ij')
    return torch.tensor(np.stack([da.reshape(-1), db.reshape(-1)], -1),
                        dtype=torch.float32, device=device)


def _corr_sample(pyramid: list, ffeats: torch.Tensor,
                 coords: torch.Tensor) -> torch.Tensor:
    """Correlation features: ffeats (S, N, C) dotted with each pyramid
    level, sampled on a (2r+1)^2 window around coords / 2^i (coords (S, N,
    2) in stride units) -> (S, N, levels * (2r+1)^2)."""
    offs = _corr_offsets(coords.device)
    out = []
    for i, fm in enumerate(pyramid):
        c = fm.shape[-1]
        corr = torch.einsum('snc,shwc->snhw', ffeats, fm) / math.sqrt(c)
        s, n, hh, ww = corr.shape
        corr = corr.reshape(s * n, hh, ww, 1)
        sample = coords.reshape(s * n, 1, 2) / (2 ** i) + offs[None]
        vals = grid_sample(corr, sample[..., 0], sample[..., 1])
        out.append(vals.reshape(s, n, offs.shape[0]))
    return torch.cat(out, dim=-1)


class CoTrackerCore(nn.Module):
    """One window's iterative refinement (forward_iteration). fmaps (S,
    H/4, W/4, C); coords_init (S, N, 2) in PIXELS; feat_init (N, C);
    vis_init and track_mask (S, N). Returns (coords (S, N, 2) in pixels,
    visibility logits (S, N), track features (S, N, C))."""

    def __init__(self, iters: int = ITERS):
        super().__init__()
        self.iters = iters
        self.fnet = BasicEncoder()
        self.updateformer = UpdateFormer()
        self.norm = nn.GroupNorm(1, LATENT_DIM, eps=1e-5)
        self.ffeat_updater = nn.Sequential(
            nn.Linear(LATENT_DIM, LATENT_DIM), nn.GELU())
        self.vis_predictor = nn.Sequential(nn.Linear(LATENT_DIM, 1))

    def encode(self, frames: torch.Tensor) -> torch.Tensor:
        return self.fnet(frames)

    def forward(self, fmaps, coords_init, feat_init, vis_init, track_mask):
        s, hh, ww, _ = fmaps.shape
        n = coords_init.shape[1]
        dev = fmaps.device
        coords = coords_init / STRIDE
        ffeats = feat_init[None].expand(s, n, LATENT_DIM)
        pyramid = _corr_pyramid(fmaps)

        pos_grid = torch.from_numpy(get_2d_sincos_pos_embed(
            INPUT_DIM, hh, ww)).to(dev)
        pos_embed = grid_sample(pos_grid[None], coords[None, 0, :, 0],
                                coords[None, 0, :, 1])[0]      # (N, 456)
        times_embed = torch.from_numpy(_sincos_1d(
            INPUT_DIM, np.arange(s, dtype=np.float32))).to(dev)  # (S, 456)
        extra = torch.stack([track_mask.float(), vis_init.float()], -1)

        for _ in range(self.iters):
            fcorrs = _corr_sample(pyramid, ffeats, coords)      # (S, N, 196)
            flows_cat = get_2d_embedding(coords - coords[0:1])  # (S, N, 130)
            x = (torch.cat([flows_cat, fcorrs, ffeats, extra], -1)
                 + pos_embed[None] + times_embed[:, None])
            delta = self.updateformer(x.permute(1, 0, 2)[None])
            delta = delta[0].permute(1, 0, 2)                   # (S, N, 130)
            coords = coords + delta[..., :2]
            dfeat = self.norm(delta[..., 2:].reshape(-1, LATENT_DIM))
            ffeats = ffeats + self.ffeat_updater(dfeat).reshape(
                s, n, LATENT_DIM)
        vis = self.vis_predictor(ffeats.reshape(-1, LATENT_DIM))
        return coords * STRIDE, vis.reshape(s, n), ffeats


def expected_checkpoint_keys() -> list:
    """The published checkpoint's key set."""
    return sorted(CoTrackerCore().state_dict())


# ---------------------------------------------------------------------------
# predictor (sliding window + backward tracking)
# ---------------------------------------------------------------------------


class NativeCoTrackerPredictor:
    """The CoTrackerPredictor surface of the reference call
    (extract_semantic_point.py:104-108): `predictor(video, queries,
    backward_tracking=True)` -> (tracks (1, T, N, 2), visibility (1, T, N)),
    numpy. video (1, T, 3, H, W) float 0..255 (torch layout) or (T, H, W,
    3); queries (1, N, 3) [t, x, y]. The model runs on its own device."""

    def __init__(self, model: CoTrackerCore):
        self.model = model.eval()

    @classmethod
    def from_checkpoint(cls, path: str,
                        device=None) -> 'NativeCoTrackerPredictor':
        """The checkpoint at `path` loaded strictly (device None: 'cuda')."""
        sd = unwrap_state_dict(torch.load(path, map_location='cpu',
                                          weights_only=False))
        model = CoTrackerCore()
        model.load_state_dict(sd, strict=True)
        return cls(model.to(torch.device(device or 'cuda'), torch.float32))

    @property
    def device(self) -> torch.device:
        return self.model.norm.weight.device

    @torch.no_grad()
    def __call__(self, video, queries, backward_tracking: bool = True):
        video = np.asarray(video, np.float32)
        if video.ndim == 5:                      # (1, T, 3, H, W) torch
            video = video[0].transpose(0, 2, 3, 1)
        t, h, w = video.shape[:3]
        queries = np.asarray(queries, np.float32).reshape(-1, 3)
        ih, iw = INTERP_SHAPE
        with fp32_math():
            frames = resize_ac(torch.from_numpy(video).to(self.device),
                               ih, iw)
            q = queries.copy()
            q[:, 1] *= iw / w
            q[:, 2] *= ih / h

            tracks, vis = self._track(frames, q)
            if backward_tracking:
                inv_q = q.copy()
                inv_q[:, 0] = t - 1 - inv_q[:, 0]
                bt, bv = self._track(frames.flip(0), inv_q)
                bt, bv = bt[::-1], bv[::-1]
                missing = (tracks == 0).all(-1)          # frames before query
                tracks = np.where(missing[..., None], bt, tracks)
                vis = np.where(missing, bv, vis)

        tracks[..., 0] *= w / iw
        tracks[..., 1] *= h / ih
        return tracks[None], vis[None]

    def _track(self, frames: torch.Tensor, queries: np.ndarray):
        dev = frames.device
        t = frames.shape[0]
        n = queries.shape[0]
        first = queries[:, 0].astype(int)
        tracks = np.zeros((t, n, 2), np.float32)
        vis = np.zeros((t, n), np.float32)
        track_mask_full = (np.arange(t)[:, None] >= first[None])

        coords_init = None
        vis_init = np.full((WINDOW, n), 10.0, np.float32)
        feat_init = None
        active = None
        ind = 0
        while ind == 0 or ind < t - WINDOW // 2:
            seq = frames[ind:ind + WINDOW]
            s_local = seq.shape[0]
            if s_local < WINDOW:
                seq = torch.cat([seq, seq[-1:].expand(
                    WINDOW - s_local, *seq.shape[1:])])
            fmaps = self.model.encode(2 * (seq / 255.0) - 1.0)

            in_window = first < ind + WINDOW
            if not in_window.any():
                ind += WINDOW // 2
                continue
            if active is None or in_window.sum() > active.sum():
                # points entering: their query coordinate across the whole
                # window and the feature at their query frame and place
                new = in_window & (~active if active is not None
                                   else np.ones(n, bool))
                if coords_init is None:
                    coords_init = np.tile(queries[None, :, 1:],
                                          (WINDOW, 1, 1)).astype(np.float32)
                fidx = np.clip(first - ind, 0, WINDOW - 1)
                feats = grid_sample(
                    fmaps[torch.as_tensor(fidx[new], device=dev)],
                    torch.as_tensor(queries[new, 1] / STRIDE,
                                    device=dev)[:, None],
                    torch.as_tensor(queries[new, 2] / STRIDE,
                                    device=dev)[:, None])[:, 0]
                if feat_init is None:
                    feat_init = np.zeros((n, LATENT_DIM), np.float32)
                feat_init[new] = feats.cpu().numpy()
                coords_init[:, new] = queries[new, 1:][None]
                active = in_window.copy()

            tm = np.zeros((WINDOW, n), np.float32)
            tm[:s_local] = track_mask_full[ind:ind + s_local]
            tm[s_local:] = tm[s_local - 1:s_local]
            coords, v, _ = self.model(
                fmaps, *(torch.as_tensor(a, device=dev) for a in (
                    coords_init, feat_init, vis_init, tm)))
            coords = coords.cpu().numpy()
            v = v.cpu().numpy()
            sl = slice(ind, ind + s_local)
            write = track_mask_full[sl]
            tracks[sl] = np.where(write[..., None], coords[:s_local],
                                  tracks[sl])
            vis[sl] = np.where(write, v[:s_local], vis[sl])

            half = WINDOW // 2
            coords_init = np.concatenate(
                [coords[half:], np.repeat(coords[-1:], half, 0)], 0)
            vis_init = np.concatenate(
                [(v[half:] > 0).astype(np.float32) * 10,
                 np.repeat((v[-1:] > 0).astype(np.float32) * 10, half, 0)],
                0)
            ind += half
        return tracks, 1 / (1 + np.exp(-vis))


_COTRACKER_CKPT_ENV = 'VS_COTRACKER_CKPT'


def find_cotracker_checkpoint() -> Optional[str]:
    """$VS_COTRACKER_CKPT, else the published file where the JAX package
    looks for it (relative to the working directory), or None."""
    import glob
    import os
    cands = [os.environ.get(_COTRACKER_CKPT_ENV, ''),
             'pretrained_models/cotracker_stride_4_wind_8.pth',
             'thirdparty/co-tracker/checkpoints/'
             'cotracker_stride_4_wind_8.pth']
    cands += sorted(glob.glob('pretrained_models/cotracker*.pth'))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None
