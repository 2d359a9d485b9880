"""AutoencoderKL (SD-1.5 VAE), channels-last (the port of
videoswap_tpu/models/vae.py): 4-level encoder/decoder (128, 256, 512, 512),
GroupNorm(32, eps 1e-6), one-head mid-block attention, scaling 0.18215.
`encode_video` / `decode_video` fold frames into the batch;
`encode_video_moments` / `sample_video_from_moments` let a training loop
encode a video once and draw a fresh posterior sample at every step.

The mid-block attention (one head, d = 512, 4096 tokens at 512x512) is plain
matmul + softmax, as in the JAX package, where XLA computes it outside any
Pallas kernel.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from videoswap_torch.ops.subpixel import (naive_upsample_conv,
                                          subpixel_enabled,
                                          subpixel_upsample_conv)

from .layers import GroupNorm, conv2d_cl

SD_VAE_SCALING = 0.18215


class VAEResnetBlock(nn.Module):
    def __init__(self, in_channels: int, out_channels: int,
                 norm_groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(norm_groups, in_channels, eps=1e-6)
        self.conv1 = nn.Conv2d(in_channels, out_channels, 3, padding=1)
        self.norm2 = GroupNorm(norm_groups, out_channels, eps=1e-6)
        self.conv2 = nn.Conv2d(out_channels, out_channels, 3, padding=1)
        self.conv_shortcut = (nn.Conv2d(in_channels, out_channels, 1)
                              if in_channels != out_channels else None)

    def forward(self, x):
        h = conv2d_cl(self.conv1, F.silu(self.norm1(x)))
        h = conv2d_cl(self.conv2, F.silu(self.norm2(h)))
        if self.conv_shortcut is not None:
            x = conv2d_cl(self.conv_shortcut, x)
        return x + h


class VAEAttention(nn.Module):
    """Single-head self-attention over the spatial tokens (mid block)."""

    def __init__(self, channels: int, norm_groups: int = 32):
        super().__init__()
        self.group_norm = GroupNorm(norm_groups, channels, eps=1e-6)
        self.to_q = nn.Linear(channels, channels)
        self.to_k = nn.Linear(channels, channels)
        self.to_v = nn.Linear(channels, channels)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels)])

    def forward(self, x):
        b, h, w, c = x.shape
        t = self.group_norm(x).reshape(b, h * w, c)
        q, k, v = self.to_q(t), self.to_k(t), self.to_v(t)
        logits = torch.bmm(q.float(), k.float().transpose(1, 2)) * c ** -0.5
        out = torch.bmm(torch.softmax(logits, dim=-1).to(v.dtype), v)
        return self.to_out[0](out.reshape(b, h, w, c)) + x


class _Sampler(nn.Module):
    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3)


class _DownBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, downsample: bool,
                 norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(cin if j == 0 else cout, cout, norm_groups)
            for j in range(layers)])
        self.downsamplers = (nn.ModuleList([_Sampler(cout)])
                             if downsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.downsamplers is not None:
            # diffusers: stride-2 'VALID' conv after a (0, 1) pad
            conv = self.downsamplers[0].conv
            x = F.conv2d(F.pad(x.permute(0, 3, 1, 2), (0, 1, 0, 1)),
                         conv.weight, conv.bias, stride=2).permute(0, 2, 3, 1)
        return x


class _UpBlock(nn.Module):
    def __init__(self, cin: int, cout: int, layers: int, upsample: bool,
                 norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([
            VAEResnetBlock(cin if j == 0 else cout, cout, norm_groups)
            for j in range(layers)])
        self.upsamplers = (nn.ModuleList([_Sampler(cout)])
                           if upsample else None)

    def forward(self, x):
        for r in self.resnets:
            x = r(x)
        if self.upsamplers is not None:
            conv = self.upsamplers[0].conv
            if subpixel_enabled():
                x = subpixel_upsample_conv(x, conv.weight, conv.bias)
            else:
                h, w = x.shape[1:3]
                x = naive_upsample_conv(x, conv.weight, conv.bias,
                                        (2 * h, 2 * w))
        return x


class _MidBlock(nn.Module):
    def __init__(self, ch: int, norm_groups: int):
        super().__init__()
        self.resnets = nn.ModuleList([VAEResnetBlock(ch, ch, norm_groups),
                                      VAEResnetBlock(ch, ch, norm_groups)])
        self.attentions = nn.ModuleList([VAEAttention(ch, norm_groups)])

    def forward(self, x):
        x = self.resnets[0](x)
        x = self.attentions[0](x)
        return self.resnets[1](x)


class Encoder(nn.Module):
    def __init__(self,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, latent_channels: int = 4,
                 norm_groups: int = 32, in_channels: int = 3):
        super().__init__()
        chans = list(block_out_channels)
        self.conv_in = nn.Conv2d(in_channels, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList([
            _DownBlock(chans[max(i - 1, 0)], ch, layers_per_block,
                       i < len(chans) - 1, norm_groups)
            for i, ch in enumerate(chans)])
        self.mid_block = _MidBlock(chans[-1], norm_groups)
        self.conv_norm_out = GroupNorm(norm_groups, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], 2 * latent_channels, 3,
                                  padding=1)

    def forward(self, x):
        x = conv2d_cl(self.conv_in, x)
        for block in self.down_blocks:
            x = block(x)
        x = self.mid_block(x)
        return conv2d_cl(self.conv_out, F.silu(self.conv_norm_out(x)))


class Decoder(nn.Module):
    def __init__(self,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 layers_per_block: int = 2, out_channels: int = 3,
                 norm_groups: int = 32, latent_channels: int = 4):
        super().__init__()
        chans = list(reversed(block_out_channels))
        self.conv_in = nn.Conv2d(latent_channels, chans[0], 3, padding=1)
        self.mid_block = _MidBlock(chans[0], norm_groups)
        self.up_blocks = nn.ModuleList([
            _UpBlock(chans[max(i - 1, 0)], ch, layers_per_block + 1,
                     i < len(chans) - 1, norm_groups)
            for i, ch in enumerate(chans)])
        self.conv_norm_out = GroupNorm(norm_groups, chans[-1], eps=1e-6)
        self.conv_out = nn.Conv2d(chans[-1], out_channels, 3, padding=1)

    def forward(self, z):
        x = conv2d_cl(self.conv_in, z)
        x = self.mid_block(x)
        for block in self.up_blocks:
            x = block(x)
        return conv2d_cl(self.conv_out, F.silu(self.conv_norm_out(x)))


class AutoencoderKL(nn.Module):
    def __init__(self,
                 block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4,
                 scaling_factor: float = SD_VAE_SCALING,
                 norm_groups: int = 32):
        super().__init__()
        self.scaling_factor = scaling_factor
        self.encoder = Encoder(block_out_channels,
                               latent_channels=latent_channels,
                               norm_groups=norm_groups)
        self.decoder = Decoder(block_out_channels, norm_groups=norm_groups,
                               latent_channels=latent_channels)
        self.quant_conv = nn.Conv2d(2 * latent_channels, 2 * latent_channels,
                                    1)
        self.post_quant_conv = nn.Conv2d(latent_channels, latent_channels, 1)

    def _dtype(self):
        return self.post_quant_conv.weight.dtype

    def encode_moments(self, x):
        """image [B, H, W, 3] -> (mean, logvar) each [B, H/8, W/8, 4]."""
        moments = conv2d_cl(self.quant_conv, self.encoder(x.to(self._dtype())))
        mean, logvar = moments.chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def encode(self, x, generator: Optional[torch.Generator] = None):
        """Posterior sample (mode without a generator), already scaled."""
        mean, logvar = self.encode_moments(x)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator,
                                device=mean.device, dtype=mean.dtype)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * self.scaling_factor

    def decode(self, z):
        z = (z / self.scaling_factor).to(self._dtype())
        return self.decoder(conv2d_cl(self.post_quant_conv, z))

    def encode_video(self, video, generator=None):
        """(B, F, H, W, 3) -> (B, F, H/8, W/8, 4) scaled latents."""
        b, f = video.shape[:2]
        z = self.encode(video.reshape(b * f, *video.shape[2:]), generator)
        return z.reshape(b, f, *z.shape[1:])

    def encode_video_moments(self, video):
        """(B, F, H, W, 3) -> posterior (mean, logvar), each
        (B, F, H/8, W/8, 4), unscaled."""
        b, f = video.shape[:2]
        mean, logvar = self.encode_moments(
            video.reshape(b * f, *video.shape[2:]))
        return (mean.reshape(b, f, *mean.shape[1:]),
                logvar.reshape(b, f, *logvar.shape[1:]))

    def sample_video_from_moments(self, mean, logvar,
                                  eps: Optional[torch.Tensor] = None,
                                  generator: Optional[torch.Generator] = None):
        """The scaled posterior sample `encode_video` draws, from cached
        moments: `eps` (mean's shape, or frames folded into the batch) or,
        without it, a standard normal draw from `generator`."""
        if eps is None:
            eps = torch.randn(mean.shape, generator=generator,
                              device=mean.device, dtype=mean.dtype)
        z = mean + torch.exp(0.5 * logvar) * eps.reshape(mean.shape).to(
            mean.dtype)
        return z * self.scaling_factor

    def decode_video(self, latents):
        """(B, F, h, w, 4) -> (B, F, 8h, 8w, 3) in [-1, 1] (unclipped)."""
        b, f = latents.shape[:2]
        x = self.decode(latents.reshape(b * f, *latents.shape[2:]))
        return x.reshape(b, f, *x.shape[1:])
