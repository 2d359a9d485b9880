"""SD-1.5 U-Net inflated to video + AnimateDiff motion modules (the port of
videoswap_tpu/models/unet3d.py).

Channels-last (B, F, H, W, C) activations, frames folded into the batch for
the 2D ops; adapter residuals added to the LAST layer of each down block;
ED-LoRA layer-wise text (B, L, 77, D) sliced per cross-attention layer by a
static index; CFG-prefix dedup (see `AnimateDiffUNet3DModel.forward`);
gradient checkpointing per level (`set_gradient_checkpointing`). Submodule
names follow the diffusers keys.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from videoswap_torch.utils.registry import MODEL_REGISTRY

from .attention_blocks import Transformer3DModel
from .layers import GroupNorm, TimestepEmbedding, timestep_sinusoidal
from .motion_module import VanillaTemporalModule
from .resnet3d import Downsample3D, InflatedConv, ResnetBlock3D, Upsample3D


class UNet3DConfig(NamedTuple):
    in_channels: int = 4
    out_channels: int = 4
    block_out_channels: Sequence[int] = (320, 640, 1280, 1280)
    layers_per_block: int = 2
    attention_head_dim: int = 8          # diffusers legacy: number of heads
    cross_attention_dim: int = 768
    norm_num_groups: int = 32
    norm_eps: float = 1e-5
    use_motion_module: bool = True
    motion_module_resolutions: Sequence[int] = (1, 2, 4, 8)
    motion_module_mid_block: bool = False
    motion_heads: int = 8
    motion_num_transformer_block: int = 1
    motion_max_len: int = 24
    motion_window: Optional[int] = None          # not ported yet
    motion_window_stride: Optional[int] = None


def _motion(cfg: UNet3DConfig, ch: int) -> VanillaTemporalModule:
    return VanillaTemporalModule(
        ch, heads=cfg.motion_heads,
        num_transformer_block=cfg.motion_num_transformer_block,
        max_len=cfg.motion_max_len, norm_groups=cfg.norm_num_groups)


def _resnet(cfg: UNet3DConfig, cin: int, cout: int) -> ResnetBlock3D:
    return ResnetBlock3D(cin, cout, cfg.block_out_channels[0] * 4,
                         eps=cfg.norm_eps, groups=cfg.norm_num_groups)


def _transformer(cfg, ch, cross_layer_idx):
    heads = cfg.attention_head_dim
    return Transformer3DModel(ch, heads, ch // heads, cfg.cross_attention_dim,
                              cross_layer_idx=cross_layer_idx,
                              norm_groups=cfg.norm_num_groups)


class _Block(nn.Module):
    """A U-Net block whose ResnetBlock3D and Transformer3DModel layers (the
    two the JAX package wraps in `nn.remat`) are recomputed in the backward
    pass when `remat` is set and a graph is being recorded."""

    remat = False

    def _run(self, layer, *args, **kwargs):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(layer, *args, use_reentrant=False, **kwargs)
        return layer(*args, **kwargs)


class CrossAttnDownBlock3D(_Block):
    def __init__(self, cfg: UNet3DConfig, in_channels: int, out_channels: int,
                 use_motion: bool, add_downsample: bool, place_idx: int):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([
            _resnet(cfg, in_channels if i == 0 else out_channels, out_channels)
            for i in range(n)])
        self.attentions = nn.ModuleList([
            _transformer(cfg, out_channels, place_idx * n + i)
            for i in range(n)])
        self.motion_modules = (nn.ModuleList([
            _motion(cfg, out_channels) for _ in range(n)])
            if use_motion else None)
        self.downsamplers = (nn.ModuleList([
            Downsample3D(out_channels, out_channels)])
            if add_downsample else None)

    def forward(self, x, temb, text, adapter_residual=None,
                cfg_expand=False):
        """cfg_expand: x is the shared CFG half; the first attention block
        doubles it to [uncond; cond]."""
        skips = []
        n = len(self.resnets)
        for i in range(n):
            x = self._run(self.resnets[i], x, temb)
            x = self._run(self.attentions[i], x, text,
                          cfg_expand=cfg_expand and i == 0)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x)
            if i == n - 1 and adapter_residual is not None:
                x = x + adapter_residual
            skips.append(x)
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class DownBlock3D(_Block):
    def __init__(self, cfg: UNet3DConfig, in_channels: int, out_channels: int,
                 use_motion: bool, add_downsample: bool):
        super().__init__()
        n = cfg.layers_per_block
        self.resnets = nn.ModuleList([
            _resnet(cfg, in_channels if i == 0 else out_channels, out_channels)
            for i in range(n)])
        self.motion_modules = (nn.ModuleList([
            _motion(cfg, out_channels) for _ in range(n)])
            if use_motion else None)
        self.downsamplers = (nn.ModuleList([
            Downsample3D(out_channels, out_channels)])
            if add_downsample else None)

    def forward(self, x, temb, adapter_residual=None):
        skips = []
        for i, resnet in enumerate(self.resnets):
            x = self._run(resnet, x, temb)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x)
            skips.append(x)
        # the 4th adapter residual is added after the whole final down block
        if adapter_residual is not None:
            x = x + adapter_residual
            skips[-1] = x
        if self.downsamplers is not None:
            x = self.downsamplers[0](x)
            skips.append(x)
        return x, skips


class UNetMidBlock3DCrossAttn(_Block):
    def __init__(self, cfg: UNet3DConfig, use_motion: bool):
        super().__init__()
        ch = cfg.block_out_channels[-1]
        self.resnets = nn.ModuleList([_resnet(cfg, ch, ch),
                                      _resnet(cfg, ch, ch)])
        cross_idx = (len(cfg.block_out_channels) - 1) * cfg.layers_per_block
        self.attentions = nn.ModuleList([
            _transformer(cfg, ch, cross_idx)])
        self.motion_modules = (nn.ModuleList([_motion(cfg, ch)])
                               if use_motion else None)

    def forward(self, x, temb, text):
        x = self._run(self.resnets[0], x, temb)
        x = self._run(self.attentions[0], x, text)
        if self.motion_modules is not None:
            x = self.motion_modules[0](x)
        return self._run(self.resnets[1], x, temb)


class CrossAttnUpBlock3D(_Block):
    def __init__(self, cfg: UNet3DConfig, in_channels: int,
                 prev_output_channel: int, out_channels: int,
                 use_motion: bool, add_upsample: bool, place_idx: int):
        super().__init__()
        n = cfg.layers_per_block + 1
        n_down_cross = 3 * cfg.layers_per_block
        self.resnets = nn.ModuleList()
        for i in range(n):
            skip_ch = in_channels if i == n - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            self.resnets.append(_resnet(cfg, res_in + skip_ch, out_channels))
        self.attentions = nn.ModuleList([
            _transformer(cfg, out_channels,
                         n_down_cross + 1 + (place_idx - 1) * n + i)
            for i in range(n)])
        self.motion_modules = (nn.ModuleList([
            _motion(cfg, out_channels) for _ in range(n)])
            if use_motion else None)
        self.upsamplers = (nn.ModuleList([
            Upsample3D(out_channels, out_channels)])
            if add_upsample else None)

    def forward(self, x, skips, temb, text, upsample_size=None):
        for i in range(len(self.resnets)):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = self._run(self.resnets[i], x, temb)
            x = self._run(self.attentions[i], x, text)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x


class UpBlock3D(_Block):
    def __init__(self, cfg: UNet3DConfig, in_channels: int,
                 prev_output_channel: int, out_channels: int,
                 use_motion: bool, add_upsample: bool):
        super().__init__()
        n = cfg.layers_per_block + 1
        self.resnets = nn.ModuleList()
        for i in range(n):
            skip_ch = in_channels if i == n - 1 else out_channels
            res_in = prev_output_channel if i == 0 else out_channels
            self.resnets.append(_resnet(cfg, res_in + skip_ch, out_channels))
        self.motion_modules = (nn.ModuleList([
            _motion(cfg, out_channels) for _ in range(n)])
            if use_motion else None)
        self.upsamplers = (nn.ModuleList([
            Upsample3D(out_channels, out_channels)])
            if add_upsample else None)

    def forward(self, x, skips, temb, upsample_size=None):
        for i, resnet in enumerate(self.resnets):
            x = torch.cat([x, skips.pop()], dim=-1)
            x = self._run(resnet, x, temb)
            if self.motion_modules is not None:
                x = self.motion_modules[i](x)
        if self.upsamplers is not None:
            x = self.upsamplers[0](x, upsample_size)
        return x


@MODEL_REGISTRY.register()
class AnimateDiffUNet3DModel(nn.Module):
    """The video U-Net: sample (B, F, H, W, 4) -> eps (B, F, H, W, 4).

    Every spatial self- and cross-attention site runs flash attention; the
    motion modules' frame axis runs temporal attention (ops/attention.py).
    `gradient_checkpointing`: see `set_gradient_checkpointing`."""

    def __init__(self, cfg: UNet3DConfig = UNet3DConfig(),
                 gradient_checkpointing: bool | str = False):
        super().__init__()
        if cfg.motion_window is not None:
            raise NotImplementedError(
                'windowed motion modules are not ported yet (ROADMAP.md)')
        self.cfg = cfg
        chans = tuple(cfg.block_out_channels)
        temb_dim = chans[0] * 4
        self.time_embedding = TimestepEmbedding(chans[0], temb_dim)
        self.conv_in = InflatedConv(cfg.in_channels, chans[0])

        self.down_blocks = nn.ModuleList()
        out_ch = chans[0]
        for i, ch in enumerate(chans):
            in_ch, out_ch = out_ch, ch
            use_motion = (cfg.use_motion_module
                          and (2 ** i) in cfg.motion_module_resolutions)
            if i < len(chans) - 1:
                self.down_blocks.append(CrossAttnDownBlock3D(
                    cfg, in_ch, out_ch, use_motion, add_downsample=True,
                    place_idx=i))
            else:
                self.down_blocks.append(DownBlock3D(
                    cfg, in_ch, out_ch, use_motion, add_downsample=False))

        self.mid_block = UNetMidBlock3DCrossAttn(
            cfg, cfg.use_motion_module and cfg.motion_module_mid_block)

        self.up_blocks = nn.ModuleList()
        rev = list(reversed(chans))
        out_ch = rev[0]
        for i, ch in enumerate(rev):
            prev_ch, out_ch = out_ch, ch
            in_ch = rev[min(i + 1, len(rev) - 1)]
            resolution = 2 ** (len(rev) - 1 - i)
            use_motion = (cfg.use_motion_module
                          and resolution in cfg.motion_module_resolutions)
            add_upsample = i < len(rev) - 1
            if i == 0:
                self.up_blocks.append(UpBlock3D(
                    cfg, in_ch, prev_ch, out_ch, use_motion, add_upsample))
            else:
                self.up_blocks.append(CrossAttnUpBlock3D(
                    cfg, in_ch, prev_ch, out_ch, use_motion, add_upsample,
                    place_idx=i))

        self.conv_norm_out = GroupNorm(cfg.norm_num_groups, chans[0],
                                       eps=cfg.norm_eps)
        self.conv_out = InflatedConv(chans[0], cfg.out_channels)
        self.set_gradient_checkpointing(gradient_checkpointing)

    def set_gradient_checkpointing(self, mode: bool | str) -> None:
        """False: keep every activation for the backward. True: recompute
        the resnet and spatial-transformer layers of every block. 'edges':
        recompute them only in the full-resolution (level 0) blocks, whose
        activations are the largest, and keep everything deeper (the
        training default)."""
        if mode in ('save_flash', 'edges_sf'):
            raise NotImplementedError(
                f'gradient_checkpointing={mode!r} needs a selective '
                'checkpoint policy and is not ported yet (ROADMAP.md)')
        if mode not in (False, True, 'edges'):
            raise ValueError(f'unknown gradient_checkpointing: {mode!r}')
        top = len(self.down_blocks) - 1
        levels = ([(b, i) for i, b in enumerate(self.down_blocks)]
                  + [(self.mid_block, top)]
                  + [(b, top - i) for i, b in enumerate(self.up_blocks)])
        for block, level in levels:
            block.remat = level == 0 if mode == 'edges' else bool(mode)
        self.gradient_checkpointing = mode

    def forward(self, sample: torch.Tensor, timesteps,
                encoder_hidden_states: torch.Tensor,
                adapter_residuals: Optional[Sequence[torch.Tensor]] = None,
                cfg_prefix_dedup: bool = False) -> torch.Tensor:
        """cfg_prefix_dedup: `sample` is the single shared CFG half while
        `encoder_hidden_states` carries both halves; the batch doubles to
        [uncond; cond] at the first cross-attention, where text enters.
        Same result as passing [sample; sample], without the duplicate
        prefix compute."""
        cfg = self.cfg
        dtype = self.conv_in.weight.dtype
        if cfg_prefix_dedup and \
                encoder_hidden_states.shape[0] != 2 * sample.shape[0]:
            raise ValueError('cfg_prefix_dedup expects text with both CFG '
                             'halves and sample with one')

        timesteps = torch.as_tensor(timesteps, device=sample.device)
        timesteps = timesteps.reshape(-1).expand(sample.shape[0])
        t_feat = timestep_sinusoidal(timesteps, cfg.block_out_channels[0])
        temb = self.time_embedding(t_feat.to(dtype))

        text = encoder_hidden_states.to(dtype)
        x = self.conv_in(sample.to(dtype))
        res = (list(adapter_residuals) if adapter_residuals is not None
               else [None] * len(self.down_blocks))

        # with dedup the conv_in skip is consumed at full CFG batch; temb
        # (batch 1 under dedup) broadcasts over the doubled batch
        skips = [torch.cat([x, x]) if cfg_prefix_dedup else x]
        for i, block in enumerate(self.down_blocks):
            if isinstance(block, CrossAttnDownBlock3D):
                x, s = block(x, temb, text, res[i],
                             cfg_expand=cfg_prefix_dedup and i == 0)
            else:
                x, s = block(x, temb, res[i])
            skips.extend(s)

        x = self.mid_block(x, temb, text)

        for block in self.up_blocks:
            n_take = len(block.resnets)
            block_skips = skips[-n_take:]
            del skips[-n_take:]
            upsample_size = tuple(skips[-1].shape[2:4]) if skips else None
            if isinstance(block, UpBlock3D):
                x = block(x, block_skips, temb, upsample_size)
            else:
                x = block(x, block_skips, temb, text, upsample_size)

        x = F.silu(self.conv_norm_out(x))
        return self.conv_out(x)
