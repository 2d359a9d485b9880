"""Adapter training (the port of videoswap_tpu/pipelines/trainer.py).

One step: draw a posterior latent sample of the video (from cached VAE
moments, or by encoding the frames), a high-noise-biased timestep and the
noise, CLIP-encode the prompt, run the point adapter with random point
dropout and the frozen U-Net, take the masked MSE on the epsilon (or v)
target in fp32, and update the ADAPTER parameters only with AdamW (with
optional gradient clipping). The U-Net, VAE and text encoder are frozen;
activations still carry gradients through every U-Net layer after the first
adapter residual, so the flash-attention backward kernels, the GEGLU and
temporal-attention backward run at every such site. The U-Net recomputes
its level-0 layers in the backward pass by default (`tune_cfg['remat']`,
'edges').

The adapter's parameters, gradients and AdamW state are fp32 whatever the
models' dtype: the trainer casts the adapter it is given to fp32 in place,
as the JAX package keeps flax's fp32 `param_dtype` and sets only the
compute dtype. An AdamW update of lr 1e-5 is below half a bf16 step for
most adapter weights, so bf16 weights would not move. The adapter's
residuals are cast to the U-Net's dtype.

The step's random draws are made explicit: `make_draws(batch, generator)`
returns them, and `loss_fn(batch, draws)` is the loss for given draws, so
that a test can feed the JAX package's draws (its `jax.random.split(rng, 4)`
in `build_loss_fn`) and compare loss and adapter gradient.

Sharded (`shard_trainer(trainer, mesh)`, the JAX package's `shard_params` +
`shard_batch` under a (dp, sp, tp) mesh): every rank takes the whole batch
and the whole draws (the same seed on every rank) and keeps its part,
`parallel.sharding.shard_batch`'s (B over dp, F over sp where they divide);
the VAE sample, the adapter and the U-Net run on that part (the U-Net with
its tp shards, `forward_local`); the masked MSE's numerator and mask count
are summed over the ranks whose parts differ; the adapter's gradient is
summed over the same ranks and never over replicated copies (tp ranks, or
the rows of a batch of 1 on dp ranks), so that every rank ends a step with
the same bits of adapter weights and AdamW state.
"""

from __future__ import annotations

import copy
import dataclasses
import math
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

import torch

from videoswap_torch.models import AnimateDiffUNet3DModel, SparsePointAdapter
from videoswap_torch.models.clip_text import CLIPTextModel
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.parallel import sharding
from videoswap_torch.schedulers import (DiffusionSchedule, add_noise,
                                        get_velocity)
from videoswap_torch.utils.registry import PIPELINE_REGISTRY


def sample_biased_timestep(generator: torch.Generator, min_timestep: float,
                           num_train_timesteps: int,
                           largeT_prob: float = 1.0) -> torch.Tensor:
    """t = int(u * T), u ~ U(min_t, 1) with probability largeT_prob, else
    U(0, min_t). A 0-dim int64 tensor on the generator's device."""
    u = torch.rand(3, generator=generator, device=generator.device)
    u_hi = min_timestep + (1.0 - min_timestep) * u[0]
    u_lo = min_timestep * u[1]
    t = torch.where(u[2] <= largeT_prob, u_hi, u_lo) * num_train_timesteps
    return t.to(torch.int64)


@PIPELINE_REGISTRY.register()
@dataclass
class VideoSwapTrainer:
    unet: AnimateDiffUNet3DModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    sched: DiffusionSchedule
    adapter: SparsePointAdapter
    tune_cfg: dict = field(default_factory=dict)
    optimizer_cfg: dict = field(default_factory=dict)
    max_grad_norm: Optional[float] = None
    mesh: Any = None                  # set by shard_trainer

    def __post_init__(self):
        if self.tune_cfg.get('attn_impl', 'flash') != 'flash':
            raise NotImplementedError(
                'the port runs every spatial attention site through flash '
                "attention; attn_impl must be 'flash'")
        for m in (self.unet, self.vae, self.text_encoder):
            m.requires_grad_(False)
        self.adapter.float().requires_grad_(True)
        self.unet.set_gradient_checkpointing(
            self.tune_cfg.get('remat', 'edges'))
        self.optimizer = self.init_state()

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def init_state(self) -> torch.optim.AdamW:
        """A fresh AdamW over the adapter's parameters (optax.adamw's
        defaults: eps 1e-8, decoupled weight decay)."""
        cfg = self.optimizer_cfg
        return torch.optim.AdamW(
            self.adapter.parameters(), lr=float(cfg.get('lr', 5e-4)),
            betas=tuple(cfg.get('betas', (0.9, 0.999))), eps=1e-8,
            weight_decay=float(cfg.get('weight_decay', 0.01)))

    # ------------------------------------------------------------------ step
    def _latent_shape(self, batch) -> tuple[int, ...]:
        if 'latent_mean' in batch:
            return tuple(batch['latent_mean'].shape)
        b, f, h, w = batch['pixels'].shape[:4]
        return (b, f, h // 8, w // 8, self.vae.post_quant_conv.in_channels)

    def make_draws(self, batch, generator: torch.Generator) -> dict:
        """The step's random numbers, in the JAX package's order: the VAE
        posterior's eps, the timestep, the noise, the point-keep mask."""
        shape = self._latent_shape(batch)
        dev = generator.device
        drop_rate = float(self.tune_cfg.get('drop_rate', 0.0))
        return {
            'vae_eps': torch.randn(shape, generator=generator, device=dev),
            't': sample_biased_timestep(
                generator, float(self.tune_cfg.get('min_timestep', 0.0)),
                self.sched.num_train_timesteps),
            'noise': torch.randn(shape, generator=generator, device=dev),
            'keep': torch.rand(batch['pred_tracks'].shape[1],
                               generator=generator, device=dev) > drop_rate,
        }

    def loss_fn(self, batch, draws: dict) -> torch.Tensor:
        """Masked MSE (fp32 scalar) for one batch and given draws. batch:
        'input_ids' (B, 77), 'pred_tracks' (F, P, 2), 'point_embedding'
        (P, E), and either 'latent_mean'/'latent_logvar' (B, F, h, w, 4)
        cached moments or 'pixels' (B, F, H, W, 3) in [-1, 1]. Sharded, the
        whole batch and draws: each rank runs its part."""
        dev = self.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        draws = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}
        lay = None
        if self.mesh is not None:
            b, f = self._latent_shape(batch)[:2]
            lay = sharding.batch_layout(b, f, self.mesh)
            batch = sharding.shard_batch(batch, self.mesh)
            draws = {k: lay.take(v) if k in ('vae_eps', 'noise') else v
                     for k, v in draws.items()}
        with torch.no_grad():
            if 'latent_mean' in batch:
                mean, logvar = batch['latent_mean'], batch['latent_logvar']
            else:
                mean, logvar = self.vae.encode_video_moments(batch['pixels'])
            latents = self.vae.sample_video_from_moments(
                mean, logvar, eps=draws['vae_eps'])
            noise = draws['noise'].to(latents.dtype)
            noisy = add_noise(self.sched, latents, noise, draws['t'])
            text = self.text_encoder(batch['input_ids'])
        size = (mean.shape[3] * 8, mean.shape[2] * 8)           # (W, H)
        loss_type = self.tune_cfg.get('loss_type', 'global')
        states, mask = self.adapter(
            batch['pred_tracks'].float(), size, batch['point_embedding'],
            point_mask=draws['keep'], loss_type=loss_type)
        if lay is not None and loss_type == 'local' and lay.frame_sharded:
            # the union over every frame's points: over the sp ranks' too
            mask = sharding.all_reduce_max(mask, self.mesh.group('sp'))
        dtype = self.unet.conv_in.weight.dtype
        residuals = [s[None].to(dtype) for s in states]
        if lay is None:
            pred = self.unet(noisy, draws['t'], text,
                             adapter_residuals=residuals)
        else:
            pred = self.unet.forward_local(noisy, draws['t'], text,
                                           residuals, lay)
        if self.sched.prediction_type == 'epsilon':
            target = noise
        else:
            target = get_velocity(self.sched, latents, noise, draws['t'])
        se = (pred.float() - target.float()) ** 2
        m = mask[None].expand(se.shape)
        if lay is None:
            return (se * m).sum() / m.sum()
        axes = sharding.distinct_axes(lay)
        return (sharding.sum_distinct((se * m).sum(), self.mesh, axes)
                / sharding.sum_distinct(m.sum(), self.mesh, axes))

    def step(self, batch, generator: torch.Generator) -> torch.Tensor:
        """One AdamW update of the adapter; returns the loss (detached)."""
        draws = self.make_draws(batch, generator)
        self.optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(batch, draws)
        loss.backward()
        self.reduce_gradients(batch)
        if self.max_grad_norm:
            torch.nn.utils.clip_grad_norm_(self.adapter.parameters(),
                                           self.max_grad_norm)
        self.optimizer.step()
        return loss.detach()

    def reduce_gradients(self, batch) -> None:
        """Sharded: the adapter's gradient summed over the ranks whose parts
        of the batch differ (`distinct_axes`), the same bits on every
        rank."""
        if self.mesh is None:
            return
        b, f = self._latent_shape(batch)[:2]
        lay = sharding.batch_layout(b, f, self.mesh)
        sharding.reduce_gradients(self.adapter.parameters(), self.mesh,
                                  sharding.distinct_axes(lay))

    # ------------------------------------------------------------- lr sched
    @staticmethod
    def build_lr_schedule(kind: str, lr: float, total_iter: int,
                          warmup_iter: int = 0) -> Callable[[int], float]:
        """iteration -> learning rate, as the JAX package's optax
        schedules ('constant' with optional linear warmup from 0, 'linear'
        decay to 0, 'cosine' decay to 0)."""
        def ramp(step, n):
            return min(max(step / n, 0.0), 1.0)
        if kind == 'constant':
            if warmup_iter:
                return lambda step: lr * ramp(step, warmup_iter)
            return lambda _: lr
        if kind == 'linear':
            return lambda step: lr * (1.0 - ramp(step, total_iter))
        if kind == 'cosine':
            return lambda step: lr * 0.5 * (
                1.0 + math.cos(math.pi * ramp(step, total_iter)))
        raise ValueError(f'unknown lr_scheduler: {kind}')


def shard_trainer(trainer: VideoSwapTrainer, mesh) -> VideoSwapTrainer:
    """Sharded adapter training over `mesh` (the analogue of
    `parallel.shard_pipeline`, and of the JAX package's trainer under
    `shard_params` + `shard_batch`): a new trainer whose U-Net (a copy)
    holds this rank's tp shards and runs this rank's part of each batch.
    The VAE, the text encoder, the adapter and its AdamW are shared with
    `trainer`; the adapter's weights and AdamW state are broadcast from the
    mesh's first rank, so every rank starts from the same state."""
    if not mesh.member:
        raise ValueError(f'this rank is not in the mesh {mesh.describe()}')
    unet = copy.deepcopy(trainer.unet)
    unet.tp_slicers = sharding.shard_unet(unet, mesh)
    unet.mesh = mesh
    out = dataclasses.replace(trainer, unet=unet, mesh=mesh)
    out.optimizer = trainer.optimizer
    sharding.replicate_tree(sharding.optimizer_tensors(out.optimizer), mesh)
    return out
