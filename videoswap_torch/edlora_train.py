"""ED-LoRA (Mix-of-Show) subject finetuning (the port of
videoswap_tpu/edlora_train.py).

The swap consumes ED-LoRA checkpoints (edlora.py); this module trains
them: per-layer concept embeddings ([16, D] a concept, the textual-
inversion half) and rank-r LoRA factors on the U-Net's and the text
encoder's projections. The checkpoint it writes is the schema
`edlora.load_edlora_into_pipeline` reads: `{new_concept_embedding: {name:
[16, D]}, unet: {<key>.lora_down.weight / .lora_up.weight}, text_encoder:
{...}}`.

LoRA is functional, not a patch of the modules' forwards: `merge_lora`
computes `W + alpha * up @ down` for every site (cast to W's dtype, as
the JAX package casts the update), and the frozen models run on the
merged weights through `torch.func.functional_call`; the frozen weights
are never changed in place, and autograd differentiates the factors and
the embeddings only. A site is named by its canonical torch key (the
U-Net's own parameter name; the text encoder's through
`converters.clip_key_map`), the key a checkpoint carries.

One training step (`EDLoRATrainer.step`): the text encoder on merged
weights with the concept rows as `extra_token_embeds` ([16, 77, D], one
row a layer variant), a posterior latent sample from cached VAE moments
(or from pixels), a high-noise-biased timestep and the noise, the U-Net
on merged weights, the epsilon (or v) target and a plain or masked MSE
in fp32; then two AdamW groups, optax's: the embeddings at `emb_lr`
without weight decay and the factors at `lora_lr` with `weight_decay`,
each group's gradient clipped by its own global norm (`max_grad_norm`),
as the JAX package chains `clip_by_global_norm` inside each group. The
U-Net runs without recomputation in the backward (`tune_cfg['remat']`,
off by default): at batch 1 the activations fit.

The step's random draws are explicit, as in pipelines/trainer.py:
`make_draws` returns them and `loss_fn` takes them, so that a test can
feed the JAX package's draws.

Tensor parallel (`shard_edlora_trainer(trainer, mesh)`, the mesh (1, 1,
N)): the frozen U-Net and text encoder hold this rank's tp shards
(`parallel.sharding.shard_unet`, `shard_text_encoder`); the factors and
the concept embeddings stay replicated, and each site's `up @ down` is cut
with its weight's slicer before the sum. A cut site's factor gradient
covers only its rank's rows or columns and is summed over tp; every other
gradient is whole on each rank already (the column-parallel entries sum
the embeddings' over tp) and is not summed again. Each group is clipped by
the global norm of the reduced gradients, so every rank ends a step with
the same bits.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Any, NamedTuple, Optional, Sequence

import copy
import dataclasses

import numpy as np
import torch
from torch.func import functional_call

from videoswap_torch.edlora import (_TEXT_LORA, _UNET_LORA, NUM_EDLORA_LAYERS,
                                    _eligible, bind_concept_prompt)
from videoswap_torch.models.converters import clip_key_map
from videoswap_torch.parallel import sharding
from videoswap_torch.pipelines.trainer import sample_biased_timestep
from videoswap_torch.schedulers import add_noise, get_velocity

# module names a scope trains: 'attn' the attention projections (the
# reference LoRALinearLayer's natural target), 'full' every layer the merge
# path supports
_SCOPES = {
    'attn': {'unet': ('to_q', 'to_k', 'to_v', 'to_out.0'),
             'text_encoder': ('q_proj', 'k_proj', 'v_proj', 'out_proj')},
    'full': {'unet': _UNET_LORA, 'text_encoder': _TEXT_LORA},
}


class LoRASite(NamedTuple):
    name: str            # the module's parameter name
    torch_key: str       # the checkpoint's key (`...weight`)
    is_conv: bool        # a 1x1 conv (proj_in / proj_out), not a Linear


def lora_sites(module: torch.nn.Module, model_type: str,
               scope: str = 'attn') -> tuple:
    """The LoRA-eligible weights of a frozen model, sorted by key. The
    motion modules' attention is never a site: ED-LoRA checkpoints come
    from 2D SD training."""
    eligible = _SCOPES[scope][model_type]
    key_map = clip_key_map if model_type == 'text_encoder' else None
    sites = []
    for name, p in module.named_parameters():
        if not _eligible(name, eligible) or 'motion_modules' in name:
            continue
        sites.append(LoRASite(name, key_map(name) if key_map else name,
                              p.dim() == 4))
    return tuple(sorted(sites, key=lambda s: s.torch_key))


def init_lora_params(generator: torch.Generator, module: torch.nn.Module,
                     sites: Sequence[LoRASite], rank: int = 4) -> dict:
    """{torch_key: {'down': [r, I], 'up': [O, r]}} fp32 on the
    generator's device: down ~ U(-1/sqrt(I), 1/sqrt(I)) (kaiming-uniform
    with a = sqrt(5), the reference's), up zeros, so the merged model
    starts exactly at the base."""
    params = dict(module.named_parameters())
    dev = generator.device
    out = {}
    for site in sites:
        out_f, in_f = params[site.name].shape[:2]
        bound = 1.0 / math.sqrt(in_f)
        down = torch.rand((rank, in_f), generator=generator, device=dev)
        out[site.torch_key] = {
            'down': (down * 2.0 - 1.0) * bound,
            'up': torch.zeros((out_f, rank), device=dev)}
    return out


def merge_lora(frozen: dict, lora_params: dict, sites: Sequence[LoRASite],
               alpha: float, slicers: Optional[dict] = None) -> dict:
    """{parameter name: W + alpha * up @ down} over the sites, the update
    cast to W's dtype before the sum (differentiable in the factors).
    `slicers` {parameter name: full -> local} cut the update of a
    tensor-parallel model's weight to this rank's shard."""
    out = {}
    for site in sites:
        w = frozen[site.name]
        p = lora_params[site.torch_key]
        delta = (p['up'] @ p['down']).to(w.dtype)            # [O, I]
        if slicers and site.name in slicers:
            delta = slicers[site.name](delta)
        out[site.name] = w + alpha * delta.reshape(w.shape)
    return out


def factor_axes(site: LoRASite, slicers: dict) -> tuple:
    """The mesh axes a site's factor gradient is summed over: tp where its
    weight is cut (each rank's update covers its own rows or columns),
    none where the weight is whole on every rank."""
    return ('tp',) if site.name in slicers else ()


# ---------------------------------------------------------------------------
# concept tokens
# ---------------------------------------------------------------------------


def register_concepts(tokenizer, concept_names: Sequence[str]) -> dict:
    """Add `<name_i>` x16 tokens a concept; returns the new_concept_cfg
    that edlora.load_new_concept builds."""
    cfg = {}
    for name in concept_names:
        token_names = [f'<{name}_{i}>' for i in range(NUM_EDLORA_LAYERS)]
        tokenizer.add_tokens(token_names)
        cfg[name] = {
            'concept_token_ids': [tokenizer.convert_tokens_to_ids(t)
                                  for t in token_names],
            'concept_token_names': token_names,
        }
    return cfg


@torch.no_grad()
def init_concept_embedding(text_encoder, tokenizer,
                           init_token: str) -> torch.Tensor:
    """[16, D] fp32: the mean of the init token's embedding rows (every id
    of its max_length-padded encoding that is not BOS or EOS, so the EOS
    padding drops out), tiled over the 16 layers. Ids past the table read
    its last row, as the JAX package's gather does."""
    table = text_encoder.token_embedding.weight
    ids = np.asarray(tokenizer(init_token, padding='max_length').input_ids)[0]
    bos = getattr(tokenizer, 'bos_token_id', None)
    eos = getattr(tokenizer, 'eos_token_id', None)
    content = [min(int(i), table.shape[0] - 1) for i in ids
               if i not in (bos, eos)]
    if not content:
        raise ValueError(f'init_token {init_token!r} tokenized to nothing')
    row = table[torch.as_tensor(content, device=table.device)].float().mean(0)
    return row[None].repeat(NUM_EDLORA_LAYERS, 1)


def tokenize_layer_prompts(tokenizer, caption: str,
                           new_concept_cfg: dict) -> np.ndarray:
    """A caption -> [16, 77] int32 ids, one row a layer variant."""
    prompts = bind_concept_prompt(caption, new_concept_cfg)
    return np.asarray(tokenizer(
        prompts, padding='max_length',
        max_length=tokenizer.model_max_length,
        truncation=True).input_ids, np.int32)


# ---------------------------------------------------------------------------
# the checkpoint (the schema edlora.py and the reference consume)
# ---------------------------------------------------------------------------


def save_edlora_checkpoint(path: str, train_params: dict,
                           unet_sites: Sequence[LoRASite],
                           text_sites: Sequence[LoRASite]) -> None:
    """torch.save the reference ED-LoRA schema, fp32. Conv sites are
    written [r, I, 1, 1] / [O, r, 1, 1], as torch Conv2d LoRA factors are
    shaped (both consumers flatten them before the product)."""
    from videoswap_torch.builders import _save_atomic

    def pack(lora_params, sites):
        sd = {}
        for site in sites:
            p = lora_params[site.torch_key]
            down, up = (p[k].detach().to('cpu', torch.float32)
                        for k in ('down', 'up'))
            if site.is_conv:
                down, up = down[:, :, None, None], up[:, :, None, None]
            base = site.torch_key[:-len('.weight')]
            sd[f'{base}.lora_down.weight'] = down.contiguous()
            sd[f'{base}.lora_up.weight'] = up.contiguous()
        return sd

    _save_atomic({
        'new_concept_embedding': {
            name: emb.detach().to('cpu', torch.float32)
            for name, emb in train_params['concept_emb'].items()},
        'unet': pack(train_params['unet_lora'], unet_sites),
        'text_encoder': pack(train_params['text_lora'], text_sites),
    }, path)


# ---------------------------------------------------------------------------
# trainer
# ---------------------------------------------------------------------------


def clip_by_global_norm_(grads: Sequence[torch.Tensor],
                         max_norm: float) -> None:
    """optax.clip_by_global_norm in place: every gradient scaled by
    max_norm / norm where the global norm reaches max_norm."""
    norm = torch.linalg.vector_norm(torch.stack(
        [torch.linalg.vector_norm(g.float()) for g in grads]))
    clip = norm >= max_norm
    for g in grads:
        g.copy_(torch.where(clip, g / norm * max_norm, g))


@dataclass
class EDLoRATrainer:
    """Concept embeddings and LoRA factors trained on frozen models.

    A batch: `input_ids` [16, 77] (a caption's 16 layer variants) and
    either cached posterior moments `latent_mean`/`latent_logvar` [1, F,
    h, w, 4] or `pixels` [1, F, H, W, 3] in [-1, 1], optionally a `mask`
    [1, F, h, w, 1]. F = 1 for image finetuning, on a U-Net built without
    motion modules (2D SD, what ED-LoRA checkpoints mean)."""
    unet: Any
    text_encoder: Any
    vae: Any
    sched: Any
    unet_sites: tuple
    text_sites: tuple
    alpha: float = 1.0
    tune_cfg: dict = field(default_factory=dict)
    optimizer_cfg: dict = field(default_factory=dict)
    max_grad_norm: Optional[float] = None
    mesh: Any = None                  # set by shard_edlora_trainer

    def __post_init__(self):
        if self.tune_cfg.get('attn_impl', 'flash') != 'flash':
            raise NotImplementedError(
                'the port runs every spatial attention site through flash '
                "attention; attn_impl must be 'flash'")
        for m in (self.unet, self.vae, self.text_encoder):
            m.requires_grad_(False)
        self.unet.set_gradient_checkpointing(self.tune_cfg.get('remat',
                                                               False))
        self.slicers = {
            'unet': getattr(self.unet, 'tp_slicers', None) or {},
            'text_encoder': getattr(self.text_encoder, 'tp_slicers',
                                    None) or {}}
        self.frozen = {
            'unet': {s.name: self.unet.get_parameter(s.name)
                     for s in self.unet_sites},
            'text_encoder': {s.name: self.text_encoder.get_parameter(s.name)
                             for s in self.text_sites}}

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def init_train_params(self, generator: torch.Generator,
                          concept_emb: dict, rank: int = 4) -> dict:
        """{'concept_emb': {name: [16, D]}, 'unet_lora', 'text_lora'}, fp32
        leaves that require grad; the U-Net's factors are drawn first."""
        out = {
            'concept_emb': {k: torch.as_tensor(v, dtype=torch.float32).to(
                self.device, copy=True) for k, v in concept_emb.items()},
            'unet_lora': init_lora_params(generator, self.unet,
                                          self.unet_sites, rank),
            'text_lora': init_lora_params(generator, self.text_encoder,
                                          self.text_sites, rank),
        }
        groups = param_groups(out)
        for t in groups['emb'] + groups['lora']:
            t.requires_grad_(True)
        return out

    def init_state(self, train_params: dict) -> torch.optim.AdamW:
        """AdamW over the two groups (optax.adamw's eps 1e-8 and decoupled
        decay): 'emb' at emb_lr without decay, 'lora' at lora_lr with
        weight_decay."""
        oc = self.optimizer_cfg
        groups = param_groups(train_params)
        return torch.optim.AdamW(
            [{'params': groups['emb'], 'name': 'emb',
              'lr': float(oc.get('emb_lr', 1e-3)), 'weight_decay': 0.0},
             {'params': groups['lora'], 'name': 'lora',
              'lr': float(oc.get('lora_lr', 1e-4)),
              'weight_decay': float(oc.get('weight_decay', 0.01))}],
            betas=tuple(oc.get('betas', (0.9, 0.999))), eps=1e-8)

    # ------------------------------------------------------------------ loss
    def make_draws(self, batch, generator: torch.Generator) -> dict:
        """The step's random numbers, in the JAX package's order: the VAE
        posterior's eps, the timestep, the noise."""
        if 'latent_mean' in batch:
            shape = tuple(batch['latent_mean'].shape)
        else:
            b, f, h, w = batch['pixels'].shape[:4]
            shape = (b, f, h // 8, w // 8,
                     self.vae.post_quant_conv.in_channels)
        dev = generator.device
        return {
            'vae_eps': torch.randn(shape, generator=generator, device=dev),
            't': sample_biased_timestep(
                generator, float(self.tune_cfg.get('min_timestep', 0.0)),
                self.sched.num_train_timesteps),
            'noise': torch.randn(shape, generator=generator, device=dev),
        }

    def loss_fn(self, train_params: dict, batch, draws: dict) -> torch.Tensor:
        """The fp32 loss of one batch for given draws."""
        dev = self.device
        batch = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        draws = {k: torch.as_tensor(v, device=dev) for k, v in draws.items()}
        text_eff = merge_lora(self.frozen['text_encoder'],
                              train_params['text_lora'], self.text_sites,
                              self.alpha, self.slicers['text_encoder'])
        # the extra rows in registration order (the dict's order)
        extra = torch.cat(list(train_params['concept_emb'].values()))
        text = functional_call(self.text_encoder, text_eff,
                               (batch['input_ids'],),
                               {'extra_token_embeds': extra},
                               strict=False)[None]           # [1, 16, 77, D]
        with torch.no_grad():
            if 'latent_mean' in batch:
                mean, logvar = batch['latent_mean'], batch['latent_logvar']
            else:
                mean, logvar = self.vae.encode_video_moments(batch['pixels'])
            latents = self.vae.sample_video_from_moments(
                mean, logvar, eps=draws['vae_eps'])
            noise = draws['noise'].to(latents.dtype)
            noisy = add_noise(self.sched, latents, noise, draws['t'])
        dtype = self.unet.conv_in.weight.dtype
        unet_eff = merge_lora(self.frozen['unet'], train_params['unet_lora'],
                              self.unet_sites, self.alpha,
                              self.slicers['unet'])
        pred = functional_call(self.unet, unet_eff,
                               (noisy.to(dtype), draws['t'], text),
                               strict=False)
        if self.sched.prediction_type == 'epsilon':
            target = noise
        else:
            target = get_velocity(self.sched, latents, noise, draws['t'])
        se = (pred.float() - target.float()) ** 2
        if 'mask' in batch:
            m = batch['mask'].float().expand(se.shape)
            return (se * m).sum() / m.sum().clamp_min(1.0)
        return se.mean()

    # ---------------------------------------------------------------- update
    def update(self, optimizer: torch.optim.Optimizer) -> None:
        """Clip each group's gradients by the group's own global norm
        (when max_grad_norm is set), then one AdamW step."""
        if self.max_grad_norm:
            for group in optimizer.param_groups:
                grads = [p.grad for p in group['params']
                         if p.grad is not None]
                if grads:
                    clip_by_global_norm_(grads, float(self.max_grad_norm))
        optimizer.step()

    def step(self, train_params: dict, optimizer: torch.optim.Optimizer,
             batch, generator: torch.Generator) -> torch.Tensor:
        """One update of the embeddings and factors; returns the loss
        (detached)."""
        draws = self.make_draws(batch, generator)
        optimizer.zero_grad(set_to_none=True)
        loss = self.loss_fn(train_params, batch, draws)
        loss.backward()
        self.reduce_gradients(train_params)
        self.update(optimizer)
        return loss.detach()

    def reduce_gradients(self, train_params: dict) -> None:
        """Tensor parallel: each cut site's factor gradients summed over tp
        (`factor_axes`); the rest, whole on every rank, taken from the
        mesh's first rank, so that every rank holds the same bits."""
        if self.mesh is None:
            return
        by_axes = {}
        for part, model, sites in (('unet_lora', 'unet', self.unet_sites),
                                   ('text_lora', 'text_encoder',
                                    self.text_sites)):
            for site in sites:
                p = train_params[part][site.torch_key]
                by_axes.setdefault(factor_axes(
                    site, self.slicers[model]), []).extend(
                        (p['down'], p['up']))
        by_axes.setdefault((), []).extend(
            train_params['concept_emb'].values())
        for axes, params in sorted(by_axes.items()):
            sharding.reduce_gradients(params, self.mesh, axes)


def shard_edlora_trainer(trainer: EDLoRATrainer, mesh) -> EDLoRATrainer:
    """Tensor-parallel ED-LoRA training over `mesh` (the JAX package's
    `shard_edlora_trainer`): a new trainer on copies of the frozen U-Net
    and text encoder cut to this rank's tp shards; the VAE is shared.
    Broadcast the train params from the mesh's first rank
    (`parallel.replicate_tree`) before the first step."""
    if not mesh.member:
        raise ValueError(f'this rank is not in the mesh {mesh.describe()}')
    unet = copy.deepcopy(trainer.unet)
    unet.tp_slicers = sharding.shard_unet(unet, mesh)
    unet.mesh = mesh
    text_encoder = copy.deepcopy(trainer.text_encoder)
    text_encoder.tp_slicers = sharding.shard_text_encoder(text_encoder,
                                                          mesh)
    return dataclasses.replace(trainer, unet=unet,
                               text_encoder=text_encoder, mesh=mesh)


def param_groups(train_params: dict) -> dict:
    """{'emb': the concept embeddings, 'lora': the U-Net's factors then
    the text encoder's}, the tensors themselves, in a fixed order."""
    return {
        'emb': list(train_params['concept_emb'].values()),
        'lora': [p[k] for part in ('unet_lora', 'text_lora')
                 for p in train_params[part].values()
                 for k in ('down', 'up')]}
