"""Prompt-to-prompt editing: an edit bundle built once per swap and the
functions each sampling step applies (the port of videoswap_tpu/p2p/edit.py).

- `make_edit_bundle` computes every per-swap tensor on the host: the
  refinement or replacement token mapper (seq_aligner), the per-step
  cross-replacement word gate (ptp_utils.get_time_words_attention_alpha),
  the blenders' word selections, and the per-step inversion stores
  (latents and attention maps) in reverse order, so that edit step i reads
  index i (the reference's `len(store) - cur_step - 1`).
- `make_edit_fn` gives the per-site probability rewrite the U-Net runs
  (cross refine/replace with its step gate, masked self replacement).
- `latent_blend_step` applies the spatial blender's latent mask after each
  step, comparing the inversion's maps with the running sum of the edit's.

The JAX package's `lax.cond` on the step's self-replacement gate is a
Python condition here, and its scan inputs are indexed per step.

In a sharded U-Net call an edit function sees this rank's rows and frames
(and tp heads) of the probabilities: it edits the cond rows it holds, with
the stores' (every frame, this rank's heads) maps cut to its frames. The
source and target rows that an edit mixes are the stored inversion maps
and the cond row, so every edit is local to a rank.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from videoswap_torch.parallel import sharding

from . import blend, ptp_utils, seq_aligner, sites
from .ctrl import AttnCtrl, SiteKey


@dataclass(frozen=True)
class EditConfig:
    num_steps: int
    video_length: int
    h8: int
    w8: int
    height: int
    width: int
    do_cfg: bool
    refine: bool
    cross_active: bool
    self_range: tuple[int, int]
    blend_latents: bool
    blend_self: bool
    th: float
    start_blend: int
    end_blend: int
    blend_site_names: tuple[str, ...]
    cross_site_names: tuple[str, ...]
    self_site_names: tuple[str, ...]
    self_site_hw: tuple[tuple[str, tuple[int, int]], ...]
    # recompute the base self maps from the stored pre-step inversion
    # latents instead of storing them (one extra U-Net pass per edit step):
    # 50-step self stores at 512^2 would take ~4 GB of device memory
    recompute_self: bool = False


@dataclass
class EditBundle:
    cfg: EditConfig
    static_state: dict          # mapper/alphas/alpha_words/alpha_layers
    xs: dict                    # per-step inversion tensors, edit order
    init_sums: dict             # running-sum init for the blend sites


def self_store_bytes(num_steps: int, video_length: int, h8: int, w8: int,
                     heads: int = 8, itemsize: int = 2) -> int:
    """Projected device bytes of storing every self site over all steps."""
    return sum(num_steps * video_length * heads
               * sites.site_tokens(s, h8, w8) ** 2 * itemsize
               for s in sites.controlled_sites('self', h8, w8))


SELF_STORE_BUDGET = 1 << 30     # 1 GiB: above this, recompute instead


def want_recompute_self(editing_config: dict, height: int, width: int,
                        video_length: int, num_steps: int) -> bool:
    needs_self = any((s.get('blend_cfg') or {}).get('self_replace_steps')
                     for s in editing_config.get('editing_prompts',
                                                 {}).values())
    if not needs_self:
        return False
    mode = editing_config.get('recompute_self_stores', 'auto')
    if mode in (True, False):
        return bool(mode)
    return self_store_bytes(num_steps, video_length, height // 8,
                            width // 8) > SELF_STORE_BUDGET


def _reversed(t: torch.Tensor) -> torch.Tensor:
    return torch.flip(t, dims=(0,))


def make_edit_bundle(tokenizer,
                     source_prompt: str,
                     target_prompt: str,
                     num_steps: int,
                     video_length: int,
                     height: int,
                     width: int,
                     inv_latents_per_step: torch.Tensor,
                     inv_attn_store: dict,
                     blend_words=None,
                     blend_cfg: Optional[dict] = None,
                     do_cfg: bool = True,
                     is_replace: bool = False,
                     recompute_self: bool = False,
                     inv_z0=None,
                     inv_ts=None) -> EditBundle:
    """inv_latents_per_step: (N, B, F, h, w, 4) post-step inversion
    latents; inv_attn_store: {site name: (N, F, heads, S, T)}."""
    blend_cfg = blend_cfg or {}
    h8, w8 = height // 8, width // 8
    prompts = [source_prompt, target_prompt]
    dev = inv_latents_per_step.device

    cross_replace = blend_cfg.get('cross_replace_steps', 0.0)
    self_replace = blend_cfg.get('self_replace_steps', 0.0)
    th = float(blend_cfg.get('blend_th', 0.3))

    b_sites = sites.blend_sites(h8, w8)
    hws = {sites.site_hw(s, h8, w8) for s in b_sites}
    if len(hws) != 1:
        raise ValueError(f'blend sites span map resolutions {hws} at latent '
                         f'{h8}x{w8}; use an image size >= 256')
    cross_s = sites.controlled_sites('cross', h8, w8)
    self_s = sites.controlled_sites('self', h8, w8)

    if isinstance(self_replace, (float, int)):
        self_range = (0, int(num_steps * float(self_replace)))
    else:
        self_range = (int(num_steps * self_replace[0]),
                      int(num_steps * self_replace[1]))
    alpha_time = ptp_utils.get_time_words_attention_alpha(
        prompts, num_steps, cross_replace, tokenizer)
    cross_active = bool(np.max(alpha_time) > 0)
    self_active = self_range[1] > self_range[0]

    cfg = EditConfig(
        num_steps=num_steps, video_length=video_length, h8=h8, w8=w8,
        height=height, width=width, do_cfg=do_cfg, refine=not is_replace,
        cross_active=cross_active, self_range=self_range,
        blend_latents=blend_words is not None,
        blend_self=blend_words is not None and self_active,
        recompute_self=bool(recompute_self and self_active),
        th=th, start_blend=int(0.2 * num_steps),
        end_blend=int(0.8 * num_steps),
        blend_site_names=tuple(s.name for s in b_sites),
        cross_site_names=tuple(s.name for s in cross_s),
        self_site_names=tuple(s.name for s in self_s),
        self_site_hw=tuple((s.name, sites.site_hw(s, h8, w8))
                           for s in self_s),
    )

    t = (lambda a, dtype=None: torch.as_tensor(np.asarray(a), device=dev,
                                               dtype=dtype))
    static_state: dict[str, Any] = {}
    if is_replace:
        static_state['mapper_mat'] = t(seq_aligner.get_replacement_mapper(
            prompts, tokenizer)[0], torch.float32)
    else:
        mapper, alphas = seq_aligner.get_refinement_mapper(prompts,
                                                           tokenizer)
        static_state['mapper'] = t(mapper[0], torch.long)
        static_state['alphas'] = t(alphas[0], torch.float32)
    static_state['alpha_words'] = t(alpha_time[:, 0, 0, 0, :],
                                    torch.float32)

    if blend_words is not None:
        alpha_layers = np.zeros((2, 77), np.float32)
        for i, (prompt, words) in enumerate(zip(prompts, blend_words)):
            words = [words] if isinstance(words, str) else words
            for word in words:
                ind = ptp_utils.get_word_inds(prompt, word, tokenizer)
                alpha_layers[i, ind] = 1.0
        static_state['alpha_layers'] = t(alpha_layers)

    xs: dict[str, Any] = {}
    if cfg.blend_latents:
        xs['inv_latents'] = _reversed(inv_latents_per_step)
    needed = set(cfg.blend_site_names if (cfg.blend_latents or cfg.blend_self)
                 else ())
    if cfg.cross_active:
        needed |= set(cfg.cross_site_names)
    missing = needed - set(inv_attn_store)
    if missing:
        raise ValueError(f'inversion store is missing sites: {missing}')
    xs['base_cross'] = {n: _reversed(inv_attn_store[n])
                        for n in sorted(needed)}
    if self_active and not cfg.recompute_self:
        xs['base_self'] = {n: _reversed(inv_attn_store[n])
                           for n in cfg.self_site_names}
    elif cfg.recompute_self:
        # pre-step inversion latents and timesteps, reversed: edit step i
        # recomputes inversion step N-1-i's U-Net pass for its self maps
        if inv_z0 is None or inv_ts is None:
            raise ValueError('recompute_self needs inv_z0 and inv_ts')
        pre = torch.cat([inv_z0[None], inv_latents_per_step[:-1]])
        xs['inv_lat_pre'] = _reversed(pre)
        xs['inv_t'] = _reversed(t(inv_ts, torch.long))

    init_sums = {}
    if cfg.blend_latents:
        for n in cfg.blend_site_names:
            init_sums[n] = torch.zeros(inv_attn_store[n].shape[1:],
                                       dtype=torch.float32, device=dev)
    return EditBundle(cfg=cfg, static_state=static_state, xs=xs,
                      init_sums=init_sums)


def store_filter_for(cfg: EditConfig):
    names = set(cfg.blend_site_names)
    return lambda site, q: site.name in names


def inversion_store_filter(editing_config: dict, tokenizer, height: int,
                           width: int, video_length: int = 16,
                           num_steps: int = 50):
    """The sites the inversion must capture for every swap of the config
    (the reference stores everything < 32^2; this stores what is read).
    Self sites are skipped when the recompute path regenerates them."""
    h8, w8 = height // 8, width // 8
    names = {s.name for s in sites.blend_sites(h8, w8)}
    recompute = want_recompute_self(editing_config, height, width,
                                    video_length, num_steps)
    for swap_cfg in editing_config.get('editing_prompts', {}).values():
        bc = swap_cfg.get('blend_cfg', {}) or {}
        if bc.get('cross_replace_steps', 0.0):
            names |= {s.name for s in sites.controlled_sites('cross', h8, w8)}
        if bc.get('self_replace_steps', 0.0) and not recompute:
            names |= {s.name for s in sites.controlled_sites('self', h8, w8)}
    return lambda site, q: site.name in names


# --------------------------------------------------------------------------
# per-step functions
# --------------------------------------------------------------------------

def _cond_half(probs: torch.Tensor, f: int, do_cfg: bool):
    """(uncond rows, cond rows) of the probabilities, None for a half this
    rank does not hold (rows [uncond; cond] under CFG, one video)."""
    if not do_cfg:
        return None, probs
    rows, frames = sharding.local_rows(), sharding.local_frames()
    if rows is None:
        return probs[:f], probs[f:]
    fl = frames[1] - frames[0]           # rows 0 (uncond) and 1 (cond)
    uncond = probs[:fl] if rows[0] == 0 else None
    cond = probs[fl if rows[0] == 0 else 0:] if rows[1] == 2 else None
    return uncond, cond


def _join(uncond, cond, do_cfg: bool, dtype):
    if not do_cfg:
        return cond
    if uncond is None:
        return cond.to(dtype)
    return torch.cat([uncond, cond.to(dtype)])


def _frames(t: torch.Tensor) -> torch.Tensor:
    """A store's (F, ...) maps cut to this rank's frames."""
    frames = sharding.local_frames()
    return t if frames is None else t[frames[0]:frames[1]]


def make_edit_fn(cfg: EditConfig, static_state: dict):
    """The AttnCtrl edit_fn: (site, q_tokens, state) -> probs rewrite."""
    f = cfg.video_length

    def edit_cross(probs, state, name):
        uncond, cond = _cond_half(probs, f, cfg.do_cfg)
        if cond is None:
            return probs
        base = _frames(state['base'][name]).float()          # (F,h,s,77)
        cond32 = cond.float()
        if cfg.refine:
            alphas = static_state['alphas']
            base_rep = (base[..., static_state['mapper']] * alphas
                        + cond32 * (1 - alphas))
        else:
            base_rep = torch.einsum('fhsw,wn->fhsn', base,
                                    static_state['mapper_mat'])
        aw = state['alpha_words']                            # (77,)
        return _join(uncond, base_rep * aw + cond32 * (1 - aw), cfg.do_cfg,
                     probs.dtype)

    def edit_self(probs, state, name, q_tokens):
        uncond, cond = _cond_half(probs, f, cfg.do_cfg)
        if cond is None:
            return probs
        cond32 = cond.float()
        if not state['self_on']:
            return _join(uncond, cond32, cfg.do_cfg, probs.dtype)
        base = _frames(state['base_self'][name]).float()
        if cfg.blend_self:
            mask = _frames(state['self_mask'][str(q_tokens)])  # (F,1,s,1)
            new = mask * cond32 + (1 - mask) * base
        else:
            new = base.expand_as(cond32)
        return _join(uncond, new, cfg.do_cfg, probs.dtype)

    def edit_fn(site: SiteKey, q_tokens: int, state):
        name = site.name
        if site.kind == 'cross':
            if not cfg.cross_active or name not in cfg.cross_site_names:
                return None
            return lambda p: edit_cross(p, state, name)
        if cfg.self_range[1] <= cfg.self_range[0] or \
                name not in cfg.self_site_names:
            return None
        return lambda p: edit_self(p, state, name, q_tokens)

    return edit_fn


def self_masks_for_step(cfg: EditConfig, static_state: dict,
                        base_cross: dict) -> dict:
    """Source-prompt blend masks at each self-site resolution, from this
    step's inversion maps (reference attention_util.py:116-125)."""
    out = {}
    maps = [base_cross[n][None] for n in cfg.blend_site_names]
    alpha_src = static_state['alpha_layers'][:1]
    for _, (sh, sw) in cfg.self_site_hw:
        key = str(sh * sw)
        if key in out:
            continue
        m = blend.blend_mask(maps, alpha_src, cfg.th, (sh, sw), cfg.height,
                             cfg.width)                       # (1,F,sh,sw)
        out[key] = m[0].reshape(cfg.video_length, 1, sh * sw, 1).float()
    return out


def latent_blend_step(cfg: EditConfig, static_state: dict, lat: torch.Tensor,
                      inv_lat: torch.Tensor, base_cross: dict, sums: dict,
                      tgt_maps: dict, step_idx: int) -> tuple[torch.Tensor,
                                                              dict]:
    """One step of spatial latent blending; returns (lat, new_sums).
    tgt_maps: this step's stored target maps (the cond half, pre-edit,
    (F, heads, s, 77)), summed into `sums` as the reference accumulates
    its attention store."""
    new_sums = {n: sums[n] + tgt_maps[n].float()
                for n in cfg.blend_site_names}
    counter = step_idx + 1
    if not cfg.start_blend < counter < cfg.end_blend:
        return lat, new_sums
    site_maps = [torch.stack([base_cross[n].float(), new_sums[n]])
                 for n in cfg.blend_site_names]      # (2, F, heads, s, 77)
    mask = blend.blend_mask(site_maps, static_state['alpha_layers'], cfg.th,
                            (cfg.h8, cfg.w8), cfg.height, cfg.width)
    mask = blend.union_both(mask)[1]                 # (F, h8, w8)
    return blend.latent_blend(inv_lat.to(lat.dtype), lat, mask), new_sums


def make_store_edit_ctrl(cfg: EditConfig, static_state: dict,
                         state: dict) -> AttnCtrl:
    mode = 'store_edit' if cfg.blend_latents else 'edit'
    return AttnCtrl(mode=mode, store_filter=store_filter_for(cfg),
                    edit_fn=make_edit_fn(cfg, static_state), state=state)
