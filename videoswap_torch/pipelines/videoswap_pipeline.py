"""VideoSwap inference pipeline: DDIM inversion and guided re-denoising
with prompt-to-prompt attention control and spatial latent blending (the
port of videoswap_tpu/pipelines/videoswap_pipeline.py).

Classifier-free guidance is the [uncond; cond] batch of the reference, with
the CFG-prefix dedup of the JAX package: the U-Net runs the shared prefix
once and doubles the batch at the first cross-attention. Point-adapter
residuals are gated by the step window `t2i_start`/`t2i_end`. DDIM steps
run in a plain Python loop; the latents stay on the device, and the VAE
decode quantises to uint8 there before the copy to the host.

The blended production path (`validation`): `invert` DDIM-inverts the
source video and stores, per step, the latents and exactly the attention
maps the edits will read; each swap then loads its ED-LoRA concept
(edlora.py), builds an `EditBundle` (p2p/edit.py) and runs `sample` with
cross/self replacement inside the U-Net and latent blending after each
step, and restores the weights. With `visualize_attention`, each swap's
cross-attention heatmaps are written beside its frames
(`_dump_attention_maps`, p2p/visualization.py).
"""

from __future__ import annotations

import copy
import functools
import os
from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from videoswap_torch.models import AnimateDiffUNet3DModel, SparsePointAdapter
from videoswap_torch.models.clip_text import CLIPTextModel
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.p2p import NO_CTRL, AttnCtrl
from videoswap_torch.p2p.edit import (EditBundle, inversion_store_filter,
                                      latent_blend_step, make_edit_bundle,
                                      make_store_edit_ctrl,
                                      self_masks_for_step,
                                      want_recompute_self)
from videoswap_torch.schedulers import (DiffusionSchedule, ddim_inverse_step,
                                        ddim_inverse_timesteps, ddim_step,
                                        ddim_timesteps, dpm_pp_2m_step)
from videoswap_torch.utils.image import video_geometry, video_pixels
from videoswap_torch.utils.registry import PIPELINE_REGISTRY
from videoswap_torch.utils.vis_util import overlay_points


def make_target_prompt(source_prompt: str, swap_cfg: dict) -> str:
    """The source prompt with the swap config's 'replace' (and
    'replace_other') rules applied: the target prompt."""
    src_subj, tgt_subj = [s.strip() for s in swap_cfg['replace'].split('->')]
    if src_subj not in source_prompt:
        raise ValueError(f'source subject {src_subj!r} is not in the source '
                         f'prompt {source_prompt!r}')
    target_prompt = source_prompt.replace(src_subj, tgt_subj)
    if 'replace_other' in swap_cfg:
        so, to = [s.strip() for s in swap_cfg['replace_other'].split('->')]
        if so not in target_prompt:
            raise ValueError(f'{so!r} is not in the prompt {target_prompt!r}')
        target_prompt = target_prompt.replace(so, to)
    return target_prompt


def rescale_noise_cfg(noise_cfg, noise_pred_text, guidance_rescale):
    """arXiv:2305.08891 section 3.4 (reference pipeline :582-584)."""
    dims = tuple(range(1, noise_pred_text.dim()))
    std_text = noise_pred_text.std(dim=dims, keepdim=True, correction=0)
    std_cfg = noise_cfg.std(dim=dims, keepdim=True, correction=0)
    rescaled = noise_cfg * (std_text / std_cfg)
    return guidance_rescale * rescaled + (1 - guidance_rescale) * noise_cfg


@PIPELINE_REGISTRY.register()
@dataclass
class VideoSwapPipeline:
    unet: AnimateDiffUNet3DModel
    vae: AutoencoderKL
    text_encoder: CLIPTextModel
    tokenizer: Any
    sched: DiffusionSchedule
    adapter: Optional[SparsePointAdapter] = None
    extra_token_embeds: Optional[torch.Tensor] = None   # ED-LoRA concept rows
    new_concept_cfg: Optional[dict] = None

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # ------------------------------------------------------------------ text
    def encode_prompt(self, prompts: list[str]) -> torch.Tensor:
        """[B, 77, hidden] text embeddings in the text encoder's dtype; with
        an ED-LoRA concept loaded, the layer-wise [B, 16, 77, hidden]."""
        with torch.no_grad():
            if self.new_concept_cfg:
                from videoswap_torch.edlora import encode_edlora_prompt
                return encode_edlora_prompt(self, prompts)
            ids = self.tokenizer(prompts, padding='max_length',
                                 max_length=self.tokenizer.model_max_length,
                                 truncation=True).input_ids
            ids = torch.as_tensor(np.asarray(ids), device=self.device)
            return self.text_encoder(
                ids, extra_token_embeds=self.extra_token_embeds)

    # ------------------------------------------------------------- adapter
    def _adapter_states(self, conditions, size, t2i_guidance_scale, cfg):
        if conditions is None or self.adapter is None:
            return None
        dev = self.device
        tracks = torch.as_tensor(np.asarray(conditions['pred_tracks']),
                                 dtype=torch.float32, device=dev)
        emb = torch.as_tensor(np.asarray(conditions['point_embedding']),
                              dtype=torch.float32, device=dev)
        index_list = conditions.get('index_list')
        p = tracks.shape[1]
        mask = torch.ones(p, dtype=torch.bool, device=dev)
        if index_list is not None:
            mask = torch.zeros(p, dtype=torch.bool, device=dev)
            mask[torch.as_tensor(np.asarray(index_list), device=dev)] = True
        with torch.no_grad():
            states = self.adapter(tracks, size, emb, point_mask=mask)
        # add batch; an adapter trained with fp32 weights serves any U-Net
        dt = self.unet.conv_in.weight.dtype
        states = [s[None].to(dt) * t2i_guidance_scale for s in states]
        if cfg:
            states = [torch.cat([s, s]) for s in states]
        return states

    # ------------------------------------------------------------ inversion
    @torch.no_grad()
    def invert(self, video, prompt: str, num_inference_steps: int = 50,
               store_ctrl: AttnCtrl = NO_CTRL,
               callback: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                           None]] = None):
        """DDIM-invert a source video (reference `invert`). video: PIL
        frames, uint8 frames (F, H, W, 3), or a (1, F, H, W, 3) array or
        tensor in [-1, 1].

        Returns (inverted latents (1, F, h, w, 4), per_step) with per_step
        'latents' (N, 1, F, h, w, 4) after each step, 'z0' the encoded
        latents before any step, 'ts' the N inversion timesteps,
        'src_text' the prompt's embedding and 'attn' {site: (N, F, heads,
        S, T)} of the sites `store_ctrl` stores. `callback(i, t, latents)`
        runs after every step. No CFG (guidance 1), and the VAE
        posterior's mode: the inversion is deterministic."""
        pixels = torch.as_tensor(video_pixels(video)).to(self.device,
                                                         torch.float32)
        text = self.encode_prompt([prompt])
        ts = ddim_inverse_timesteps(self.sched.num_train_timesteps,
                                    num_inference_steps)
        lat = self.vae.encode_video(pixels).to(text.dtype)
        z0 = lat
        lat_hist, attn_hist = [], []
        for i, t in enumerate(ts):
            t_dev = torch.tensor(int(t), device=self.device)
            out = self.unet(lat, t_dev, text, ctrl=store_ctrl)
            eps, store = out if store_ctrl.stores else (out, {})
            lat = ddim_inverse_step(self.sched, eps, int(t), lat,
                                    num_inference_steps).to(lat.dtype)
            lat_hist.append(lat)
            attn_hist.append({k: a.to(lat.dtype) for k, a in store.items()})
            if callback is not None:
                callback(i, t_dev, lat)
        attn = {k: torch.stack([s[k] for s in attn_hist])
                for k in attn_hist[0]} if attn_hist else {}
        per_step = {'latents': torch.stack(lat_hist), 'z0': z0,
                    'ts': torch.as_tensor(np.asarray(ts)), 'src_text': text,
                    'attn': attn}
        return lat, per_step

    def _recompute_self_maps(self, ecfg, estate, lat_pre, t_inv) -> dict:
        """The inversion step's self-attention maps, regenerated from its
        stored pre-step latent with the inversion's text and the U-Net
        weights of the inversion (`estate['inv_unet']`: the originals of
        whatever an ED-LoRA merge changed since)."""
        names = set(ecfg.self_site_names)
        ctrl = AttnCtrl(mode='store',
                        store_filter=lambda site, q: site.name in names)
        args = (lat_pre, t_inv, estate['src_text'])
        inv_weights = estate.get('inv_unet') or {}
        if inv_weights:
            _, store = torch.func.functional_call(
                self.unet, inv_weights, args, {'ctrl': ctrl}, strict=False)
        else:
            _, store = self.unet(*args, ctrl=ctrl)
        return {n: store[n].float() for n in ecfg.self_site_names}

    # ------------------------------------------------------------- sampling
    @torch.no_grad()
    def sample(self,
               prompt: str,
               video_length: int,
               height: int,
               width: int,
               num_inference_steps: int = 50,
               guidance_scale: float = 7.5,
               negative_prompt: Optional[str] = None,
               latents: Optional[torch.Tensor] = None,
               conditions: Optional[dict] = None,
               t2i_guidance_scale: float = 1.0,
               t2i_start: float = 0.0,
               t2i_end: float = 1.0,
               guidance_rescale: float = 0.0,
               edit_bundle: Optional[EditBundle] = None,
               generator: Optional[torch.Generator] = None,
               output_type: str = 'pil',
               sampler: str = 'ddim',
               callback: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                           None]] = None,
               return_attn_sums: bool = False):
        """CFG DDIM sampling with point-adapter residual guidance and, with
        an `edit_bundle`, prompt-to-prompt control and latent blending (the
        reference `__call__`). `latents` (1, F, h, w, 4) start the loop
        (e.g. inverted latents); otherwise they are drawn from `generator`.
        `callback(i, t, latents)` runs after every step. output_type:
        'latent' (device tensor), 'np' (float video in [-1, 1], the uint8
        quantisation undone), 'uint8' (frames (F, H, W, 3)) or 'pil' (list
        of frames). sampler: 'ddim' or
        'dpmpp_2m' (DPM-Solver++(2M), schedulers/dpm.py, on the same
        timestep grid). With `return_attn_sums`, returns (output, sums):
        the edit's stored target maps at the blend sites summed over the
        steps, {site: (F, heads, S, 77)} (empty without an edit bundle)."""
        if sampler not in ('ddim', 'dpmpp_2m'):
            raise ValueError(f'unknown sampler {sampler!r}: ddim or '
                             'dpmpp_2m')
        use_dpm = sampler == 'dpmpp_2m'
        dev = self.device
        do_cfg = guidance_scale > 1.0
        text = self.encode_prompt([negative_prompt or '', prompt] if do_cfg
                                  else [prompt])
        dtype = text.dtype

        h8, w8 = height // 8, width // 8
        if latents is None:
            latents = torch.randn((1, video_length, h8, w8, 4),
                                  generator=generator, device=dev,
                                  dtype=torch.float32) \
                * self.sched.init_noise_sigma
        lat = latents.to(device=dev, dtype=dtype)

        adapter_states = self._adapter_states(
            conditions, (width, height), t2i_guidance_scale, do_cfg)
        ts = ddim_timesteps(self.sched.num_train_timesteps,
                            num_inference_steps)
        lo, hi = t2i_start * num_inference_steps, t2i_end * num_inference_steps
        # the CFG halves agree until text enters at the first
        # cross-attention, so the U-Net runs that prefix on batch 1 (no
        # controller reaches that prefix's >= 32^2-token site)
        dedup = bool(do_cfg and lat.shape[0] == 1 and h8 * w8 >= 1024)
        ecfg = edit_bundle.cfg if edit_bundle is not None else None
        sums = dict(edit_bundle.init_sums) if ecfg is not None else {}
        prev_x0 = torch.zeros_like(lat) if use_dpm else None

        for i, t in enumerate(ts):
            inp = lat if (not do_cfg or dedup) else torch.cat([lat, lat])
            res = None
            if adapter_states is not None:
                gate = float(lo <= i <= hi)
                res = [s * gate for s in adapter_states]
            t_dev = torch.tensor(int(t), device=dev)
            kw = dict(adapter_residuals=res, cfg_prefix_dedup=dedup)
            if ecfg is None:
                eps = self.unet(inp, t_dev, text, **kw)
            else:
                step = {k: ({n: a[i] for n, a in v.items()}
                            if isinstance(v, dict) else v[i])
                        for k, v in edit_bundle.xs.items()}
                eps, tgt_maps = self._edited_unet(ecfg, edit_bundle, step, i,
                                                  inp, t_dev, text, kw)
            if do_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
                if guidance_rescale > 0.0:
                    eps = rescale_noise_cfg(eps, eps_c, guidance_rescale)
            if use_dpm:
                lat, prev_x0 = dpm_pp_2m_step(
                    self.sched, eps.to(lat.dtype), int(t), lat, prev_x0, i,
                    num_inference_steps)
            else:
                lat = ddim_step(self.sched, eps.to(lat.dtype), int(t), lat,
                                num_inference_steps).to(lat.dtype)
            if ecfg is not None and ecfg.blend_latents:
                lat, sums = latent_blend_step(
                    ecfg, edit_bundle.static_state, lat, step['inv_latents'],
                    step['base_cross'], sums, tgt_maps, i)
            if callback is not None:
                callback(i, t_dev, lat)

        def wrap(out):
            return (out, sums) if return_attn_sums else out

        if output_type == 'latent':
            return wrap(lat)
        img = self.vae.decode_video(lat.float())
        # quantise on the device: a 4x smaller copy to the host
        video = torch.clamp(torch.round((img.float() + 1.0) * 127.5), 0, 255
                            ).to(torch.uint8).cpu().numpy()
        if output_type == 'np':
            return wrap(video.astype(np.float32) / 127.5 - 1.0)
        if output_type == 'uint8':
            return wrap(video[0])
        from PIL import Image
        return wrap([Image.fromarray(f) for f in video[0]])

    def _edited_unet(self, ecfg, bundle, step, i, inp, t_dev, text, kw):
        """One U-Net call under the edit controller: (eps, this step's
        stored target maps at the blend sites, the cond half)."""
        estate = bundle.static_state
        state = {'alpha_words': estate['alpha_words'][i],
                 'base': step.get('base_cross', {})}
        self_on = ecfg.self_range[0] <= i < ecfg.self_range[1]
        if 'base_self' in step:
            state['base_self'], state['self_on'] = step['base_self'], self_on
        elif ecfg.recompute_self:
            # regenerate inversion step N-1-i's self maps from its stored
            # pre-step latent (storing them all would take ~4 GB at 512^2)
            state['base_self'] = (self._recompute_self_maps(
                ecfg, estate, step['inv_lat_pre'], step['inv_t'])
                if self_on else {})
            state['self_on'] = self_on
        if ecfg.blend_self:
            state['self_mask'] = self_masks_for_step(ecfg, estate,
                                                     state['base'])
        ctrl = make_store_edit_ctrl(ecfg, estate, state)
        out = self.unet(inp, t_dev, text, ctrl=ctrl, **kw)
        if not ctrl.stores:
            return out, {}
        eps, store = out
        f = ecfg.video_length
        return eps, {k: (m[f:] if ecfg.do_cfg else m)
                     for k, m in store.items()}

    # ------------------------------------------------------- attention dumps
    @torch.no_grad()
    def _dump_attention_maps(self, prompt: str, frames, key: str,
                             save_dir: str, attn_sums=None,
                             num_steps: int = 50):
        """A finished swap's cross-attention heatmaps under
        `save_dir/<key>_attention/` (the reference's visualize_attention).
        With `attn_sums` (the edit's stored target maps at the blend sites,
        summed over its steps) the maps are their mean over the steps;
        without them (a swap without stores) one U-Net pass on the encoded
        result at t = 261 stores every cross-attention site's. Returns the
        heatmaps' (res_y, res_x, 77) array at the blend sites' resolution,
        or None when the latent has no blend site."""
        from videoswap_torch.p2p import sites as p2p_sites
        from videoswap_torch.p2p.visualization import (aggregate_attention,
                                                       show_cross_attention)
        pixels = torch.as_tensor(video_pixels(frames)).to(self.device,
                                                          torch.float32)
        h8, w8 = pixels.shape[2] // 8, pixels.shape[3] // 8
        if attn_sums:
            store = {name: a.float() / num_steps
                     for name, a in attn_sums.items()}
        else:
            ctrl = AttnCtrl(mode='store',
                            store_filter=lambda site, q: site.kind == 'cross')
            text = self.encode_prompt([prompt])
            lat = self.vae.encode_video(pixels).to(text.dtype)
            _, store = self.unet(lat, torch.tensor(261, device=self.device),
                                 text, ctrl=ctrl)
        blend = p2p_sites.blend_sites(h8, w8)
        if not blend:
            return None
        ry, rx = p2p_sites.site_hw(blend[0], h8, w8)
        show_cross_attention(self.tokenizer, prompt, store, ry, rx,
                             os.path.join(save_dir, f'{key}_attention'))
        return aggregate_attention(store, ry, rx)

    # ------------------------------------------------------------ validation
    def validation(self, source_video, source_conditions, source_prompt,
                   editing_config: dict, train_dataset=None, save_dir=None,
                   output_type: str = 'pil',
                   callback: Optional[Callable[[str, int, torch.Tensor,
                                                torch.Tensor], None]] = None):
        """The per-swap loop of the reference `validation`: the inversion
        (storing what the blends and edits read), then per swap a transient
        ED-LoRA merge, the conditions (the swap's `tap_path` through
        `train_dataset.get_conditions`, `select_point` names to
        `index_list`), the target prompt, the controller, seed-0 sampling
        with the swap's or the config's `sampler`, and the weight restore.
        Returns {swap: frames}, and with `visualize_point` also {swap +
        '_vispoint': the frames with the selected points drawn}.

        source_video: PIL frames, uint8 frames (F, H, W, 3) (a dataset's
        `get_frames()`), or a (1, F, H, W, 3) video in [-1, 1].
        `output_type` is passed to `sample` (the one adaptation of the port:
        the JAX package always returns PIL frames; the default is the
        same). `callback(stage, i, t, latents)` runs after every step of
        the inversion (stage 'invert') and of each swap (stage = the
        swap's key). With `visualize_attention` and a `save_dir`, each
        swap's cross-attention heatmaps are written under
        `save_dir/<swap>_attention/` (`_dump_attention_maps`: the edit's
        summed maps with `use_blend`, else one U-Net pass on the result);
        the frames must then be decoded (`output_type` not 'latent')."""
        cfg = editing_config
        use_inv = cfg.get('use_invertion_latents', True)
        use_blend = cfg.get('use_blend', False)
        steps = cfg.get('num_inference_steps', 50)
        dump_attention = bool(cfg.get('visualize_attention')
                              and save_dir is not None)
        if dump_attention and output_type == 'latent':
            raise ValueError("visualize_attention draws on the decoded "
                             "frames: output_type must not be 'latent'")
        if cfg.get('visualize_point') and output_type != 'uint8':
            raise ValueError("visualize_point draws on uint8 frames: "
                             "output_type='uint8'")
        if use_blend and not use_inv:
            raise ValueError('use_blend needs the inversion '
                             '(use_invertion_latents)')

        video_length, height, width = video_geometry(source_video)
        width, height = width - width % 8, height - height % 8

        ddim_latents, per_step = None, None
        recompute_self = want_recompute_self(cfg, height, width,
                                             video_length, steps)
        if use_inv:
            store_ctrl = NO_CTRL
            if use_blend:
                store_ctrl = AttnCtrl(
                    mode='store',
                    store_filter=inversion_store_filter(
                        cfg, self.tokenizer, height, width,
                        video_length=video_length, num_steps=steps))
            ddim_latents, per_step = self.invert(
                source_video, source_prompt, num_inference_steps=steps,
                store_ctrl=store_ctrl,
                callback=(None if callback is None
                          else functools.partial(callback, 'invert')))

        from videoswap_torch.edlora import (load_edlora_into_pipeline,
                                            restore_pipeline)
        results = {}
        for key, swap_cfg in cfg.get('editing_prompts', {}).items():
            lora_ctx = None
            if swap_cfg.get('lora_path'):
                path, alpha = swap_cfg['lora_path'].rsplit('---', 1)
                lora_ctx = load_edlora_into_pipeline(self, path, float(alpha))
            try:
                if source_conditions is not None and swap_cfg.get(
                        'tap_path'):
                    conditions = train_dataset.get_conditions(
                        swap_cfg['tap_path'])
                else:
                    conditions = copy.deepcopy(source_conditions)
                if conditions is not None and swap_cfg.get('select_point'):
                    conditions['index_list'] = [
                        conditions['point_name2id'][n]
                        for n in swap_cfg['select_point']]
                elif conditions is not None:
                    conditions['index_list'] = None
                src_subj, tgt_subj = [s.strip() for s in
                                      swap_cfg['replace'].split('->')]
                target_prompt = make_target_prompt(source_prompt, swap_cfg)
                guidance_scale = swap_cfg.get(
                    'guidance_scale', cfg.get('guidance_scale', 7.5))
                edit_bundle = None
                if use_blend:
                    edit_bundle = make_edit_bundle(
                        self.tokenizer, source_prompt, target_prompt,
                        num_steps=steps, video_length=video_length,
                        height=height, width=width,
                        inv_latents_per_step=per_step['latents'],
                        inv_attn_store=per_step['attn'],
                        blend_words=[src_subj.split(' '),
                                     tgt_subj.split(' ')],
                        blend_cfg=swap_cfg.get('blend_cfg', {}),
                        do_cfg=guidance_scale > 1.0,
                        recompute_self=recompute_self,
                        inv_z0=per_step['z0'], inv_ts=per_step['ts'])
                    if edit_bundle.cfg.recompute_self:
                        # the maps were made before the concept load:
                        # regenerate them with the inversion's text and
                        # pre-merge weights
                        estate = edit_bundle.static_state
                        estate['src_text'] = per_step['src_text']
                        estate['inv_unet'] = (lora_ctx['unet'] if lora_ctx
                                              is not None else {})
                want_sums = dump_attention and edit_bundle is not None
                frames = self.sample(
                    prompt=target_prompt, video_length=video_length,
                    height=height, width=width, num_inference_steps=steps,
                    guidance_scale=guidance_scale,
                    negative_prompt=swap_cfg.get(
                        'negative_prompt', cfg.get('negative_prompt')),
                    latents=ddim_latents, conditions=conditions,
                    t2i_guidance_scale=swap_cfg.get(
                        't2i_guidance_scale',
                        cfg.get('t2i_guidance_scale', 1.0)),
                    t2i_start=cfg.get('t2i_start', 0.0),
                    t2i_end=cfg.get('t2i_end', 1.0), edit_bundle=edit_bundle,
                    generator=torch.Generator(device=self.device)
                    .manual_seed(0),
                    output_type=output_type,
                    sampler=swap_cfg.get('sampler',
                                         cfg.get('sampler', 'ddim')),
                    callback=(None if callback is None
                              else functools.partial(callback, key)),
                    return_attn_sums=want_sums)
                attn_sums = None
                if want_sums:
                    frames, attn_sums = frames
                results[key] = frames
                if conditions is not None and cfg.get('visualize_point'):
                    results[key + '_vispoint'] = overlay_points(
                        results[key], conditions)
                if dump_attention:
                    self._dump_attention_maps(target_prompt, frames, key,
                                              save_dir, attn_sums=attn_sums,
                                              num_steps=steps)
            finally:
                if lora_ctx is not None:
                    restore_pipeline(self, lora_ctx)
        return results

