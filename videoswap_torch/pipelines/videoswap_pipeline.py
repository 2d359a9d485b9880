"""VideoSwap sampling pipeline (the port of `VideoSwapPipeline.sample` and
`encode_prompt` in videoswap_tpu/pipelines/videoswap_pipeline.py).

Classifier-free guidance is the [uncond; cond] batch of the reference, with
the CFG-prefix dedup of the JAX package: the U-Net runs the shared prefix
once and doubles the batch at the first cross-attention. Point-adapter
residuals are gated by the step window `t2i_start`/`t2i_end`. DDIM steps
run in a plain Python loop; the latents stay on the device, and the VAE
decode quantises to uint8 there before the copy to the host.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Optional

import numpy as np
import torch

from videoswap_torch.models import AnimateDiffUNet3DModel, SparsePointAdapter
from videoswap_torch.models.clip_text import CLIPTextModel
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.schedulers import (DiffusionSchedule, ddim_step,
                                        ddim_timesteps)
from videoswap_torch.utils.registry import PIPELINE_REGISTRY


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

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    # ------------------------------------------------------------------ text
    def encode_prompt(self, prompts: list[str]) -> torch.Tensor:
        """[B, 77, hidden] text embeddings in the text encoder's dtype."""
        ids = self.tokenizer(prompts, padding='max_length',
                             max_length=self.tokenizer.model_max_length,
                             truncation=True).input_ids
        ids = torch.as_tensor(np.asarray(ids), device=self.device)
        with torch.no_grad():
            return self.text_encoder(ids)

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
               edit_bundle: Any = None,
               generator: Optional[torch.Generator] = None,
               output_type: str = 'pil',
               sampler: str = 'ddim',
               callback: Optional[Callable[[int, torch.Tensor, torch.Tensor],
                                           None]] = None):
        """CFG DDIM sampling with point-adapter residual guidance (the
        reference `__call__`). `latents` (1, F, h, w, 4) start the loop
        (e.g. inverted latents); otherwise they are drawn from `generator`.
        `callback(i, t, latents)` runs after every step. output_type:
        'latent' (device tensor), 'np' (float video in [-1, 1], the uint8
        quantisation undone) or 'pil' (list of frames)."""
        if edit_bundle is not None:
            raise NotImplementedError(
                'prompt-to-prompt editing (edit_bundle) is not ported yet; '
                'see ROADMAP.md Queue 1 item 12')
        if sampler != 'ddim':
            raise NotImplementedError(
                f'sampler {sampler!r} is not ported yet; only ddim (see '
                'ROADMAP.md Queue 1 item 11)')
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
        # cross-attention, so the U-Net runs that prefix on batch 1
        dedup = bool(do_cfg and lat.shape[0] == 1 and h8 * w8 >= 1024)

        for i, t in enumerate(ts):
            inp = lat if (not do_cfg or dedup) else torch.cat([lat, lat])
            res = None
            if adapter_states is not None:
                gate = float(lo <= i <= hi)
                res = [s * gate for s in adapter_states]
            t_dev = torch.tensor(int(t), device=dev)
            eps = self.unet(inp, t_dev, text, adapter_residuals=res,
                            cfg_prefix_dedup=dedup)
            if do_cfg:
                eps_u, eps_c = eps.chunk(2)
                eps = eps_u + guidance_scale * (eps_c - eps_u)
                if guidance_rescale > 0.0:
                    eps = rescale_noise_cfg(eps, eps_c, guidance_rescale)
            lat = ddim_step(self.sched, eps.to(lat.dtype), int(t), lat,
                            num_inference_steps).to(lat.dtype)
            if callback is not None:
                callback(i, t_dev, lat)

        if output_type == 'latent':
            return lat
        img = self.vae.decode_video(lat.float())
        # quantise on the device: a 4x smaller copy to the host
        video = torch.clamp(torch.round((img.float() + 1.0) * 127.5), 0, 255
                            ).to(torch.uint8).cpu().numpy()
        if output_type == 'np':
            return video.astype(np.float32) / 127.5 - 1.0
        from PIL import Image
        return [Image.fromarray(f) for f in video[0]]
