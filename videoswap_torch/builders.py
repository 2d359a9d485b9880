"""Config -> models: the construction part of videoswap_tpu/builders.py
`build_models`, for runs without checkpoint files.

`models_opt` takes the JAX package's `opt['models']` keys that size the
models: `unet.unet_cfg` (UNet3DConfig fields), `vae_cfg` (AutoencoderKL
keyword arguments), `text_encoder_cfg` (CLIPTextConfig fields) and
`adapter.adapter_cfg` (AdapterConfig fields). Keys that name files
(pretrained weights, inference or adapter config paths) are refused:
loading checkpoints is not ported yet (ROADMAP.md).

Weights are drawn from a seeded generator (utils/init.py) on the target
device, model by model in the order U-Net, VAE, text encoder, adapter.

`build_atlas_nets` builds the layered-neural-atlas nets of an atlas
config's `models` block the same way.
"""

from __future__ import annotations

from typing import Optional

import torch

from videoswap_torch.atlas.imlp import imlp_from_opt, init_imlp
from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                    SparsePointAdapter, UNet3DConfig)
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.schedulers import make_schedule
from videoswap_torch.utils.init import init_weights
from videoswap_torch.utils.tokenizer import HashTokenizer

_FILE_KEYS = ('inference_config_path', 'motion_module_path',
              'model_config_path', 'pretrained_model_path')
ATLAS_NET_NAMES = ('FG_UV_Mapping', 'BG_UV_Mapping', 'F_Alpha', 'F_Atlas',
                   'FG_UV_Mapping_Inverse')


def _tuples(kwargs: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items()}


def build_models(models_opt: Optional[dict] = None,
                 device: Optional[str | torch.device] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0) -> dict:
    """Build unet, vae, text_encoder, adapter, sched and tokenizer.

    device: None means 'cuda' (the port's kernels run there; pass 'cpu'
    for the plain versions). Models come back in eval mode, in `dtype`."""
    opt = models_opt or {}
    for name in ('unet', 'adapter'):
        found = [k for k in _FILE_KEYS if k in opt.get(name, {})]
        if found:
            raise NotImplementedError(
                f'models.{name}: {found} name files; loading configs and '
                'checkpoints is not ported yet (ROADMAP.md)')
    device = torch.device('cuda' if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        models = {
            'unet': AnimateDiffUNet3DModel(UNet3DConfig(**_tuples(
                opt.get('unet', {}).get('unet_cfg', {})))),
            'vae': AutoencoderKL(**_tuples(opt.get('vae_cfg', {}))),
            'text_encoder': CLIPTextModel(CLIPTextConfig(
                **opt.get('text_encoder_cfg', {}))),
            'adapter': SparsePointAdapter(AdapterConfig(**_tuples(
                opt.get('adapter', {}).get('adapter_cfg', {})))),
        }
    for m in models.values():
        init_weights(m, gen)
        # buffers made from numpy (the motion-module PE table) are built on
        # the CPU whatever the default device: move everything
        m.to(device=device, dtype=dtype).eval()
    return dict(models, sched=make_schedule(), tokenizer=HashTokenizer())


def build_atlas_nets(models_opt: dict,
                     device: Optional[str | torch.device] = None,
                     seed: int = 0) -> dict:
    """The layered-neural-atlas nets of an atlas config's `models` block
    (the counterpart of train_atlas.py `build_nets`), fp32, in the order
    FG_UV_Mapping, BG_UV_Mapping, F_Alpha, F_Atlas, FG_UV_Mapping_Inverse
    (those present). device: None means 'cuda'. Weights come from one
    seeded generator on the device, on flax's scales (`init_imlp`: not
    `init_weights`, which would draw the hash table from N(0, 1/fan_in))."""
    device = torch.device('cuda' if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    nets = {}
    for name in ATLAS_NET_NAMES:
        if name in models_opt:
            with torch.device(device):
                nets[name] = imlp_from_opt(models_opt[name])
            init_imlp(nets[name], gen)
    return nets
