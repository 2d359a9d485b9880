"""Config -> models (the port of videoswap_tpu/builders.py `build_models`
and its helpers).

`build_models(opt, root_path)` reads an experiment config's `models` and
`path` blocks:

- the U-Net's sizes from `models.unet.inference_config_path`
  (`unet_additional_kwargs`), `path.pretrained_model_path`'s
  `unet/config.json`, then `models.unet.unet_cfg` overrides
  (`unet_config_from_opt`); the adapter's from
  `models.adapter.model_config_path`, then `adapter_cfg`
  (`adapter_config_from_opt`); the VAE's and the text encoder's from
  `models.vae_cfg` and `models.text_encoder_cfg`; the noise schedule from
  the inference config's `noise_scheduler_kwargs`;
- weights drawn from a seeded generator on the target device (utils/init.py,
  model by model in the order U-Net, VAE, text encoder, adapter), then
  overlaid with the pretrained directory's `unet/diffusion_pytorch_model.bin`
  (with `models.unet.motion_module_path` merged in), `vae/...` and
  `text_encoder/pytorch_model.bin`, and `path.pretrained_adapter_path`'s
  `.pth`, each a `load_state_dict` after key normalisation
  (models/converters.py) whose missing and unused keys are logged and
  put in the caller's `load_report` dict when one is given;
- the tokenizer: CLIP's BPE from the pretrained directory's `tokenizer/`,
  else the hash stand-in.

As in the JAX package, a `pretrained_model_path` that is not a directory
is logged and the weights stay random (runs without checkpoints); a file
that a key names and that is missing raises.

`save_adapter_checkpoint` writes a trained adapter as the reference's
`.pth` (the file `load_adapter_checkpoint` reads); `save_train_state` and
`load_train_state` keep the adapter, the AdamW state and the step in one
torch file (the JAX package's are flax's msgpack and a pickle).

`build_clip_scorer` builds the swap CLI's CLIP scorer (both CLIP towers
and their projections) from a local CLIP directory.

`build_atlas_nets` builds the layered-neural-atlas nets of an atlas
config's `models` block the same way; `save_atlas_checkpoint` and
`load_atlas_checkpoint` write and read them as one torch file of flat
`<net>.<param>` keys under the reference IMLP's names (`hidden.<i>.weight`,
`hash_table`), the layout the JAX package's `.pth` loader reads (its own
files are flax's msgpack).
"""

from __future__ import annotations

import json
import os
import re
from typing import Optional

import torch

from videoswap_torch.atlas.imlp import imlp_from_opt, init_imlp
from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                    SparsePointAdapter, UNet3DConfig,
                                    converters)
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.schedulers import make_schedule
from videoswap_torch.utils.config import load_config, resolve_path
from videoswap_torch.utils.init import init_weights
from videoswap_torch.utils.logger import get_logger
from videoswap_torch.utils.tokenizer import load_tokenizer

ATLAS_NET_NAMES = ('FG_UV_Mapping', 'BG_UV_Mapping', 'F_Alpha', 'F_Atlas',
                   'FG_UV_Mapping_Inverse')
# the config's `mixed_precision` -> the models' dtype (the U-Net kernels
# take bf16; fp16 runs in bf16, as in the JAX package)
MIXED_PRECISION = {'fp16': torch.bfloat16, 'bf16': torch.bfloat16,
                   'no': torch.float32}


def _tuples(kwargs: dict) -> dict:
    return {k: tuple(v) if isinstance(v, list) else v
            for k, v in kwargs.items()}


def unet_config_from_opt(model_opt: dict, root_path: str,
                         pretrained_path: Optional[str]) -> UNet3DConfig:
    kwargs = {}
    inf_cfg_path = model_opt.get('inference_config_path')
    if inf_cfg_path:
        inf_cfg = load_config(resolve_path(root_path, inf_cfg_path))
        ak = inf_cfg.get('unet_additional_kwargs', {})
        mk = ak.get('motion_module_kwargs', {})
        kwargs.update(
            use_motion_module=ak.get('use_motion_module', True),
            motion_module_resolutions=tuple(
                ak.get('motion_module_resolutions', (1, 2, 4, 8))),
            motion_module_mid_block=ak.get('motion_module_mid_block', False),
            motion_heads=mk.get('num_attention_heads', 8),
            motion_num_transformer_block=mk.get('num_transformer_block', 1),
            motion_max_len=mk.get('temporal_position_encoding_max_len', 24),
        )
        lv = mk.get('long_video_config') or {}
        if lv.get('window'):
            kwargs.update(motion_window=int(lv['window']),
                          motion_window_stride=int(lv['stride'])
                          if lv.get('stride') else None)
    cfg_json = (os.path.join(pretrained_path, 'unet', 'config.json')
                if pretrained_path else None)
    if cfg_json and os.path.isfile(cfg_json):
        with open(cfg_json) as f:
            dcfg = json.load(f)
        kwargs.update(
            block_out_channels=tuple(dcfg['block_out_channels']),
            layers_per_block=dcfg.get('layers_per_block', 2),
            attention_head_dim=dcfg.get('attention_head_dim', 8),
            cross_attention_dim=dcfg.get('cross_attention_dim', 768),
            norm_num_groups=dcfg.get('norm_num_groups', 32),
        )
    kwargs.update(model_opt.get('unet_cfg', {}))
    return UNet3DConfig(**_tuples(kwargs))


def adapter_config_from_opt(model_opt: dict, root_path: str) -> AdapterConfig:
    kwargs = {}
    p = model_opt.get('model_config_path')
    if p:
        c = load_config(resolve_path(root_path, p))
        kwargs.update(
            embedding_channels=c.get('embedding_channels', 1280),
            channels=tuple(c.get('channels', (320, 640, 1280, 1280))),
            downsample_rate=tuple(c.get('downsample_rate', (8, 16, 32, 64))),
            mid_dim=c.get('mid_dim', 128),
        )
    kwargs.update(model_opt.get('adapter_cfg', {}))
    return AdapterConfig(**_tuples(kwargs))


def schedule_from_opt(model_opt: dict, root_path: str):
    """The noise schedule of the U-Net's inference config
    (`noise_scheduler_kwargs`), else the default."""
    p = model_opt.get('inference_config_path')
    kwargs = (load_config(resolve_path(root_path, p)).get(
        'noise_scheduler_kwargs', {}) if p else {})
    return make_schedule(**kwargs)


def _file(path: str, what: str) -> str:
    if not os.path.isfile(path):
        raise FileNotFoundError(f'{what}: no file {path}')
    return path


def load_adapter_checkpoint(path: str, adapter: SparsePointAdapter):
    """A trained adapter's reference `.pth` into `adapter`; returns
    (missing, unused) keys."""
    if not path.endswith('.pth'):
        raise NotImplementedError(
            f'{path}: only the reference .pth adapter checkpoints load in '
            'the port (the JAX package\'s .msgpack needs flax)')
    sd = converters.load_torch_file(_file(path, 'pretrained_adapter_path'))
    return converters.load_normalized(adapter, sd)


def _save_atomic(obj, path: str) -> None:
    """torch.save to a temporary name beside `path`, then rename: a run
    killed mid-save leaves the previous file whole."""
    os.makedirs(os.path.dirname(path) or '.', exist_ok=True)
    tmp = f'{path}.tmp-{os.getpid()}'
    torch.save(obj, tmp)
    os.replace(tmp, path)


def _adapter_state(adapter: SparsePointAdapter) -> dict:
    """The adapter's state dict under the reference's keys, fp32 on the
    CPU."""
    return {k: v.detach().to('cpu', torch.float32)
            for k, v in adapter.state_dict().items()}


def save_adapter_checkpoint(path: str, adapter: SparsePointAdapter) -> None:
    """A trained adapter as the reference's `.pth` (its state dict, fp32),
    the file `load_adapter_checkpoint` and a swap config's
    `path.pretrained_adapter_path` read."""
    _save_atomic(_adapter_state(adapter), path)


def train_state_dict(adapter: SparsePointAdapter,
                     optimizer: torch.optim.Optimizer,
                     global_step: int) -> dict:
    """A resumable checkpoint: the adapter (fp32), the AdamW `state_dict`
    and the step."""
    return {'adapter': _adapter_state(adapter),
            'optimizer': optimizer.state_dict(),
            'global_step': int(global_step)}


def restore_train_state(state: dict, adapter: SparsePointAdapter,
                        optimizer: torch.optim.Optimizer) -> int:
    """A `train_state_dict` into `adapter` (strict) and `optimizer`;
    returns its step."""
    adapter.load_state_dict(state['adapter'], strict=True)
    optimizer.load_state_dict(state['optimizer'])
    return int(state['global_step'])


def save_train_state(path: str, adapter: SparsePointAdapter,
                     optimizer: torch.optim.Optimizer,
                     global_step: int) -> None:
    """The train state in one torch file."""
    _save_atomic(train_state_dict(adapter, optimizer, global_step), path)


def load_train_state(path: str, adapter: SparsePointAdapter,
                     optimizer: torch.optim.Optimizer) -> int:
    """What `save_train_state` wrote, into `adapter` and `optimizer`;
    returns the step."""
    return restore_train_state(
        converters.load_torch_file(_file(path, 'train state')), adapter,
        optimizer)


def _load_pretrained(models: dict, pre: Optional[str], unet_opt: dict,
                     root_path: str) -> dict:
    """Overlay the diffusers directory's weights (when `pre` is one) and
    the motion module (when the config names one) on `models`; returns
    {model: (missing, unused)} of each load."""
    report = {}
    unet_sd = {}
    unet_bin = pre and os.path.join(pre, 'unet', 'diffusion_pytorch_model.bin')
    if unet_bin and os.path.isfile(unet_bin):
        unet_sd = converters.load_torch_file(unet_bin)
    motion = unet_opt.get('motion_module_path')
    if motion:
        unet_sd = converters.merge_motion_module(
            unet_sd, converters.load_torch_file(_file(
                resolve_path(root_path, motion), 'motion_module_path')))
    if unet_sd:
        report['unet'] = converters.load_normalized(models['unet'], unet_sd)
    if not pre:
        return report
    vae_bin = os.path.join(pre, 'vae', 'diffusion_pytorch_model.bin')
    if os.path.isfile(vae_bin):
        report['vae'] = converters.load_normalized(
            models['vae'], converters.normalize_vae_keys(
                converters.load_torch_file(vae_bin)))
    for name in ('pytorch_model.bin', 'model.bin'):
        text_bin = os.path.join(pre, 'text_encoder', name)
        if os.path.isfile(text_bin):
            report['text_encoder'] = converters.load_normalized(
                models['text_encoder'], converters.load_torch_file(text_bin),
                key_map=converters.clip_key_unmap)
            break
    return report


def build_models(opt: dict, root_path: str = '.',
                 device: Optional[str | torch.device] = None,
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 load_report: Optional[dict] = None) -> dict:
    """Build unet, vae, text_encoder, adapter, sched and tokenizer from an
    experiment config (`opt`: its `models` and `path` blocks; paths in it
    are relative to `root_path`). A `load_report` dict given is filled with
    {model: (missing keys, unused keys)} of each checkpoint loaded.

    device: None means 'cuda' (the port's kernels run there; pass 'cpu'
    for the plain versions). Models come back in eval mode, in `dtype`."""
    logger = get_logger()
    models_opt = opt.get('models', {})
    unet_opt = models_opt.get('unet', {})
    pre = resolve_path(root_path, opt.get('path', {}).get(
        'pretrained_model_path'))
    if pre and not os.path.isdir(pre):
        logger.warning(f'pretrained_model_path {pre} not found; the weights '
                       'are random (a run without checkpoints)')
        pre = None
    device = torch.device('cuda' if device is None else device)
    gen = torch.Generator(device=device).manual_seed(seed)
    with torch.device(device):
        models = {
            'unet': AnimateDiffUNet3DModel(unet_config_from_opt(
                unet_opt, root_path, pre)),
            'vae': AutoencoderKL(**_tuples(models_opt.get('vae_cfg', {}))),
            'text_encoder': CLIPTextModel(CLIPTextConfig(
                **models_opt.get('text_encoder_cfg', {}))),
            'adapter': SparsePointAdapter(adapter_config_from_opt(
                models_opt.get('adapter', {}), root_path)),
        }
    for m in models.values():
        init_weights(m, gen)
        # buffers made from numpy (the motion-module PE table) are built on
        # the CPU whatever the default device: move everything
        m.to(device=device, dtype=dtype).eval()

    report = _load_pretrained(models, pre, unet_opt, root_path)
    adapter_ckpt = opt.get('path', {}).get('pretrained_adapter_path')
    if adapter_ckpt:
        report['adapter'] = load_adapter_checkpoint(
            resolve_path(root_path, adapter_ckpt), models['adapter'])
    for name, (missing, unused) in report.items():
        logger.info(f'{name} load: {len(missing)} missing, {len(unused)} '
                    'unused keys')
    if load_report is not None:
        load_report.update(report)
    return dict(models, sched=schedule_from_opt(unet_opt, root_path),
                tokenizer=load_tokenizer(pre))


def build_clip_scorer(path: str,
                      device: Optional[str | torch.device] = None):
    """An openai/clip-vit-large-patch14-style directory -> a
    `CLIPWithProjection` in eval mode, fp32 on `device` (None means
    'cuda'). Sized from its config.json (`vision_config`, `text_config`,
    `projection_dim`; ViT-L/14 without one); loads `pytorch_model.bin` (or
    `model.bin`) when it is there, every key (a missing or an unused one
    raises), else draws random weights from a CPU generator seeded with 0
    (the same on every device) and logs that the scores are those of a
    random model."""
    from videoswap_torch.models.clip_vision import (CLIPVisionConfig,
                                                    CLIPWithProjection)
    logger = get_logger()
    vc, tc, proj = {}, {}, 768
    cfg_file = os.path.join(path, 'config.json')
    if os.path.isfile(cfg_file):
        with open(cfg_file) as f:
            c = json.load(f)
        vc = c.get('vision_config', {})
        tc = c.get('text_config', {})
        proj = c.get('projection_dim', 768)
    vision_cfg = CLIPVisionConfig(
        image_size=vc.get('image_size', 224),
        patch_size=vc.get('patch_size', 14),
        hidden_size=vc.get('hidden_size', 1024),
        num_layers=vc.get('num_hidden_layers', 24),
        num_heads=vc.get('num_attention_heads', 16),
        intermediate_size=vc.get('intermediate_size', 4096),
        projection_dim=proj)
    text_cfg = CLIPTextConfig(
        vocab_size=tc.get('vocab_size', 49408),
        hidden_size=tc.get('hidden_size', 768),
        num_layers=tc.get('num_hidden_layers', 12),
        num_heads=tc.get('num_attention_heads', 12),
        max_position_embeddings=tc.get('max_position_embeddings', 77),
        intermediate_size=tc.get('intermediate_size', 3072))
    model = CLIPWithProjection(vision_cfg, text_cfg)
    weights = next((os.path.join(path, n) for n in ('pytorch_model.bin',
                                                    'model.bin')
                    if os.path.isfile(os.path.join(path, n))), None)
    if weights is not None:
        missing, unused = converters.load_normalized(
            model, converters.load_torch_file(weights),
            key_map=converters.clip_full_key_unmap)
        if missing or unused:
            raise KeyError(f'{weights}: {len(missing)} missing keys '
                           f'{missing[:5]}, {len(unused)} unused keys '
                           f'{unused[:5]}')
        logger.info(f'loaded CLIP scorer weights from {weights}')
    else:
        init_weights(model, torch.Generator().manual_seed(0))
        logger.warning(f'no CLIP weights at {path}; the scorer is '
                       'random-init (a run without checkpoints: its scores '
                       'are not comparable across runs)')
    device = torch.device('cuda' if device is None else device)
    return model.to(device).eval().requires_grad_(False)


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


_ATLAS_LAYER_KEY = re.compile(r'^hidden_(\d+)\.')
_REF_LAYER_KEY = re.compile(r'^hidden\.(\d+)\.')


def atlas_state_dict(nets: dict) -> dict:
    """The nets' weights as flat `<net>.<param>` keys under the reference
    IMLP's layer names (`hidden.<i>.weight`, `hidden.<i>.bias`,
    `hash_table`), fp32 on the CPU."""
    return {name + '.' + _ATLAS_LAYER_KEY.sub(r'hidden.\1.', k):
            v.detach().to('cpu', torch.float32)
            for name, net in nets.items()
            for k, v in net.state_dict().items()}


def save_atlas_checkpoint(path: str, nets: dict) -> None:
    """The atlas nets as one torch file (`atlas_state_dict`): what
    `load_atlas_checkpoint` and the JAX package's `.pth` branch of
    train_atlas.py `load_atlas_checkpoint` read."""
    _save_atomic(atlas_state_dict(nets), path)


def load_atlas_checkpoint(path: str, nets: dict) -> None:
    """An atlas checkpoint into `nets`, in place: flat `<net>.<param>`
    keys or `{net: state_dict}`, layer names `hidden.<i>` (the reference's)
    or `hidden_<i>` (the port's modules'). Raises on a missing or an unused
    key, and on a net of the file that `nets` lacks."""
    if not path.endswith('.pth'):
        raise NotImplementedError(
            f'{path}: only .pth atlas checkpoints load in the port (the JAX '
            'package\'s .msgpack needs flax)')
    sd = converters.load_torch_file(_file(path, 'atlas checkpoint'))
    per_net, unused = {}, []
    for key, value in sd.items():
        if isinstance(value, dict):
            name, sub = key, value
        else:
            name, _, rest = key.partition('.')
            sub = {rest: value}
        if name not in nets:
            unused += [f'{name}.{k}' for k in sub]
            continue
        for k, v in sub.items():
            per_net.setdefault(name, {})[
                _REF_LAYER_KEY.sub(r'hidden_\1.', k)] = v
    problems = [f'unused {k}' for k in unused]
    for name, net in nets.items():
        missing, extra = net.load_state_dict(per_net.get(name, {}),
                                             strict=False)
        problems += [f'missing {name}.{k}' for k in missing]
        problems += [f'unused {name}.{k}' for k in extra]
    if problems:
        raise KeyError(f'{path}: {len(problems)} keys do not match the atlas '
                       f'nets: {problems[:10]}')
