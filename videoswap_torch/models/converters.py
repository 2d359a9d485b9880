"""Weight bridge: JAX (flax) parameter trees -> the port's `state_dict`.

Every flax parameter path maps to its diffusers / transformers key by the
rule of videoswap_tpu/models/converters.py `flax_path_to_torch_key`
(`resnets_0` -> `resnets.0`, `to_out_0` -> `to_out.0`, `kernel`/`scale` ->
`weight`, the `InflatedConv` level `conv2d` dropped), and the port's
submodules carry exactly those keys, so the mapping needs no table. Tensors
are transposed by rank: Dense (I, O) -> Linear (O, I); Conv (kh, kw, I, O)
-> Conv2d (O, I, kh, kw); norm scales, biases and embeddings as they are.
The atlas IMLPs keep their `hidden_{i}` layer names (the port's modules
carry the same attribute names) and their 3-D `hash_table` as it is.

The input is a nested mapping of array-likes (numpy arrays, or anything
`numpy.asarray` takes); this module imports nothing of JAX. An optax
AdamW state carries over the same way (`optax_adam_state_to_torch`), so
that a run trained in the JAX package continues in the port.

Checkpoint files (videoswap_tpu/models/converters.py's families: the
diffusers SD-1.5 directory, AnimateDiff's `mm_sd_v14.ckpt`, the trained
adapter's `.pth`, ED-LoRA files, a CLIP scorer's transformers CLIPModel
`pytorch_model.bin`) carry the same diffusers and transformers keys, so
loading one is a key normalisation (`merge_motion_module`,
`normalize_vae_keys`, `clip_key_unmap`, `clip_full_key_unmap`) and a
`load_state_dict` (`load_normalized`), which reports the missing and unused
keys as the JAX package's non-strict conversion logs them. The ED-LoRA
trainer's parameters have one layout in both packages
(`edlora_train_params_from_jax`).
"""

from __future__ import annotations

import re
from collections.abc import Mapping

import numpy as np
import torch

_SPECIAL_SUBS = {
    'net_0_proj': 'net.0.proj',
    'net_2': 'net.2',
    'to_out_0': 'to_out.0',
    'mlp_fc1': 'mlp.fc1',
    'mlp_fc2': 'mlp.fc2',
    'mid_block_resnets_0': 'mid_block.resnets.0',
    'mid_block_resnets_1': 'mid_block.resnets.1',
    'mid_block_attentions_0': 'mid_block.attentions.0',
}
_LITERAL_NAMES = {'linear_1', 'linear_2'}    # trailing _digit is literal
_ATLAS_LAYER = re.compile(r'hidden_\d+')      # the atlas IMLP's Dense layers
_EMBED_LEAVES = ('token_embedding', 'position_embedding')
# deprecated diffusers VAE AttentionBlock keys (pre-0.18 exports, e.g. the
# chilloutmix dump) -> the modern Attention keys the port's VAE carries
_VAE_LEGACY_ATTN = {'.query.': '.to_q.', '.key.': '.to_k.',
                    '.value.': '.to_v.', '.proj_attn.': '.to_out.0.'}
# keys a checkpoint may carry that no module loads: the motion modules'
# sinusoidal tables (computed, not stored), CLIP's position-id buffer and
# logit scale, BatchNorm counters (the JAX package's conversion skips the
# same)
_IGNORED_SUFFIXES = ('.pe', 'position_ids', 'num_batches_tracked',
                     'logit_scale')


def flax_path_to_torch_key(path: tuple[str, ...]) -> str:
    parts = []
    for comp in path:
        if comp == 'conv2d':          # InflatedConv wrapper level
            continue
        if comp in _SPECIAL_SUBS:
            parts.append(_SPECIAL_SUBS[comp])
        elif comp in _LITERAL_NAMES or _ATLAS_LAYER.fullmatch(comp):
            parts.append(comp)
        else:
            parts.append(re.sub(r'_(\d+)(_|$)', r'.\1.', comp).rstrip('.'))
    key = '.'.join(parts)
    key = re.sub(r'\.(kernel|scale)$', '.weight', key)
    if key.endswith(_EMBED_LEAVES):
        key += '.weight'
    return key


def _flatten(tree: Mapping, prefix=()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, prefix + (str(k),))
        else:
            yield prefix + (str(k),), v


def jax_params_to_state_dict(params: Mapping) -> dict[str, torch.Tensor]:
    """flax variables ({'params': {...}, ...}; other collections are
    ignored) or the params tree itself -> {key: fp32 tensor} for
    `module.load_state_dict(..., strict=True)`."""
    if isinstance(params.get('params'), Mapping):
        params = params['params']
    out = {}
    for path, leaf in _flatten(params):
        t = np.asarray(leaf, dtype=np.float32)
        if path[-1] == 'kernel':
            t = t.T if t.ndim == 2 else t.transpose(3, 2, 0, 1)
        key = flax_path_to_torch_key(path)
        if key in out:
            raise KeyError(f'two flax paths map to {key}')
        out[key] = torch.from_numpy(np.ascontiguousarray(t))
    return out


def optax_adam_state_to_torch(mu: Mapping, nu: Mapping, count,
                              module: torch.nn.Module,
                              optimizer: torch.optim.Optimizer) -> None:
    """An optax `adamw` state (its ScaleByAdamState's `mu`, `nu` and
    `count`, numpy, in `module`'s flax param tree) into `optimizer`'s
    state, a `torch.optim.AdamW` over `module.parameters()`: `exp_avg`,
    `exp_avg_sq`, and `step` = `count` (the updates already applied; both
    bias-correct the next update with step + 1). The two updates are then
    the same arithmetic: with eps_root 0, optax's m^ / (sqrt(v^) + eps) +
    wd p is torch's m^ / (sqrt(v) / sqrt(1 - b2^t) + eps) + wd p."""
    exp_avg, exp_avg_sq = (jax_params_to_state_dict(t) for t in (mu, nu))
    params = dict(module.named_parameters())
    if set(exp_avg) != set(params) or set(exp_avg_sq) != set(params):
        raise KeyError('the optax state\'s tree does not name the module\'s '
                       f'parameters: {sorted(set(exp_avg) ^ set(params))}')
    step = float(np.asarray(count))
    for name, p in params.items():
        optimizer.state[p] = {
            'step': torch.tensor(step, dtype=torch.float32),
            'exp_avg': exp_avg[name].to(p.device, p.dtype),
            'exp_avg_sq': exp_avg_sq[name].to(p.device, p.dtype)}


def clip_key_map(key: str) -> str:
    """The text encoder's key ('layers.0.self_attn.q_proj.weight') ->
    the transformers key ('text_model.encoder.layers.0...'), as ED-LoRA
    files name the text encoder's weights."""
    if key.startswith(_EMBED_LEAVES):
        return 'text_model.embeddings.' + key
    if key.startswith('layers.'):
        return 'text_model.encoder.' + key
    return 'text_model.' + key


def load_torch_file(path: str) -> dict:
    """A torch checkpoint (tensors in nested dicts) on the CPU; a
    'state_dict' wrapper is unwrapped."""
    sd = torch.load(path, map_location='cpu', weights_only=True)
    if isinstance(sd, dict) and 'state_dict' in sd:
        sd = sd['state_dict']
    return sd


def clip_key_unmap(key: str) -> str:
    """The inverse of `clip_key_map`: a transformers text-encoder key
    ('text_model.encoder.layers.0...') -> the port's ('layers.0...')."""
    for prefix in ('text_model.embeddings.', 'text_model.encoder.',
                   'text_model.'):
        if key.startswith(prefix):
            return key[len(prefix):]
    return key


_VISION_EMBED_PREFIXES = ('vision_model.embeddings.',
                          'vision_model.encoder.')


def clip_full_key_unmap(key: str) -> str:
    """A transformers CLIPModel key -> the port's CLIPWithProjection key:
    the text tower's through `clip_key_unmap` under 'text_model.', the
    vision tower's with its 'embeddings.' and 'encoder.' levels dropped,
    the projections as they are."""
    if key.startswith('text_model.'):
        return 'text_model.' + clip_key_unmap(key)
    for prefix in _VISION_EMBED_PREFIXES:
        if key.startswith(prefix):
            return 'vision_model.' + key[len(prefix):]
    return key


def edlora_train_params_from_jax(train_params: Mapping) -> dict:
    """The JAX package's ED-LoRA train params ({'concept_emb': {name:
    [16, D]}, 'unet_lora' / 'text_lora': {torch key: {'down': [r, I],
    'up': [O, r]}}}, numpy or JAX arrays) as fp32 tensors: the layout is
    the same in both packages."""
    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.float32))
    return {'concept_emb': {k: t(v) for k, v in
                            train_params['concept_emb'].items()},
            **{part: {key: {'down': t(p['down']), 'up': t(p['up'])}
                      for key, p in train_params[part].items()}
               for part in ('unet_lora', 'text_lora')}}


def merge_motion_module(unet_sd: dict, motion_sd: dict) -> dict:
    """The SD-1.5 U-Net's state dict with AnimateDiff's motion-module state
    dict merged in (its keys name the 3-D U-Net's motion modules)."""
    return {**unet_sd, **motion_sd}


def normalize_vae_keys(sd: dict) -> dict:
    """The deprecated VAE attention keys (query, key, value, proj_attn)
    renamed to the modern ones; modern dicts pass through unchanged."""
    out = {}
    for k, v in sd.items():
        if 'attentions' in k:
            for old, new in _VAE_LEGACY_ATTN.items():
                if old in k:
                    k = k.replace(old, new)
                    break
        out[k] = v
    return out


def load_normalized(module: torch.nn.Module, sd: dict,
                    key_map=None) -> tuple[list[str], list[str]]:
    """Load a checkpoint's normalised state dict into `module` (each tensor
    cast to the module's dtype on its device). `key_map` renames the
    file's keys to the module's. Returns (missing, unused): the module's
    keys the file lacks, which keep their values, and the file's keys the
    module has no place for (the ignored suffixes apart). A shape that
    differs raises."""
    own = module.state_dict()
    found, unused = {}, []
    for k, v in sd.items():
        key = key_map(k) if key_map else k
        if key in own:
            if tuple(v.shape) != tuple(own[key].shape):
                raise ValueError(f'{k}: shape {tuple(v.shape)} in the file, '
                                 f'{tuple(own[key].shape)} in the model')
            found[key] = v
        elif not key.endswith(_IGNORED_SUFFIXES):
            unused.append(k)
    missing = [k for k in own if k not in found]
    module.load_state_dict(found, strict=False)
    return missing, unused
