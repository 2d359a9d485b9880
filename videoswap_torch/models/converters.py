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
`numpy.asarray` takes); this module imports nothing of JAX.

`clip_key_map` and `load_torch_file` are the helpers of
videoswap_tpu/models/converters.py that ED-LoRA loading needs.
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
