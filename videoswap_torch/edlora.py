"""ED-LoRA (Mix-of-Show) concept loading at swap time (the port of
videoswap_tpu/edlora.py).

An ED-LoRA checkpoint carries {new_concept_embedding: {name: [16, D]},
unet: LoRA state dict, text_encoder: LoRA state dict} (possibly under
'params'). Loading it for one swap:

1. registers `<name_i>` tokens (16 per concept) in the tokenizer and
   appends their embeddings as extra rows of the text encoder's table
   (`extra_token_embeds`; the module is not resized);
2. merges `W += alpha * up @ down` into every eligible U-Net and
   text-encoder weight the file has a LoRA for, in place, keeping the
   original weights on their device for `restore_pipeline` (and for the
   recompute-self tier, which regenerates the inversion's maps with them);
3. prompts expand into 16 per-layer variants and encode to (B, 16, 77, D);
   each U-Net cross-attention layer takes its slice by `cross_layer_idx`.

Weights are matched by their state-dict keys (the port's modules carry the
diffusers and transformers names), so no flax transposes are involved.
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from videoswap_torch.models import converters

NUM_EDLORA_LAYERS = 16

# module names eligible for a LoRA (the layer set the reference merges)
_UNET_LORA = ('to_q', 'to_k', 'to_v', 'to_out.0', 'net.0.proj', 'net.2',
              'proj_in', 'proj_out')
_TEXT_LORA = ('q_proj', 'k_proj', 'v_proj', 'out_proj', 'mlp.fc1', 'mlp.fc2')

log = logging.getLogger(__name__)


def bind_concept_prompt(prompts, new_concept_cfg) -> list[str]:
    """One prompt -> 16 layer variants with per-layer concept tokens
    (reference edlora_util.py:102-113)."""
    if isinstance(prompts, str):
        prompts = [prompts]
    out = []
    for prompt in prompts:
        layered = [prompt] * NUM_EDLORA_LAYERS
        for concept_name, cfg in new_concept_cfg.items():
            layered = [p.replace(concept_name, tok)
                       for p, tok in zip(layered,
                                         cfg['concept_token_names'])]
        out.extend(layered)
    return out


def load_new_concept(pipeline, new_concept_embedding: dict,
                     enable_edlora: bool = True) -> dict:
    """Register the concept tokens and append their embedding rows."""
    new_concept_cfg = {}
    dev = pipeline.device
    extra = ([] if pipeline.extra_token_embeds is None
             else [pipeline.extra_token_embeds])
    for concept_name, emb in new_concept_embedding.items():
        n = NUM_EDLORA_LAYERS if enable_edlora else 1
        token_names = [f'<{concept_name}_{i}>' for i in range(n)]
        pipeline.tokenizer.add_tokens(token_names)
        token_ids = [pipeline.tokenizer.convert_tokens_to_ids(t)
                     for t in token_names]
        extra.append(torch.as_tensor(emb).float().reshape(n, -1).to(dev))
        new_concept_cfg[concept_name] = {
            'concept_token_ids': token_ids,
            'concept_token_names': token_names,
        }
    pipeline.extra_token_embeds = torch.cat(extra)
    return new_concept_cfg


def _eligible(key: str, names) -> bool:
    if not key.endswith('.weight'):
        return False
    mod = key[:-len('.weight')]
    return any(mod == n or mod.endswith('.' + n) for n in names)


def merge_lora_into_params(params: dict, lora_sd: dict, model_type: str,
                           alpha: float, key_map=None,
                           slicers=None) -> tuple[dict, int]:
    """params: {state-dict key: weight}. Returns ({key: W + alpha * up @
    down} for every eligible weight `lora_sd` has a LoRA for, count); the
    sum is taken in fp32 and rounded once to W's dtype. `slicers` {key:
    full -> local} cut the deltas of a tensor-parallel U-Net's weights to
    this rank's shards (`parallel.sharding.shard_unet`)."""
    eligible = _UNET_LORA if model_type == 'unet' else _TEXT_LORA
    out = {}
    for key, w in params.items():
        if not _eligible(key, eligible):
            continue
        k = key_map(key) if key_map is not None else key
        up_key = k.replace('.weight', '.lora_up.weight')
        if up_key not in lora_sd:
            continue
        down = torch.as_tensor(lora_sd[k.replace('.weight',
                                                 '.lora_down.weight')])
        up = torch.as_tensor(lora_sd[up_key])
        delta = (up.reshape(up.shape[0], -1).float()
                 @ down.reshape(down.shape[0], -1).float())       # [O, I]
        delta = delta.reshape(*delta.shape, *(1,) * (w.dim() - 2))
        if slicers and key in slicers:
            delta = slicers[key](delta)
        out[key] = (w.float() + alpha * delta.to(w.device)).to(w.dtype)
    return out, len(out)


@torch.no_grad()
def _merge_into(module, lora_sd, model_type, alpha, key_map=None) -> dict:
    """Merge in place; returns the original weights of what changed."""
    params = dict(module.named_parameters())
    merged, n = merge_lora_into_params(params, lora_sd, model_type, alpha,
                                       key_map,
                                       getattr(module, 'tp_slicers', None))
    saved = {}
    for key, w in merged.items():
        saved[key] = params[key].detach().clone()
        params[key].copy_(w)
    log.info('merged %d %s LoRAs (alpha=%s)', n, model_type, alpha)
    return saved


def convert_edlora(pipeline, state_dict: dict, enable_edlora: bool,
                   alpha: float = 0.6) -> tuple[dict | None, dict]:
    """Merge an ED-LoRA checkpoint into the pipeline's models (reference
    convert_edlora). Returns (new_concept_cfg or None, {'unet': originals,
    'text_encoder': originals})."""
    if 'params' in state_dict:
        state_dict = state_dict['params']
    new_concept_cfg = None
    if state_dict.get('new_concept_embedding'):
        new_concept_cfg = load_new_concept(
            pipeline, state_dict['new_concept_embedding'], enable_edlora)
    saved = {'unet': {}, 'text_encoder': {}}
    if 'unet' in state_dict:
        saved['unet'] = _merge_into(pipeline.unet, state_dict['unet'], 'unet',
                                    alpha)
    if 'text_encoder' in state_dict:
        saved['text_encoder'] = _merge_into(
            pipeline.text_encoder, state_dict['text_encoder'],
            'text_encoder', alpha, key_map=converters.clip_key_map)
    return new_concept_cfg, saved


def load_edlora_into_pipeline(pipeline, path: str, alpha: float) -> dict:
    """Load a concept for one swap; returns the context `restore_pipeline`
    takes (reference pipeline_videoswap.py:312-320)."""
    ctx = {
        'extra_token_embeds': pipeline.extra_token_embeds,
        'new_concept_cfg': pipeline.new_concept_cfg,
        'tok_cfg': getattr(pipeline.tokenizer, 'new_concept_cfg', None),
    }
    enable_edlora = 'edlora' in path
    new_concept_cfg, saved = convert_edlora(
        pipeline, converters.load_torch_file(path), enable_edlora, alpha)
    ctx.update(saved)
    if enable_edlora and new_concept_cfg:
        pipeline.new_concept_cfg = new_concept_cfg
        pipeline.tokenizer.new_concept_cfg = new_concept_cfg
    return ctx


@torch.no_grad()
def restore_pipeline(pipeline, ctx: dict) -> None:
    """Put the pre-merge weights back, in place, and the text state."""
    for name in ('unet', 'text_encoder'):
        module = getattr(pipeline, name)
        for key, w in ctx[name].items():
            module.get_parameter(key).copy_(w)
    pipeline.extra_token_embeds = ctx['extra_token_embeds']
    pipeline.new_concept_cfg = ctx['new_concept_cfg']
    pipeline.tokenizer.new_concept_cfg = ctx['tok_cfg']


def apply_new_concept_cfg(pipeline, new_concept_cfg: dict) -> None:
    """Persistent concepts from a `new_concept_cfg.json` (reference
    test.py:82-86): the token names are registered, nothing else; their
    embeddings must be in the text encoder's checkpoint or come with an
    ED-LoRA file."""
    pipeline.new_concept_cfg = new_concept_cfg
    pipeline.tokenizer.new_concept_cfg = new_concept_cfg
    for cfg in new_concept_cfg.values():
        pipeline.tokenizer.add_tokens(cfg['concept_token_names'])


@torch.no_grad()
def encode_edlora_prompt(pipeline, prompts: list[str]) -> torch.Tensor:
    """(B, 16, 77, D) layer-wise embeddings: every prompt expands to its 16
    layer variants (concept-free prompts to 16 equal rows, which covers the
    reference's tiling of the negative prompt)."""
    expanded = bind_concept_prompt(prompts, pipeline.new_concept_cfg)
    ids = pipeline.tokenizer(
        expanded, padding='max_length',
        max_length=pipeline.tokenizer.model_max_length,
        truncation=True).input_ids
    ids = torch.as_tensor(np.asarray(ids), device=pipeline.device)
    emb = pipeline.text_encoder(ids,
                                extra_token_embeds=pipeline.extra_token_embeds)
    return emb.reshape(len(prompts), NUM_EDLORA_LAYERS, *emb.shape[1:])
