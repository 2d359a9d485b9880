"""Attention-map visualisation (the port of
videoswap_tpu/p2p/visualization.py): the stored cross-attention maps
averaged over sites and heads (`aggregate_attention`), a strip of per-token
heatmaps (`show_cross_attention`) and the top SVD components of the
self-attention maps (`show_self_attention_comp`), from a store {site name:
maps} rather than a live controller. PIL is imported where it draws.
"""

from __future__ import annotations

import os

import numpy as np


def _as_numpy(maps) -> np.ndarray:
    if hasattr(maps, 'detach'):
        return maps.detach().float().cpu().numpy()
    return np.asarray(maps)


def aggregate_attention(step_store: dict, res_y: int, res_x: int,
                        places=('up', 'down'), kind: str = 'cross',
                        frame: int = 0) -> np.ndarray:
    """The mean over the selected sites and heads of the maps at (res_y,
    res_x) tokens. step_store: {site name: (F, heads, S, T)}, or with a
    leading step axis, which is averaged. Returns (res_y, res_x, T)."""
    out = []
    for name, maps in step_store.items():
        place, k, _ = name.split('_')
        if k != kind or place not in places:
            continue
        m = _as_numpy(maps)
        if m.ndim == 5:                   # (steps, F, heads, S, T)
            m = m.mean(0)
        if m.shape[-2] != res_y * res_x:
            continue
        out.append(m[frame].mean(0))      # (S, T)
    if not out:
        raise ValueError(f'no {kind} maps at {res_y}x{res_x}')
    return np.stack(out).mean(0).reshape(res_y, res_x, -1)


def show_cross_attention(tokenizer, prompt: str, step_store: dict,
                         res_y: int, res_x: int, save_dir: str,
                         frame: int = 0, places=('up', 'down')) -> list:
    """One 256x256 heatmap a token, side by side in
    `save_dir/cross_attention.png`; returns the images."""
    from PIL import Image, ImageDraw
    attn = aggregate_attention(step_store, res_y, res_x, places, 'cross',
                               frame)
    if hasattr(tokenizer, 'encode'):
        ids = tokenizer.encode(prompt)
        decode = lambda i: tokenizer.decode([ids[i]])      # noqa: E731
        n_tokens = len(ids)
    else:
        words = ['<bos>'] + prompt.split(' ') + ['<eos>']
        decode = lambda i: words[i] if i < len(words) else ''  # noqa: E731
        n_tokens = len(words)

    images = []
    for i in range(min(n_tokens, attn.shape[-1])):
        m = attn[..., i]
        m = (m - m.min()) / (m.max() - m.min() + 1e-8)
        img = Image.fromarray((m * 255).astype(np.uint8)).resize(
            (256, 256), Image.BILINEAR).convert('RGB')
        draw = ImageDraw.Draw(img)
        draw.text((8, 232), decode(i), fill=(255, 80, 80))
        images.append(img)

    os.makedirs(save_dir, exist_ok=True)
    strip = Image.new('RGB', (256 * len(images), 256))
    for i, im in enumerate(images):
        strip.paste(im, (256 * i, 0))
    strip.save(os.path.join(save_dir, 'cross_attention.png'))
    return images


def show_self_attention_comp(step_store: dict, res_y: int, res_x: int,
                             save_dir: str, frame: int = 0,
                             max_com: int = 10) -> None:
    """The top SVD components of the self-attention matrix, one PNG
    each."""
    from PIL import Image
    attn = aggregate_attention(step_store, res_y, res_x, kind='self',
                               frame=frame)
    flat = attn.reshape(res_y * res_x, -1).astype(np.float64)
    u, s, vh = np.linalg.svd(flat - flat.mean(0, keepdims=True),
                             full_matrices=False)
    os.makedirs(save_dir, exist_ok=True)
    for i in range(min(max_com, vh.shape[0])):
        comp = vh[i].reshape(res_y, res_x)
        comp = (comp - comp.min()) / (comp.max() - comp.min() + 1e-8)
        Image.fromarray((comp * 255).astype(np.uint8)).resize(
            (256, 256), Image.BILINEAR).save(
            os.path.join(save_dir, f'self_svd_{i:02d}.png'))
