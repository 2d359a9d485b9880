"""Attention router (the port of videoswap_tpu/ops/attention.py).

q, k, v enter with merged heads, (B, S, heads * d), and are routed by
shape, as the JAX package routes them under `impl='flash'`:

- self-attention over at most 32 tokens (the motion modules' frame axis)
  -> the temporal-attention kernel;
- every other site -> the flash-attention forward kernel, heads read
  through strides from the (B, S, H, d) view.

Each kernel's wrapper takes its plain version for CPU tensors.

`attention_with_probs` materialises the probabilities for prompt-to-prompt
control; it has no kernel.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from .flash_attention import flash_attention
from .temporal_attention import temporal_attention


def _split_heads(x: torch.Tensor, heads: int) -> torch.Tensor:
    b, s, d = x.shape
    return x.reshape(b, s, heads, d // heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, s, h, d = x.shape
    return x.reshape(b, s, h * d)


def _small_seq_attention(q, k, v, heads: int):
    el, f, c = q.shape
    out = temporal_attention(q.reshape(el * f, c), k.reshape(el * f, c),
                             v.reshape(el * f, c), heads, f)
    return out.reshape(el, f, c)


def dot_product_attention(q, k, v, heads: int):
    """q: (B, Sq, D), k/v: (B, Sk, D) -> (B, Sq, D)."""
    sq, sk = q.shape[1], k.shape[1]
    if sq == sk and sq <= 32:
        return _small_seq_attention(q, k, v, heads)
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    return _merge_heads(flash_attention(qh, kh, vh))


def attention_with_probs(
    q, k, v, heads: int,
    edit_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
):
    """Returns (out (B, Sq, D), probs (B, heads, Sq, Sk) before any edit)."""
    qh, kh, vh = (_split_heads(t, heads) for t in (q, k, v))
    scale = qh.shape[-1] ** -0.5
    logits = torch.einsum('bqhd,bkhd->bhqk', qh.float(), kh.float()) * scale
    probs = torch.softmax(logits, dim=-1)
    used = edit_fn(probs) if edit_fn is not None else probs
    out = torch.einsum('bhqk,bkhd->bqhd', used.to(v.dtype), vh)
    return _merge_heads(out), probs
