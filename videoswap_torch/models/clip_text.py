"""CLIP text encoder (the ViT-L/14 text tower of SD-1.5), the port of
videoswap_tpu/models/clip_text.py: 12 layers, width 768, 12 heads,
quick-gelu, causal mask, final LayerNorm. Plain PyTorch: the JAX package
runs it on XLA, with no kernel."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from videoswap_torch.utils.registry import MODEL_REGISTRY


class CLIPTextConfig(NamedTuple):
    vocab_size: int = 49408
    hidden_size: int = 768
    num_layers: int = 12
    num_heads: int = 12
    max_position_embeddings: int = 77
    intermediate_size: int = 3072
    layer_norm_eps: float = 1e-5


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class CLIPAttention(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        d = cfg.hidden_size
        self.heads = cfg.num_heads
        self.q_proj = nn.Linear(d, d)
        self.k_proj = nn.Linear(d, d)
        self.v_proj = nn.Linear(d, d)
        self.out_proj = nn.Linear(d, d)

    def forward(self, x, causal_mask=None):
        b, s, d = x.shape
        dh = d // self.heads
        q = self.q_proj(x) * dh ** -0.5
        q, k, v = (t.reshape(b, s, self.heads, dh).transpose(1, 2)
                   for t in (q, self.k_proj(x), self.v_proj(x)))
        logits = torch.einsum('bhqd,bhkd->bhqk', q.float(), k.float())
        if causal_mask is not None:
            logits = logits.masked_fill(~causal_mask, -1e9)
        probs = torch.softmax(logits, dim=-1).to(v.dtype)
        out = torch.einsum('bhqk,bhkd->bhqd', probs, v)
        return self.out_proj(out.transpose(1, 2).reshape(b, s, d))


class CLIPMLP(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.fc1 = nn.Linear(cfg.hidden_size, cfg.intermediate_size)
        self.fc2 = nn.Linear(cfg.intermediate_size, cfg.hidden_size)

    def forward(self, x):
        return self.fc2(quick_gelu(self.fc1(x)))


class CLIPEncoderLayer(nn.Module):
    def __init__(self, cfg: CLIPTextConfig):
        super().__init__()
        self.layer_norm1 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps)
        self.self_attn = CLIPAttention(cfg)
        self.layer_norm2 = nn.LayerNorm(cfg.hidden_size,
                                        eps=cfg.layer_norm_eps)
        self.mlp = CLIPMLP(cfg)

    def forward(self, x, causal_mask=None):
        x = x + self.self_attn(self.layer_norm1(x), causal_mask)
        return x + self.mlp(self.layer_norm2(x))


@MODEL_REGISTRY.register()
class CLIPTextModel(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embedding = nn.Embedding(cfg.max_position_embeddings,
                                               cfg.hidden_size)
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])
        self.final_layer_norm = nn.LayerNorm(cfg.hidden_size,
                                             eps=cfg.layer_norm_eps)

    def forward(self, input_ids: torch.Tensor,
                extra_token_embeds: Optional[torch.Tensor] = None):
        """input_ids: [B, S] -> last_hidden_state [B, S, hidden].
        `extra_token_embeds` ([N, hidden]) extends the vocabulary (ids >=
        vocab_size), as ED-LoRA concept tokens do."""
        table = self.token_embedding.weight
        if extra_token_embeds is not None:
            table = torch.cat([table, extra_token_embeds.to(table.dtype)])
        s = input_ids.shape[1]
        x = table[input_ids.long()] + self.position_embedding.weight[None, :s]
        causal = torch.ones((s, s), dtype=torch.bool,
                            device=x.device).tril()[None, None]
        for layer in self.layers:
            x = layer(x, causal)
        return self.final_layer_norm(x)
