"""CLIP vision tower (ViT-L/14) and the whole CLIP scorer (the port of
videoswap_tpu/models/clip_vision.py): the measurement of CLIP(frame,
target prompt) beside the text tower of models/clip_text.py.

The encoder layers are the text tower's blocks (clip_text.CLIPEncoderLayer,
quick-gelu) without the causal mask. Parameter names follow the JAX
package's tree (`class_embedding`, `patch_embedding`, `position_embedding`,
`pre_layrnorm` [sic, transformers' own name], `layers.N...`,
`post_layernorm`), so `converters.jax_params_to_state_dict` carries its
weights over; a transformers CLIPModel file loads through
`converters.clip_full_key_unmap`. Plain PyTorch: the JAX package runs it on
XLA, with no kernel.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .clip_text import CLIPEncoderLayer, CLIPTextConfig, CLIPTextModel


class CLIPVisionConfig(NamedTuple):
    # ViT-L/14, the vision tower paired with SD-1.5's text tower
    image_size: int = 224
    patch_size: int = 14
    hidden_size: int = 1024
    num_layers: int = 24
    num_heads: int = 16
    intermediate_size: int = 4096
    layer_norm_eps: float = 1e-5
    projection_dim: int = 768


class CLIPVisionModel(nn.Module):
    def __init__(self, cfg: CLIPVisionConfig = CLIPVisionConfig()):
        super().__init__()
        self.cfg = cfg
        d = cfg.hidden_size
        self.patch_embedding = nn.Conv2d(3, d, cfg.patch_size,
                                         stride=cfg.patch_size, bias=False)
        self.class_embedding = nn.Parameter(torch.zeros(d))
        n_pos = (cfg.image_size // cfg.patch_size) ** 2 + 1
        self.position_embedding = nn.Embedding(n_pos, d)
        self.pre_layrnorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)
        self.layers = nn.ModuleList([CLIPEncoderLayer(cfg)
                                     for _ in range(cfg.num_layers)])
        self.post_layernorm = nn.LayerNorm(d, eps=cfg.layer_norm_eps)

    def forward(self, pixel_values: torch.Tensor):
        """pixel_values: [B, H, W, 3] channels-last, normalised. Returns
        (last_hidden_state [B, 1 + P, D], pooled [B, D]): pooled is the
        class token after post_layernorm, as in transformers."""
        w = self.patch_embedding.weight
        x = self.patch_embedding(pixel_values.permute(0, 3, 1, 2).to(w.dtype))
        b = x.shape[0]
        x = x.flatten(2).transpose(1, 2)                  # [B, P, D]
        cls = self.class_embedding.to(x.dtype).expand(b, 1, -1)
        x = torch.cat([cls, x], dim=1)
        x = x + self.position_embedding.weight[None, :x.shape[1]]
        x = self.pre_layrnorm(x)
        for layer in self.layers:
            x = layer(x)
        return x, self.post_layernorm(x[:, 0])


class CLIPWithProjection(nn.Module):
    """Both towers and the projection heads (bias-free): what the CLIP
    score needs."""

    def __init__(self, vision_cfg: CLIPVisionConfig = CLIPVisionConfig(),
                 text_cfg: Optional[CLIPTextConfig] = None):
        super().__init__()
        self.vision_cfg = vision_cfg
        self.text_cfg = text_cfg or CLIPTextConfig()
        self.text_model = CLIPTextModel(self.text_cfg)
        self.vision_model = CLIPVisionModel(vision_cfg)
        self.visual_projection = nn.Linear(
            vision_cfg.hidden_size, vision_cfg.projection_dim, bias=False)
        self.text_projection = nn.Linear(
            self.text_cfg.hidden_size, vision_cfg.projection_dim, bias=False)

    def image_embeds(self, pixel_values: torch.Tensor) -> torch.Tensor:
        _, pooled = self.vision_model(pixel_values)
        e = self.visual_projection(pooled)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    def text_embeds(self, input_ids: torch.Tensor) -> torch.Tensor:
        hidden = self.text_model(input_ids)
        # transformers' pooling: the EOT token has the highest id
        eot = input_ids.argmax(dim=-1)
        pooled = hidden[torch.arange(hidden.shape[0], device=hidden.device),
                        eot]
        e = self.text_projection(pooled)
        return e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)

    def forward(self, pixel_values, input_ids) -> torch.Tensor:
        """Per (image, text) pair: 100 * max(0, cosine), torchmetrics'
        CLIPScore."""
        img = self.image_embeds(pixel_values)
        txt = self.text_embeds(input_ids)
        return (img * txt).sum(-1).clamp_min(0.0) * 100.0


# openai CLIP preprocessing constants
CLIP_IMAGE_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_IMAGE_STD = (0.26862954, 0.26130258, 0.27577711)


def preprocess_frames(frames, image_size: int = 224,
                      device=None) -> torch.Tensor:
    """(F, H, W, 3) float frames in [0, 1] -> CLIP pixel_values [F, S, S,
    3] on `device` (the frames' own, for a tensor, else the CPU): the
    shortest side resized to S with the triangle filter (the JAX package's
    bilinear `jax.image.resize`, which widens the filter when it shrinks),
    a centre crop, the openai normalisation. The taps are float64 on the
    host, the products fp32 on the device."""
    from videoswap_torch.data.transforms import _triangle_taps
    v = torch.as_tensor(frames, dtype=torch.float32, device=device)
    f, h, w = v.shape[:3]
    scale = image_size / min(h, w)
    nh, nw = round(h * scale), round(w * scale)
    my, mx = (_triangle_taps(n, m).to(v.device, torch.float32)
              for n, m in ((h, nh), (w, nw)))
    v = torch.einsum('yh,fhwc->fywc', my, v)
    v = torch.einsum('xw,fywc->fyxc', mx, v)
    y0, x0 = (nh - image_size) // 2, (nw - image_size) // 2
    v = v[:, y0:y0 + image_size, x0:x0 + image_size]
    mean = torch.tensor(CLIP_IMAGE_MEAN, device=v.device)
    std = torch.tensor(CLIP_IMAGE_STD, device=v.device)
    return (v - mean) / std
