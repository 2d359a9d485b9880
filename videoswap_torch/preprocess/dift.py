"""DIFT (diffusion features) and their cosine correspondence: the port of
videoswap_tpu/preprocess/dift.py.

`SDFeaturizer.forward` runs the video U-Net once on a frame's VAE latent
(the posterior's mean) repeated `ensemble_size` times on the frame axis,
each copy noised to DIFT_T with its own draw, under the text 'photo of a
{category}', and returns the ensemble mean of the U-Net's TAP output
(`up_block_1`: 1280 channels, 1/16 of the frame). The noise is drawn from
a CPU generator seeded with NOISE_SEED anew at each call, so that every
frame gets the same draw, as the JAX package's `PRNGKey(0)` does at each
call, and the card the CPU's (a CUDA generator draws other numbers); the
two packages' generators differ by design, so a caller that needs the JAX
draw passes it as `noise`.

`_resize_feat` is `jax.image.resize(..., 'bilinear')`: half-pixel centres,
antialiased when it downsamples (flow.py `_resize`). `resize_weights` and
`feature_at` give the resized map's vector at chosen pixels alone, the same
numbers without the (H, W, 1280) map. `dift_query` reads the two maps at
the two pixels alone where it is given a target pixel, and resizes the
target's whole map only to search for the best match.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

import numpy as np
import torch

from .flow import _resize

DIFT_T = 261            # the timestep the latent is noised to
TAP = 'up_block_1'      # the U-Net's output the features are read from
NOISE_SEED = 0          # every call's draw (the JAX package's PRNGKey(0))


@dataclass
class SDFeaturizer:
    unet: Any
    vae: Any
    text_encoder: Any
    tokenizer: Any
    sched: Any
    ensemble_size: int = 8
    _text: dict = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.unet.conv_in.weight.device

    def _encode_text(self, prompt: str) -> torch.Tensor:
        if prompt not in self._text:
            ids = self.tokenizer(
                [prompt], padding='max_length',
                max_length=self.tokenizer.model_max_length,
                truncation=True).input_ids
            ids = torch.as_tensor(np.asarray(ids), device=self.device)
            self._text[prompt] = self.text_encoder(ids)
        return self._text[prompt]

    def noise_shape(self, image_hw: tuple[int, int]) -> tuple:
        """The shape of the draw `forward` adds to the latent: (1,
        ensemble_size, h, w, 4), the latent's (the VAE's padding sets h
        and w)."""
        h, w = image_hw
        with torch.no_grad():
            z = self.vae.encode_video(torch.zeros(
                (1, 1, h, w, 3), device=self.device,
                dtype=self.vae._dtype()))
        return (1, self.ensemble_size) + tuple(z.shape[2:])

    @torch.no_grad()
    def forward(self, image, prompt: str,
                noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """image: (H, W, 3) in [-1, 1] -> the (h, w, 1280) fp32 feature map,
        on the models' device. noise: the (1, ensemble, h, w, 4) draw to add
        (default: a normal draw from a CPU generator seeded with
        NOISE_SEED)."""
        dev = self.device
        dtype = self.unet.conv_in.weight.dtype
        img = torch.as_tensor(np.asarray(image, np.float32)
                              if not isinstance(image, torch.Tensor)
                              else image)
        img = img.to(dev, self.vae._dtype())[None, None]
        latents = self.vae.encode_video(img).float()
        lat = latents.repeat_interleave(self.ensemble_size, dim=1)
        if noise is None:
            gen = torch.Generator().manual_seed(NOISE_SEED)
            noise = torch.randn(lat.shape, generator=gen)
        from videoswap_torch.schedulers.ddim import add_noise
        t = torch.tensor([DIFT_T], device=dev)
        noisy = add_noise(self.sched, lat, noise.to(dev, torch.float32), t)
        ft = self.unet(noisy.to(dtype), t, self._encode_text(prompt),
                       features=[TAP])[TAP]
        return ft[0].float().mean(dim=0)


def _resize_feat(feat, h: int, w: int) -> torch.Tensor:
    """(fh, fw, C) -> (h, w, C), bilinear (jax.image.resize's)."""
    return _resize(torch.as_tensor(feat).float(), h, w)


def resize_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_out, n_in): the weights of `_resize_feat` along one axis (each
    output row's weights over the input rows), read off the same filter
    applied to an identity."""
    # each row of the identity an image two columns wide: with one column,
    # PyTorch's antialiased kernel on the CPU returns zeros past the input
    eye = torch.eye(n_in, device=device)[:, None, :, None].expand(
        n_in, 1, n_in, 2).contiguous()
    return torch.nn.functional.interpolate(
        eye, size=(n_out, 2), mode='bilinear', align_corners=False,
        antialias=True)[:, 0, :, 0].T


def feature_at(feat, hw: tuple[int, int], ys, xs) -> torch.Tensor:
    """`_resize_feat(feat, *hw)[ys, xs]` (integer pixel indices, any equal
    shapes) without the resized map: (..., C)."""
    feat = torch.as_tensor(feat).float()
    fh, fw = feat.shape[:2]
    wy = resize_weights(fh, hw[0], feat.device)
    wx = resize_weights(fw, hw[1], feat.device)
    ys = torch.as_tensor(ys, device=feat.device).long()
    xs = torch.as_tensor(xs, device=feat.device).long()
    rows = torch.einsum('ni,ijc->njc', wy[ys.reshape(-1)], feat)
    out = torch.einsum('nj,njc->nc', wx[xs.reshape(-1)], rows)
    return out.reshape(*ys.shape, feat.shape[-1])


def _pixel(xy, w: int, h: int) -> tuple[int, int]:
    x, y = int(round(xy[0])), int(round(xy[1]))
    return int(np.clip(x, 0, w - 1)), int(np.clip(y, 0, h - 1))


def cosine(a: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., C) against (C,): the reference query's cosine (its 1e-8 on the
    product of the norms)."""
    return (a @ v) / (torch.linalg.norm(a, dim=-1) * torch.linalg.norm(v)
                      + 1e-8)


def dift_query(source_feat, source_hw: tuple[int, int],
               query_xy: tuple[float, float], target_feat,
               target_hw: tuple[int, int],
               target_xy: tuple[float, float] | None = None):
    """Cosine-similarity correspondence (reference DIFT_Demo.query): (the
    (x, y) of the best match, the cosine at `target_xy` or at the best
    match, the target's vector there (numpy)). Given `target_xy`, the two
    pixels are read alone and the best match is not searched (None)."""
    h, w = source_hw
    th, tw = target_hw
    sx, sy = _pixel(query_xy, w, h)
    vec = feature_at(source_feat, source_hw, sy, sx)
    if target_xy is not None:
        tx, ty = _pixel(target_xy, tw, th)
        tvec = feature_at(target_feat, target_hw, ty, tx)
        return None, float(cosine(tvec, vec)), tvec.cpu().numpy()
    tgt = _resize_feat(target_feat, th, tw)
    sims = cosine(tgt, vec)
    by, bx = divmod(int(torch.argmax(sims.reshape(-1))), tw)
    return (bx, by), float(sims[by, bx]), tgt[by, bx].cpu().numpy()
