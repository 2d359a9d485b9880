"""Atlas evaluation: the reconstructed video and its PSNR.

The counterpart of videoswap_tpu/atlas/evaluate.py `reconstruct_video` and
the PSNR that `evaluate_model` reports. Every pixel of every frame goes
through the four nets in chunks on the nets' device. The loss videos,
texture and checkerboard renders, edit re-rendering and file writing are
not ported yet.
"""

from __future__ import annotations

import torch

from . import losses

_KEYS = ('rgb', 'fg', 'bg', 'alpha', 'uv_fg', 'uv_bg')


@torch.no_grad()
def reconstruct_video(nets: dict, res_x: int, res_y: int, num_frames: int,
                      norm_s, norm_t, chunk: int = 65536) -> dict:
    """Evaluate the atlas at every pixel of frames 0 .. num_frames - 1.
    Returns {'rgb', 'fg', 'bg', 'alpha', 'uv_fg', 'uv_bg'}: (F, H, W, C)
    fp32 tensors on the nets' device."""
    dev = nets['FG_UV_Mapping'].hidden_0.weight.device
    ys, xs = torch.meshgrid(torch.arange(res_y, device=dev),
                            torch.arange(res_x, device=dev), indexing='ij')
    # normalised in float64 and rounded once, as the JAX package's numpy
    sx = norm_s(xs.reshape(-1).double()).float()
    sy = norm_s(ys.reshape(-1).double()).float()
    out = {k: [] for k in _KEYS}
    for f in range(num_frames):
        rows = {k: [] for k in _KEYS}
        for i in range(0, res_x * res_y, chunk):
            n = min(chunk, res_x * res_y - i)
            xyt = torch.stack([sx[i:i + n], sy[i:i + n],
                               torch.full((n,), float(norm_t(f)),
                                          device=dev)], dim=-1)
            fg = nets['FG_UV_Mapping'](xyt)
            bg = nets['BG_UV_Mapping'](xyt)
            alpha = losses.scaled_alpha(nets['F_Alpha'](xyt))
            rgb, rgb_fg, rgb_bg = losses.reconstruct_rgb(fg, bg, alpha,
                                                         nets['F_Atlas'])
            for k, v in zip(_KEYS, (rgb, rgb_fg, rgb_bg, alpha, fg, bg)):
                rows[k].append(v)
        for k in _KEYS:
            out[k].append(torch.cat(rows[k]).reshape(res_y, res_x, -1))
    return {k: torch.stack(v) for k, v in out.items()}


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2)
    if float(mse) == 0:
        return float('inf')
    return float(10.0 * torch.log10(data_range ** 2 / mse))


def evaluate_model(nets: dict, video, res_x: int, res_y: int,
                   num_frames: int, norm_s, norm_t) -> float:
    """Reconstruction PSNR over frames 0 .. num_frames - 1 of `video`
    (F, H, W, 3) in [0, 1]."""
    rec = reconstruct_video(nets, res_x, res_y, num_frames, norm_s, norm_t)
    video = torch.as_tensor(video)[:num_frames].to(rec['rgb'].device)
    return psnr(rec['rgb'], video)
