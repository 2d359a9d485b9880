"""Optical flow for the atlas stage: coarse-to-fine pyramidal Lucas-Kanade
and the bidirectional flow of a frame pair.

The counterpart of videoswap_tpu/preprocess/flow.py. Frames are (H, W, 3)
fp32 tensors in [0, 1]; everything runs on the frames' device in fp32:

- `_resize` is `jax.image.resize(..., 'bilinear')`, which antialiases when
  it downsamples (a triangle filter widened by the scale, renormalised at
  the border): `F.interpolate(..., antialias=True)`, which is the same
  filter, and plain half-pixel bilinear with clamped borders when it
  upsamples;
- the 5x5 blur of `_lk_refine` (`convolve2d`, zero-padded 'same') is an
  `avg_pool2d` that counts the padding, so no TF32 convolution can touch it.

`compute_bidirectional_flow` returns the reference's [2, H, W, 2] float32
(forward, backward). Its 'unimatch' method is the learned UniMatch model
(unimatch.py) on its published checkpoint, 'matching' the weight-free
global matching flow (matching_flow.py), 'lk' the pyramid alone; 'auto' is
'unimatch' where the checkpoint is on disk, else 'matching', as in the JAX
package.
"""

from __future__ import annotations

import contextlib
import glob
import os

import numpy as np
import torch
import torch.nn.functional as F

_GRAY = (0.299, 0.587, 0.114)


@contextlib.contextmanager
def fp32_math():
    """fp32 products and convolutions in full fp32 on the card (TF32 off),
    whatever the caller set."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def _gray(img: torch.Tensor) -> torch.Tensor:
    return img[..., 0] * _GRAY[0] + img[..., 1] * _GRAY[1] \
        + img[..., 2] * _GRAY[2]


def _resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(H, W), (H, W, C) or (N, H, W, C) -> the same at (h, w), bilinear,
    antialiased when downsampling (jax.image.resize's 'bilinear')."""
    x = img[..., None] if img.dim() == 2 else img
    x = x[None] if x.dim() == 3 else x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(h, w), mode='bilinear',
                      align_corners=False, antialias=True).permute(0, 2, 3, 1)
    if img.dim() == 2:
        return y[0, ..., 0]
    return y[0] if img.dim() == 3 else y


def _warp(img: torch.Tensor, flow: torch.Tensor) -> torch.Tensor:
    """img sampled at (x + u, y + v), bilinear, coordinates clamped to the
    image."""
    h, w = img.shape[:2]
    ys, xs = torch.meshgrid(torch.arange(h, device=img.device),
                            torch.arange(w, device=img.device), indexing='ij')
    cx = (xs + flow[..., 0]).clamp(0, w - 1)
    cy = (ys + flow[..., 1]).clamp(0, h - 1)
    x0 = torch.floor(cx).long()
    y0 = torch.floor(cy).long()
    x1 = (x0 + 1).clamp(max=w - 1)
    y1 = (y0 + 1).clamp(max=h - 1)
    fx = cx - x0
    fy = cy - y0
    return (img[y0, x0] * (1 - fx) * (1 - fy) + img[y0, x1] * fx * (1 - fy)
            + img[y1, x0] * (1 - fx) * fy + img[y1, x1] * fx * fy)


def box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """The mean over a k x k window of each 2-D map of x (..., H, W),
    zero-padded to the same size (`convolve2d(x, ones((k, k)) / k**2,
    mode='same')` for odd k), in fp32 sums."""
    y = F.avg_pool2d(x.reshape(-1, 1, *x.shape[-2:]), k, stride=1,
                     padding=k // 2, count_include_pad=True)
    return y.reshape(x.shape)


def _lk_refine(i0: torch.Tensor, i1: torch.Tensor, flow: torch.Tensor,
               iters: int, eps_rel: float = 0.05) -> torch.Tensor:
    """Iterative Lucas-Kanade updates over a 5x5 window, a
    gradient-scaled Tikhonov floor, and the flow field smoothed between
    updates (the JAX package's docstring says why the smoothing is
    needed). flow: (H, W, 2), or (N, H, W, 2) for N flows refined at once,
    each with the arithmetic it would have alone."""
    gx = torch.gradient(i1, dim=1)[0]
    gy = torch.gradient(i1, dim=0)[0]
    eps = eps_rel * torch.mean(gx * gx + gy * gy) + 1e-6
    for _ in range(iters):
        wx = _warp(gx, flow)
        wy = _warp(gy, flow)
        it = _warp(i1, flow) - i0
        a11 = box_filter(wx * wx, 5) + eps
        a12 = box_filter(wx * wy, 5)
        a22 = box_filter(wy * wy, 5) + eps
        b1 = box_filter(wx * it, 5)
        b2 = box_filter(wy * it, 5)
        det = a11 * a22 - a12 * a12
        du = (-(a22 * b1 - a12 * b2) / det).clamp(-1, 1)
        dv = (-(-a12 * b1 + a11 * b2) / det).clamp(-1, 1)
        f = flow + torch.stack([du, dv], dim=-1)
        flow = torch.stack([box_filter(f[..., 0], 5),
                            box_filter(f[..., 1], 5)], dim=-1)
    return flow


def _levels(h: int, w: int, levels: int) -> list[tuple[int, int]]:
    return [(max(h >> lv, 8), max(w >> lv, 8)) for lv in range(levels)]


LK_LEVELS = 4
LK_ITERS = 10


def pyramid_flow(img0: torch.Tensor, img1: torch.Tensor) -> torch.Tensor:
    """img0, img1: (H, W, 3). Returns the (H, W, 2) flow mapping img0's
    pixels to img1's, (x, y) order, on their device: LK_LEVELS levels of
    LK_ITERS iterations from a zero flow."""
    g0, g1 = _gray(img0.float()), _gray(img1.float())
    shapes = _levels(*g0.shape, LK_LEVELS)
    flow = g0.new_zeros(shapes[-1] + (2,))
    for lh, lw in reversed(shapes):
        scale = lh / flow.shape[0]
        flow = _resize(flow, lh, lw) * scale
        flow = _lk_refine(_resize(g0, lh, lw), _resize(g1, lh, lw), flow,
                          LK_ITERS)
    return flow


_UNIMATCH_CKPT_ENV = 'VS_UNIMATCH_CKPT'
_UNIMATCH_CKPT_DEFAULT = ('pretrained_models/'
                          'gmflow-scale2-regrefine6-mixdata.pth')


def find_unimatch_checkpoint() -> str | None:
    """A gmflow-scale2-regrefine6 checkpoint where the JAX package looks for
    one: $VS_UNIMATCH_CKPT, pretrained_models/, the reference's thirdparty
    path (relative to the working directory)."""
    cands = [os.environ.get(_UNIMATCH_CKPT_ENV, ''), _UNIMATCH_CKPT_DEFAULT]
    cands += sorted(glob.glob(
        'thirdparty/unimatch/pretrained/gmflow-scale2-regrefine6*.pth'))
    cands += sorted(glob.glob(
        'pretrained_models/gmflow-scale2-regrefine6*.pth'))
    for c in cands:
        if c and os.path.isfile(c):
            return c
    return None


def resolve_method(method: str) -> str:
    """The method the JAX package runs for `method`: 'auto' is 'unimatch'
    when its checkpoint is on disk, else 'matching'; 'unimatch' without a
    checkpoint raises FileNotFoundError."""
    if method == 'auto':
        return 'unimatch' if find_unimatch_checkpoint() else 'matching'
    if method == 'unimatch' and find_unimatch_checkpoint() is None:
        raise FileNotFoundError(
            'method=unimatch needs a gmflow-scale2-regrefine6 checkpoint '
            f'(set ${_UNIMATCH_CKPT_ENV} or place it under '
            'pretrained_models/)')
    if method not in ('unimatch', 'matching', 'lk'):
        raise ValueError(f'unknown flow method {method!r}')
    return method


def load_unimatch(device=None):
    """The UniMatch wrapper on the checkpoint `find_unimatch_checkpoint`
    finds, on `device` (None: 'cuda')."""
    from .unimatch import UniMatchWrapper
    resolve_method('unimatch')
    return UniMatchWrapper.from_checkpoint(find_unimatch_checkpoint(),
                                           device=device)


def _as_frame(frame, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(frame, np.float32)
                           if not isinstance(frame, torch.Tensor)
                           else frame).to(device=device, dtype=torch.float32)


def compute_bidirectional_flow(frame0, frame1, method: str = 'auto',
                               device=None, unimatch=None) -> np.ndarray:
    """[2, H, W, 2] float32: (forward frame0 -> frame1, backward frame1 ->
    frame0), the reference's .npy layout. Frames: (H, W, 3) in [0, 1]
    (numpy or tensors). device: None means 'cuda'. unimatch: a loaded
    UniMatch wrapper for the 'unimatch' method (else one is loaded)."""
    method = resolve_method(method)
    device = torch.device('cuda' if device is None else device)
    if method == 'unimatch':
        unimatch = unimatch or load_unimatch(device)
        return unimatch.compute_flow(frame0, frame1)
    f0, f1 = _as_frame(frame0, device), _as_frame(frame1, device)
    if method == 'matching':
        from .matching_flow import global_matching_flow
        fwd = global_matching_flow(f0, f1)
        bwd = global_matching_flow(f1, f0)
    else:
        fwd = pyramid_flow(f0, f1)
        bwd = pyramid_flow(f1, f0)
    return torch.stack([fwd, bwd]).cpu().numpy().astype(np.float32)

