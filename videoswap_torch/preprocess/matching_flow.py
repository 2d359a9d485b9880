"""Global-correlation matching flow, weight-free (a GMFlow-class algorithm).

The counterpart of videoswap_tpu/preprocess/matching_flow.py, whose
docstring gives the algorithm and its measurements: dense NCC patch
descriptors at stride 8, one global correlation product, argmax matching
with a forward-backward cycle check, confidence-weighted self-attention
propagation, pyramidal LK refinement from the matched flow, and a per-pixel
choice among that, the zero-init LK pyramid and LK refinements of the top
FFT phase-correlation shifts, by smoothed warp error.

Frames are (H, W, 3) fp32 tensors; everything runs on their device in
fp32. Two places where a natural PyTorch port leaves the JAX package:

- ties: `torch.argmax` / `argmin` return the first extremum, as `jnp`'s
  do (the correlation matches, the cycle check, the candidate choice);
- TF32: the correlation and attention products run with TF32 off
  (flow.py `fp32_math`), and the 7x7 box filter of `_photometric_select` is an
  `avg_pool2d` (flow.py `box_filter`), fp32 sums that no TF32 setting
  reaches: TF32 there changes which candidate wins.

`global_matching_flow` takes external features as `feat0` / `feat1`, for
example `dift_features` (diffusion features, dift.py).
"""

from __future__ import annotations

import torch

from .flow import (_gray, _levels, _lk_refine, _resize, _warp, box_filter,
                   fp32_math, pyramid_flow)

# the JAX package's defaults, which every caller uses: descriptors at
# stride 8, LK refinement of each candidate over the 2 finest levels at 10
# iterations, the zero-init LK pyramid fused in, 2 phase-correlation shifts
STRIDE = 8
REFINE_LEVELS = 2
REFINE_ITERS = 10
PHASE_CANDIDATES = 2


def _grid_coords(gh: int, gw: int, stride: int,
                 device=None) -> torch.Tensor:
    """(gh*gw, 2) patch-centre coordinates in image pixels, (x, y)."""
    ys, xs = torch.meshgrid(torch.arange(gh, device=device),
                            torch.arange(gw, device=device), indexing='ij')
    c = (stride - 1) / 2.0
    return torch.stack([xs * stride + c, ys * stride + c],
                       dim=-1).reshape(-1, 2).float()


def patch_features(img: torch.Tensor, stride: int = 8,
                   patch: int = 11) -> torch.Tensor:
    """(H, W, 3) -> (H//stride, W//stride, 3*patch*patch): mean-subtracted,
    contrast-normalised RGB patches (channel-major, then rows, then
    columns), centred on pixel i*stride + (stride-1)//2 of the
    edge-padded image."""
    img = img.float()
    h, w, _ = img.shape
    gh, gw = h // stride, w // stride
    pad = patch // 2
    x = torch.nn.functional.pad(img.permute(2, 0, 1)[None],
                                (pad, pad, pad, pad), mode='replicate')
    off = (stride - 1) // 2
    lh, lw = (gh - 1) * stride + patch, (gw - 1) * stride + patch
    x = x[:, :, off:off + lh, off:off + lw]
    cols = torch.nn.functional.unfold(x, patch, stride=stride)  # (1, Cpp, L)
    feat = cols[0].T.reshape(gh, gw, -1)
    feat = feat - feat.mean(dim=-1, keepdim=True)
    return feat / (torch.linalg.norm(feat, dim=-1, keepdim=True) + 1e-6)


def _global_match(feat0: torch.Tensor, feat1: torch.Tensor, stride: int,
                  cycle_tol: int | None = None):
    """Global correlation matching, cycle consistency and propagation.
    feat: (gh, gw, C) L2-normalised. Returns (flow (gh, gw, 2) in image
    pixels, confidence (gh, gw) in [0, 1])."""
    if cycle_tol is None:
        cycle_tol = stride
    gh, gw, c = feat0.shape
    n = gh * gw
    f0 = feat0.reshape(n, c)
    f1 = feat1.reshape(n, c)
    with fp32_math():
        corr = f0 @ f1.T
        coords = _grid_coords(gh, gw, stride, feat0.device)
        idx01 = torch.argmax(corr, dim=1)
        idx10 = torch.argmax(corr, dim=0)
        score = corr.gather(1, idx01[:, None])[:, 0]
        cycle = idx10[idx01]
        err = coords[cycle] - coords
        ok = (err.abs().amax(dim=-1) <= cycle_tol) & (score > 0)
        conf = torch.where(ok, score.clamp(0.0, 1.0), 0.0)
        flow = coords[idx01] - coords
        del corr
        logits = f0 @ f0.T
        tau = 0.07
        wgt = torch.softmax(logits / tau, dim=1) * (conf + 1e-6)[None, :]
        wgt = wgt / wgt.sum(dim=1, keepdim=True)
        prop = wgt @ flow
    flow = conf[:, None] * flow + (1 - conf[:, None]) * prop
    return flow.reshape(gh, gw, 2), conf.reshape(gh, gw)


def _photometric_select(img0: torch.Tensor, img1: torch.Tensor,
                        flows: torch.Tensor) -> torch.Tensor:
    """Per pixel, the candidate flow (flows: (N, H, W, 2)) of least
    7x7-mean warp error; the first on a tie."""
    g0, g1 = _gray(img0.float()), _gray(img1.float())
    errs = torch.stack([box_filter((_warp(g1, f) - g0).abs(), 7)
                        for f in flows])
    best = torch.argmin(errs, dim=0)[None, ..., None]
    return torch.take_along_dim(flows, best.expand(1, -1, -1, 2), dim=0)[0]


def phase_correlation_shifts(img0: torch.Tensor, img1: torch.Tensor,
                             k: int = 2) -> torch.Tensor:
    """Top-k dominant translations img0 -> img1 by FFT phase correlation:
    (k, 2) shifts in (x, y) pixels. After each peak a 7x7 window around it
    (wrapping modulo the size) is suppressed."""
    g0 = _gray(img0.float())
    g1 = _gray(img1.float())
    h, w = g0.shape
    dev = g0.device
    wy = 0.5 - 0.5 * torch.cos(2 * torch.pi * torch.arange(
        h, device=dev, dtype=torch.float32) / (h - 1))
    wx = 0.5 - 0.5 * torch.cos(2 * torch.pi * torch.arange(
        w, device=dev, dtype=torch.float32) / (w - 1))
    win = wy[:, None] * wx[None, :]
    f0 = torch.fft.rfft2((g0 - g0.mean()) * win)
    f1 = torch.fft.rfft2((g1 - g1.mean()) * win)
    cross = f1 * torch.conj(f0)
    r = torch.fft.irfft2(cross / (cross.abs() + 1e-8), s=(h, w))
    shifts = []
    win7 = torch.arange(-3, 4, device=dev)
    for _ in range(k):
        idx = torch.argmax(r)
        py, px = idx // w, idx % w
        sy = torch.where(py > h // 2, py - h, py).float()
        sx = torch.where(px > w // 2, px - w, px).float()
        shifts.append(torch.stack([sx, sy]))
        ys = (py + win7) % h
        xs = (px + win7) % w
        r = r.index_put((ys[:, None], xs[None, :]),
                        torch.tensor(-torch.inf, device=dev))
    return torch.stack(shifts)


def _to_grid(feat, gh: int, gw: int) -> torch.Tensor:
    """An external (fh, fw, C) feature map resized onto the match grid and
    L2-normalised."""
    f = _resize(torch.as_tensor(feat).float(), gh, gw)
    return f / (torch.linalg.norm(f, dim=-1, keepdim=True) + 1e-6)


def _refine_from_init(img0, img1, inits) -> torch.Tensor:
    """Pyramidal LK over the REFINE_LEVELS finest levels from each flow of
    `inits` (values in full-image pixels, any size): refined in one batch,
    each with the arithmetic it would have alone; (N, H, W, 2)."""
    g0 = _gray(img0.float())
    g1 = _gray(img1.float())
    h = g0.shape[0]
    shapes = _levels(*g0.shape, REFINE_LEVELS)
    lh, lw = shapes[-1]
    flow = torch.stack([_resize(c, lh, lw) * (lh / h) for c in inits])
    for lh, lw in reversed(shapes):
        flow = _resize(flow, lh, lw) * (lh / flow.shape[1])
        flow = _lk_refine(_resize(g0, lh, lw), _resize(g1, lh, lw), flow,
                          REFINE_ITERS)
    return flow


def global_matching_flow(img0, img1, feat0=None,
                         feat1=None) -> torch.Tensor:
    """(H, W, 3) frames (tensors, on the device to run on) -> (H, W, 2) flow
    img0 -> img1 in (x, y) pixels. feat0 / feat1 replace the patch
    descriptors (any (gh, gw, C) dense map, given together); the frames
    are edge-padded to a multiple of STRIDE and the flow cropped back."""
    if (feat0 is None) != (feat1 is None):
        raise ValueError('feat0 and feat1 must be provided together '
                         '(got exactly one of the pair)')
    img0, img1 = img0.float(), img1.float()
    h, w = img0.shape[:2]
    cycle_tol = STRIDE
    if feat0 is not None:
        # interpolated coarse features: a round trip lands anywhere within
        # the feature's native cell
        cycle_tol = max(STRIDE, round(h / feat0.shape[0]))
    ph, pw = (-h) % STRIDE, (-w) % STRIDE
    if ph or pw:
        def pad(im):
            return torch.nn.functional.pad(
                im.permute(2, 0, 1)[None], (0, pw, 0, ph),
                mode='replicate')[0].permute(1, 2, 0)
        img0, img1 = pad(img0), pad(img1)
    gh, gw = img0.shape[0] // STRIDE, img0.shape[1] // STRIDE
    if feat0 is None:
        feat0 = patch_features(img0, STRIDE)
        feat1 = patch_features(img1, STRIDE)
    else:
        feat0 = _to_grid(feat0, gh, gw).to(img0.device)
        feat1 = _to_grid(feat1, gh, gw).to(img0.device)
    coarse, _ = _global_match(feat0, feat1, STRIDE, cycle_tol)

    # the matched flow and each phase-correlation shift, refined by LK in
    # one batch (the same arithmetic as one at a time); the candidates in
    # the JAX package's order: matched, zero-init LK pyramid, shifts
    shifts = phase_correlation_shifts(img0, img1, k=PHASE_CANDIDATES)
    hp, wp = img0.shape[:2]
    inits = [coarse] + [s.expand(hp, wp, 2) for s in shifts]
    refined = _refine_from_init(img0, img1, inits)
    cands = torch.stack([refined[0], pyramid_flow(img0, img1),
                         *refined[1:]])
    return _photometric_select(img0, img1, cands)[:h, :w]


def dift_features(featurizer, frame, prompt: str = 'a video frame'):
    """The DIFT feature map of a frame for matching (the frame in [-1, 1]
    or [0, 255]): `featurizer.forward`'s (h, w, 1280) map."""
    arr = torch.as_tensor(frame).float()
    if float(arr.max()) > 1.5:
        arr = arr / 127.5 - 1.0
    return featurizer.forward(arr, prompt)
