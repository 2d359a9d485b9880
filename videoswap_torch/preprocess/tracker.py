"""Semantic point tracking with DIFT correspondence: the port of
videoswap_tpu/preprocess/tracker.py, whose docstring gives the method
(cosine maps of each keyframe point's feature against every frame, a
locality prior centred on the flow-predicted position that widens while a
point coasts, a confidence gate, the quadratic sub-pixel fit, forward and
backward from the keyframe).

The JAX package keeps every frame's full-resolution (H, W, 1280) map, 2.1
GB a frame at 854x480 in fp32. Here each frame's map is resized on the
device, turned into its (H, W, P) cosine maps (normalised rows, one
product) and dropped; the cosine maps go to the host, where the per-point
walk runs in numpy with the JAX package's arithmetic.

The resize and the cosines run in float64 (4.2 GB a frame at 854x480),
and the walk reads them so. The DIFT maps are bilinear upsamplings by 16,
so a cosine peak's curvature from pixel to pixel is near fp32's rounding
of the cosines, and the parabola fit turns that rounding into hundredths
of a pixel: in fp32 the same features gave tracks 1.3e-2 px apart on the
H100 and on its host's CPU (their resize kernels round differently), in
float64 they agree to far below that.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch

from .flow import _resize, fp32_math

LOCALITY_SIGMA = 0.15   # the locality prior's width, a fraction of the
                        # image's diagonal
CONF_THRESH = 0.75      # below it a match is occluded (the JAX package's
                        # calibration)


def _cos_maps(feat_hw_c: torch.Tensor, vecs_pc: torch.Tensor) -> torch.Tensor:
    """(h, w, C), (P, C) -> (h, w, P) cosine maps, on their device, in
    their dtype."""
    with fp32_math():
        f = feat_hw_c / (torch.linalg.norm(feat_hw_c, dim=-1, keepdim=True)
                         + 1e-8)
        v = vecs_pc / (torch.linalg.norm(vecs_pc, dim=-1, keepdim=True)
                       + 1e-8)
        return f @ v.T


def _subpixel(cos_p: np.ndarray, by: int, bx: int) -> tuple[float, float]:
    """Quadratic (parabola) peak interpolation around an argmax."""
    h, w = cos_p.shape

    def fit(cm, c0, cp):
        denom = cm - 2.0 * c0 + cp
        if denom >= -1e-12:            # not a proper local max
            return 0.0
        return float(np.clip(0.5 * (cm - cp) / denom, -0.5, 0.5))

    dx = fit(cos_p[by, bx - 1], cos_p[by, bx], cos_p[by, bx + 1]) \
        if 0 < bx < w - 1 else 0.0
    dy = fit(cos_p[by - 1, bx], cos_p[by, bx], cos_p[by + 1, bx]) \
        if 0 < by < h - 1 else 0.0
    return dx, dy


@dataclass
class DIFTTracker:
    featurizer: Any
    device: Optional[str] = None   # None: the featurizer's, else 'cuda'

    def _device(self) -> torch.device:
        if self.device is not None:
            return torch.device(self.device)
        return getattr(self.featurizer, 'device', torch.device('cuda'))

    def track(self, frames: list, keyframe_idx: int, points_xy,
              category: str, feats: Optional[list] = None) -> np.ndarray:
        """frames: (H, W, 3) arrays in [-1, 1]; points_xy: (P, 2) on the
        keyframe; feats: each frame's featurizer map, where the caller has
        them (else they are computed here). Returns (F, P, 2) float32
        tracks."""
        dev = self._device()
        prompt = f'photo of a {category}'
        h, w = frames[0].shape[:2]
        nf = len(frames)

        def raw(fi):
            f = (feats[fi] if feats is not None
                 else self.featurizer.forward(frames[fi], prompt))
            return torch.as_tensor(f).to(dev, torch.float64)

        pts = np.asarray(points_xy, np.float32)
        ii = np.clip(np.round(pts).astype(int), 0, [w - 1, h - 1])
        key = _resize(raw(keyframe_idx), h, w)
        vecs = key[torch.as_tensor(ii[:, 1], device=dev),
                   torch.as_tensor(ii[:, 0], device=dev)]
        del key
        cos_all = []
        for fi in range(nf):
            cos_all.append(_cos_maps(_resize(raw(fi), h, w),
                                     vecs).cpu().numpy())

        from .matching_flow import global_matching_flow

        def flow(a, b):
            fa, fb = (torch.as_tensor(np.asarray(frames[i], np.float32),
                                      device=dev) for i in (a, b))
            return global_matching_flow(fa, fb).cpu().numpy()
        flow_step: dict[tuple[int, int], np.ndarray] = {}
        for fi in range(keyframe_idx, nf - 1):
            flow_step[(fi, fi + 1)] = flow(fi, fi + 1)
        for fi in range(keyframe_idx, 0, -1):
            flow_step[(fi, fi - 1)] = flow(fi, fi - 1)

        tracks = np.zeros((nf, len(pts), 2), np.float32)
        sigma2 = (LOCALITY_SIGMA * np.hypot(h, w)) ** 2
        ys, xs = np.mgrid[0:h, 0:w]

        for pi, (px, py) in enumerate(pts):
            for order in (range(keyframe_idx, nf),
                          range(keyframe_idx, -1, -1)):
                prev = np.array([px, py], np.float32)
                last = None
                n_coast = 0
                for fi in order:
                    pred = prev
                    if last is not None and (last, fi) in flow_step:
                        fl = flow_step[(last, fi)]
                        iy = int(np.clip(round(prev[1]), 0, h - 1))
                        ix = int(np.clip(round(prev[0]), 0, w - 1))
                        pred = prev + fl[iy, ix]
                        pred = np.clip(pred, 0, [w - 1, h - 1])
                    cos = cos_all[fi][..., pi]
                    # the re-lock search widens with the coast's length,
                    # capped (the JAX package's comment says why)
                    widen = float(min(1 + n_coast, 4)) ** 2
                    prior = np.exp(-((xs - pred[0]) ** 2
                                     + (ys - pred[1]) ** 2)
                                   / (2 * sigma2 * widen))
                    by, bx = np.unravel_index(
                        (cos * prior).argmax(), cos.shape)
                    if cos[by, bx] < CONF_THRESH:
                        tracks[fi, pi] = pred   # occluded: coast (or hold)
                        prev = pred.astype(np.float32)
                        n_coast += 1
                    else:
                        pos = np.array([bx, by], np.float32)
                        pos += _subpixel(cos, by, bx)
                        tracks[fi, pi] = pos
                        prev = pos
                        n_coast = 0
                    last = fi
        return tracks


def load_thirdparty_cotracker(thirdparty_dir: str = 'thirdparty/co-tracker'):
    """The reference's gated import of an external co-tracker checkout:
    its `CoTrackerPredictor` class, or None."""
    import os
    import sys
    if not os.path.isdir(thirdparty_dir):
        return None
    sys.path.insert(0, thirdparty_dir)
    try:
        from cotracker.predictor import CoTrackerPredictor  # type: ignore
        return CoTrackerPredictor
    except Exception:
        return None
