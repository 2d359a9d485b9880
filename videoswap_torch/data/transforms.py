"""Video-frame transforms on arrays (the port of
videoswap_tpu/data/transforms.py, which runs them on PIL images).

Frames are (H, W, C) arrays, uint8 or float, channels-last. The geometric
transforms keep the dtype: `Resize` of a uint8 frame rounds to uint8 as
PIL does, of a float frame stays float. `Resize` keeps torchvision's rule
(an int sets the shorter side, keeping the aspect; [h, w] sets both) and
resamples with PIL.BILINEAR's triangle filter (`resample_triangle`: its
tap geometry, widened by the scale when shrinking), in float64 where PIL
uses 8-bit fixed point: within one level of PIL's result.
"""

from __future__ import annotations

import numpy as np
import torch

from videoswap_torch.utils.registry import TRANSFORM_REGISTRY


def build_transform(opt: dict):
    opt = dict(opt)
    t_type = opt.pop('type')
    return TRANSFORM_REGISTRY.get(t_type)(**opt)


def _triangle_taps(in_size: int, out_size: int) -> torch.Tensor:
    """(out_size, in_size) weights of PIL.BILINEAR's resample: a triangle
    of half-width max(scale, 1) around each output pixel's centre, over
    the input pixels it covers, normalised."""
    scale = in_size / out_size
    support = max(scale, 1.0)
    center = (torch.arange(out_size, dtype=torch.float64) + 0.5) * scale
    lo = (center - support + 0.5).to(torch.int64).clamp_min(0)
    hi = (center + support + 0.5).to(torch.int64).clamp_max(in_size)
    j = torch.arange(in_size, dtype=torch.float64)
    w = (1.0 - ((j[None] + 0.5 - center[:, None]) / support).abs()
         ).clamp_min(0.0)
    inside = (j[None] >= lo[:, None]) & (j[None] < hi[:, None])
    w = w * inside
    return w / w.sum(dim=1, keepdim=True)


def resample_triangle(img: np.ndarray, out_h: int, out_w: int) -> np.ndarray:
    """(H, W, C) -> (out_h, out_w, C) float64, PIL.BILINEAR's taps."""
    x = torch.as_tensor(np.asarray(img), dtype=torch.float64)
    my = _triangle_taps(x.shape[0], out_h)
    mx = _triangle_taps(x.shape[1], out_w)
    rows = torch.einsum('yh,hwc->ywc', my, x)
    return torch.einsum('xw,ywc->yxc', mx, rows).numpy()


def _as_hwc(img) -> np.ndarray:
    a = np.asarray(img)
    return a[..., None] if a.ndim == 2 else a


@TRANSFORM_REGISTRY.register()
class Resize:
    def __init__(self, size):
        self.size = size

    def out_size(self, h0: int, w0: int) -> tuple[int, int]:
        if isinstance(self.size, (list, tuple)):
            return tuple(self.size)
        if w0 <= h0:
            return int(round(self.size * h0 / w0)), self.size
        return self.size, int(round(self.size * w0 / h0))

    def __call__(self, img: np.ndarray) -> np.ndarray:
        a = _as_hwc(img)
        h, w = self.out_size(*a.shape[:2])
        out = resample_triangle(a, h, w)
        if a.dtype == np.uint8:
            return np.clip(np.round(out), 0, 255).astype(np.uint8)
        return out.astype(np.float32)


@TRANSFORM_REGISTRY.register()
class CenterCrop:
    def __init__(self, size):
        self.size = size if isinstance(size, (list, tuple)) else (size, size)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        a = np.asarray(img)
        h, w = a.shape[:2]
        th, tw = self.size
        if th > h or tw > w:
            raise ValueError(f'CenterCrop {self.size} of a {h}x{w} frame')
        top, left = (h - th) // 2, (w - tw) // 2
        return a[top:top + th, left:left + tw]


@TRANSFORM_REGISTRY.register()
class ToTensor:
    """uint8 (H, W, C) -> float32 in [0, 1] (channels-last, not CHW);
    float frames pass as float32."""

    def __call__(self, img):
        a = np.asarray(img)
        if a.dtype == np.uint8:
            return a.astype(np.float32) / 255.0
        return a.astype(np.float32)


@TRANSFORM_REGISTRY.register()
class Normalize:
    def __init__(self, mean, std):
        self.mean = np.asarray(mean, dtype=np.float32)
        self.std = np.asarray(std, dtype=np.float32)

    def __call__(self, arr: np.ndarray) -> np.ndarray:
        return (arr - self.mean) / self.std


@TRANSFORM_REGISTRY.register()
class Compose:
    def __init__(self, transforms):
        self.transforms = [build_transform(t) if isinstance(t, dict) else t
                           for t in transforms]

    def __call__(self, x):
        for t in self.transforms:
            x = t(x)
        return x


@TRANSFORM_REGISTRY.register()
class T2I_Preprocess:
    """Resize to (height, width) and scale to [0, 1] for image-conditioned
    T2I adapters: (H, W, C) float32."""

    def __init__(self, height, width):
        self.height, self.width = height, width

    def __call__(self, img):
        a = _as_hwc(img)
        if a.shape[:2] != (self.height, self.width):
            a = Resize([self.height, self.width])(a)
        return ToTensor()(a)
