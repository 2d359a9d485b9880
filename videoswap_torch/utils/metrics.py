"""Quality metrics: PSNR / SSIM / temporal consistency (a copy of
videoswap_tpu/utils/metrics.py, numpy only), for the swap CLI's
`report_metrics`:

- `psnr`: peak signal-to-noise ratio (identical semantics to
  skimage.metrics.peak_signal_noise_ratio with explicit data_range).
- `ssim`: mean structural similarity, Wang et al. 2004, with the
  standard 11x11 sigma-1.5 Gaussian window and k1=0.01/k2=0.03 —
  matching skimage's `gaussian_weights=True, use_sample_covariance=False`
  configuration.
- `temporal_consistency`: mean PSNR between consecutive frames of a
  video — a cheap flicker proxy for edited-video comparisons.
"""

from __future__ import annotations

import numpy as np


def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float('inf')
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_window(size: int = 11, sigma: float = 1.5) -> np.ndarray:
    x = np.arange(size, dtype=np.float64) - (size - 1) / 2
    g = np.exp(-(x ** 2) / (2 * sigma ** 2))
    return g / g.sum()


def _filter2d_valid(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 'valid' convolution with a 1-D window along both spatial
    axes; img is (H, W) float64."""
    from numpy.lib.stride_tricks import sliding_window_view
    h = sliding_window_view(img, k.size, axis=0) @ k
    return sliding_window_view(h, k.size, axis=1) @ k


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0,
         window_size: int = 11, sigma: float = 1.5) -> float:
    """Mean SSIM over valid windows; channels averaged. Inputs (H, W) or
    (H, W, C)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f'ssim of shapes {a.shape} and {b.shape}')
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    if min(a.shape[:2]) < window_size:
        raise ValueError(f'image {a.shape[:2]} smaller than the SSIM window')
    k = _gaussian_window(window_size, sigma)
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[-1]):
        x, y = a[..., c], b[..., c]
        mx = _filter2d_valid(x, k)
        my = _filter2d_valid(y, k)
        mxx = _filter2d_valid(x * x, k)
        myy = _filter2d_valid(y * y, k)
        mxy = _filter2d_valid(x * y, k)
        vx = mxx - mx * mx
        vy = myy - my * my
        cxy = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cxy + c2)) / (
            (mx * mx + my * my + c1) * (vx + vy + c2))
        vals.append(s.mean())
    return float(np.mean(vals))


def video_psnr(a: np.ndarray, b: np.ndarray,
               data_range: float = 1.0) -> float:
    """Mean per-frame PSNR over (F, H, W, C) videos."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.ndim != 4:
        raise ValueError(f'video_psnr of shapes {a.shape} and {b.shape}')
    return float(np.mean([psnr(a[f], b[f], data_range)
                          for f in range(a.shape[0])]))


def temporal_consistency(video: np.ndarray,
                         data_range: float = 1.0) -> float:
    """Mean PSNR between consecutive frames (F, H, W, C): higher = less
    flicker. Only meaningful as a DELTA between two edits of the same
    source (absolute value reflects source motion)."""
    v = np.asarray(video)
    if v.ndim != 4 or v.shape[0] < 2:
        raise ValueError(f'temporal_consistency of a video {v.shape}')
    return float(np.mean([psnr(v[f], v[f + 1], data_range)
                          for f in range(v.shape[0] - 1)]))
