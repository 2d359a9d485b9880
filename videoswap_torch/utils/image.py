"""Frames -> the pipelines' video array (the port of
videoswap_tpu/utils/image.py `preprocess_video`): images scaled to
[-1, 1], sizes snapped down to multiples of 8, channels-last
(1, F, H, W, 3) float32. PIL is imported where it is used: the card's
machine need not have it, and arrays skip this step.
"""

from __future__ import annotations

import numpy as np


def preprocess_video(frames) -> np.ndarray:
    """PIL frames -> (1, F, H, W, 3) float32 in [-1, 1], H/W snapped to /8."""
    from PIL import Image
    w, h = frames[0].size
    w, h = w - w % 8, h - h % 8
    arrs = []
    for im in frames:
        if im.size != (w, h):
            im = im.resize((w, h), Image.LANCZOS)
        arrs.append(np.asarray(im.convert('RGB'), dtype=np.float32) / 127.5
                    - 1.0)
    return np.stack(arrs)[None]
