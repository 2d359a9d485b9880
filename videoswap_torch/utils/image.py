"""Frames -> the pipelines' video array (the port of
videoswap_tpu/utils/image.py `preprocess_video`): images scaled to
[-1, 1], sizes snapped down to multiples of 8, channels-last
(1, F, H, W, 3) float32. PIL is imported where it is used: the card's
machine need not have it, and arrays skip it.
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


def video_geometry(video) -> tuple[int, int, int]:
    """(frames, height, width) of a video in any form `video_pixels`
    takes."""
    if isinstance(video, list):
        w, h = video[0].size
        return len(video), h, w
    if video.dtype == np.uint8:
        return tuple(video.shape[:3])
    return tuple(video.shape[1:4])


def video_pixels(video):
    """The pipelines' (1, F, H, W, 3) video in [-1, 1] from PIL frames
    (`preprocess_video`), uint8 frames (F, H, W, 3) whose sizes are
    multiples of 8 (a dataset's `get_frames()`), or a float video already
    in that form (returned as it is)."""
    if isinstance(video, list):
        return preprocess_video(video)
    if video.dtype == np.uint8:
        if video.shape[1] % 8 or video.shape[2] % 8:
            raise ValueError(f'uint8 frames {video.shape}: height and width '
                             'must be multiples of 8')
        return (np.asarray(video, np.float32) / 127.5 - 1.0)[None]
    return video
