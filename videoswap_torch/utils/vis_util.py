"""Visualisation and video output (the port of
videoswap_tpu/utils/vis_util.py): point overlays drawn in numpy, frame
directories written as PNG with utils/png.py, gif through PIL and mp4
through imageio, each imported where it is used (the card's machine may
have neither).

`overlay_points` draws the same pixels as PIL's `ImageDraw.ellipse(box,
fill=color)` on the box (x - r, y - r, x + r, y + r): PIL truncates the
box to ints and fills, row by row, the span of a quarter-ellipse walk in
doubled coordinates (`_ellipse_spans`, the steps of Pillow's
`quarter_next`).
"""

from __future__ import annotations

import os

import numpy as np

from videoswap_torch.utils.png import write_png

OPENPOSE_NAME2ID = {
    'nose': 0, 'neck': 1, 'right_shoulder': 2, 'right_elbow': 3,
    'right_wrist': 4, 'left_shoulder': 5, 'left_elbow': 6, 'left_wrist': 7,
    'right_hip': 8, 'right_knee': 9, 'right_ankle': 10, 'left_hip': 11,
    'left_knee': 12, 'left_ankle': 13, 'right_eye': 14, 'left_eye': 15,
    'right_ear': 16, 'left_ear': 17,
}


def _ellipse_spans(a: int, b: int) -> list[tuple[int, int, int]]:
    """(row, first column, last column) of the pixels PIL fills for an
    ellipse in the box (0, 0, a, b), a, b >= 0 ints (none for a point)."""
    if a == b == 0:
        return []
    a2, b2 = a * a, b * b

    def dev(x, y):
        return abs(a2 * y * y + b2 * x * x - a2 * b2)

    # the quarter from (a, b % 2) to (a % 2, b), two units a step; each
    # row's span reaches the largest x the walk has on it
    cx, cy = a, b % 2
    reach = {cy: cx}
    while not (cx == a % 2 and cy == b):
        nx, ny = cx, cy + 2
        best = dev(nx, ny)
        if nx > 1:
            d = dev(cx - 2, cy + 2)
            if best > d:
                nx, ny, best = cx - 2, cy + 2, d
            if best > dev(cx - 2, cy):
                nx, ny = cx - 2, cy
        cx, cy = nx, ny
        reach[cy] = max(reach.get(cy, -1), cx)
    spans = set()
    for y, x in reach.items():
        for yy in (y, -y):
            spans.add(((yy + b) // 2, (a - x) // 2, (a + x) // 2))
    return sorted(spans)


def overlay_points(frames, tap_dict: dict, radius: int = 5,
                   color=(0, 255, 0)) -> np.ndarray:
    """Draw tracked points on a copy of uint8 frames (F, H, W, 3): a
    filled disc of `radius` at each point of each frame, skipping
    deselected points (`tap_dict['index_list']`) and hidden ones (x < 0 or
    y < 0). Frames past the tracks' are dropped, as in the JAX package."""
    tracks = np.asarray(tap_dict['pred_tracks'], np.float64)
    index_list = tap_dict.get('index_list')
    out = np.array(frames[:len(tracks)], dtype=np.uint8, copy=True)
    h, w = out.shape[1:3]
    color = np.asarray(color, np.uint8)
    cache = {}
    for f in range(len(out)):
        for p in range(tracks.shape[1]):
            if index_list is not None and p not in index_list:
                continue
            x, y = tracks[f, p]
            if x < 0 or y < 0:
                continue
            # PIL truncates the box's corners toward zero
            x0, y0 = int(x - radius), int(y - radius)
            a, b = int(x + radius) - x0, int(y + radius) - y0
            if (a, b) not in cache:
                cache[a, b] = _ellipse_spans(a, b)
            for row, c0, c1 in cache[a, b]:
                r, lo, hi = y0 + row, max(x0 + c0, 0), min(x0 + c1, w - 1)
                if 0 <= r < h and lo <= hi:
                    out[f, r, lo:hi + 1] = color
    return out


def make_grid(images, cols: int = 4) -> np.ndarray:
    """(N, H, W, C) images -> one (rows H, cols W, C) grid, row-major."""
    images = np.asarray(images)
    n, h, w, c = images.shape
    cols = min(cols, n)
    rows = (n + cols - 1) // cols
    grid = np.zeros((rows * h, cols * w, c), images.dtype)
    for i, im in enumerate(images):
        grid[(i // cols) * h:(i // cols + 1) * h,
             (i % cols) * w:(i % cols + 1) * w] = im
    return grid


def _save_gif(frames, path: str, fps: int, need: str = 'a gif') -> None:
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(f'saving {need} needs PIL (pillow)') from e
    ims = [Image.fromarray(f) for f in frames]
    ims[0].save(path, save_all=True, append_images=ims[1:],
                duration=int(1000 / fps), loop=0)


def save_video_to_dir(video_frames, save_dir: str, save_suffix: str,
                      save_type: str = 'frame_gif', fps: int = 8) -> None:
    """Write uint8 frames (F, H, W, 3) as the substrings of `save_type`
    ask: 'frame' a directory `frames_<suffix>/` of `{i:05d}.png`, 'gif'
    `<suffix>.gif` (PIL), 'video' `<suffix>.mp4` (imageio; a gif through
    PIL when imageio is missing or cannot write it, as in the JAX
    package). A missing package raises ImportError naming it."""
    frames = np.asarray(video_frames, dtype=np.uint8)
    os.makedirs(save_dir, exist_ok=True)
    if 'frame' in save_type:
        frame_dir = os.path.join(save_dir, f'frames_{save_suffix}')
        os.makedirs(frame_dir, exist_ok=True)
        for i, f in enumerate(frames):
            write_png(os.path.join(frame_dir, f'{i:05d}.png'), f)
    if 'gif' in save_type:
        _save_gif(frames, os.path.join(save_dir, f'{save_suffix}.gif'), fps)
    if 'video' in save_type:
        try:
            import imageio
            with imageio.get_writer(os.path.join(
                    save_dir, f'{save_suffix}.mp4'), fps=fps) as w:
                for f in frames:
                    w.append_data(f)
        except (ImportError, ValueError, RuntimeError, OSError):
            # no imageio or no ffmpeg backend: a gif, as in the JAX package
            _save_gif(frames, os.path.join(save_dir, f'{save_suffix}.gif'),
                      fps, need='an mp4 without imageio\'s ffmpeg')
