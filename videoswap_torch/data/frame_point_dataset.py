"""Single-video + semantic-point dataset (the port of
videoswap_tpu/data/frame_point_dataset.py).

`num_frames` frames are selected at a fixed stride from the first
`total_frames` of a directory (`select_frame_idx`), read (PNG without PIL,
utils/png.py) and sent through the config's transform chain once; the
TAP.pth conditions are sub-indexed by the same selection.

Layout is channels-last: `pixels` (F, H, W, 3) float32 in [-1, 1];
`get_frames()` (F, H, W, 3) uint8 after the geometric transforms alone
(the video `validation` takes); `pred_tracks` (F, P, 2) float32 (x, y) in
transformed-image pixels; `point_embedding` (P, E) float32.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from videoswap_torch.utils.png import read_image
from videoswap_torch.utils.registry import DATASET_REGISTRY

from .transforms import Compose


def select_frame_idx(begin: int, end: int, n: int) -> list[int]:
    if n <= 1:
        return [begin]
    # the reference's stride (end - begin) // (n - 1) runs past the end of
    # short videos (end=4, n=2 -> [0, 4]); (end - begin - 1) // (n - 1)
    # agrees with it on the shipped 64-frame, 16-sample configs (stride 4)
    interval = max((end - begin - 1) // (n - 1), 1)
    return [int(begin + i * interval) for i in range(n)]


def load_tap_file(tap_path: str) -> dict:
    """A TAP.pth (the reference's dict of tensors, names and sizes), its
    tensors as numpy arrays."""
    tap = torch.load(tap_path, map_location='cpu', weights_only=False)
    return {k: v.numpy() if hasattr(v, 'numpy') else v
            for k, v in tap.items()}


@DATASET_REGISTRY.register()
class SingleVideoPointDataset:

    def __init__(self, opt: dict):
        self.opt = opt
        frame_paths = sorted(Path(opt['path']).iterdir())
        self.select_id = select_frame_idx(
            0, min(len(frame_paths), opt['total_frames']), opt['num_frames'])
        self.video = [frame_paths[i] for i in self.select_id]
        self.prompt = opt['prompt']
        self.num_video = opt.get('dataset_enlarge_ratio', 1)
        transform = Compose(opt['video_transform'])
        geometric = Compose([t for t in opt['video_transform']
                             if t['type'] not in ('ToTensor', 'Normalize')])
        raw = [read_image(str(p)) for p in self.video]
        self.pixels = np.stack([transform(f) for f in raw]).astype(
            np.float32)
        self._frames = np.stack([geometric(f) for f in raw])
        self.size_y, self.size_x = self.pixels.shape[1:3]
        self.condition = (self.get_conditions(opt['tap_path'])
                          if opt.get('tap_path') else None)

    def __len__(self):
        return self.num_video

    def get_frames(self) -> np.ndarray:
        """(F, H, W, 3) uint8 frames after the geometric transforms."""
        return self._frames.copy()

    def get_conditions(self, tap_path: str | None = None) -> dict | None:
        if tap_path is None:
            return self.condition
        tap = load_tap_file(tap_path)
        tracks = np.asarray(tap['pred_tracks'], dtype=np.float32)
        emb = np.asarray(tap['point_embedding'], dtype=np.float32)
        if tracks.shape[1] != emb.shape[0]:
            raise ValueError(f'{tap_path}: {tracks.shape[1]} tracked points, '
                             f'{emb.shape[0]} point embeddings')
        return {
            'pred_tracks': tracks[self.select_id],
            'point_embedding': emb,
            'point_name2id': tap.get('point_name2id', {}),
            'img_size': (self.size_x, self.size_y),
        }

    def __getitem__(self, index: int) -> dict:
        batch = {'pixels': self.pixels, 'prompt': self.prompt}
        if self.condition is not None:
            batch.update(self.condition)
        return batch


def infinite_batches(dataset):
    """The reference's epoch-cycling data yielder (train.py): the
    dataset's items in order, again and again."""
    while True:
        for i in range(len(dataset)):
            yield dataset[i]
