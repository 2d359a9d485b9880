"""Concept-image dataset for ED-LoRA subject finetuning (the port of
videoswap_tpu/data/concept_dataset.py).

A directory of images of one subject, each with a caption that names the
concept (e.g. 'a photo of a catA1 on the grass'). Captions come from a
`captions_file` (one line an image, in sorted file order), else from
`<stem>.txt` sidecars beside every image, else from one
`caption_template`, in that order.

Each item: {'pixels': (H, W, 3) float32 in [-1, 1], 'caption': str}. The
images go once through the registered transform chain: Resize (shorter
side), CenterCrop(resolution), ToTensor, Normalize(0.5), as the video
datasets' geometry.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from videoswap_torch.utils.png import read_image
from videoswap_torch.utils.registry import DATASET_REGISTRY

from .transforms import Compose

_IMG_EXTS = {'.png', '.jpg', '.jpeg', '.webp', '.bmp'}


@DATASET_REGISTRY.register()
class ConceptImageDataset:

    def __init__(self, opt: dict):
        self.opt = opt
        root = Path(opt['image_dir'])
        self.paths = sorted(p for p in root.iterdir()
                            if p.suffix.lower() in _IMG_EXTS)
        if not self.paths:
            raise FileNotFoundError(f'no images under {root}')

        res = int(opt.get('resolution', 512))
        self.transform = Compose(opt.get('image_transform', [
            {'type': 'Resize', 'size': res},
            {'type': 'CenterCrop', 'size': res},
            {'type': 'ToTensor'},
            {'type': 'Normalize', 'mean': [0.5, 0.5, 0.5],
             'std': [0.5, 0.5, 0.5]},
        ]))

        self.captions = self._load_captions(opt)
        self.pixels = np.stack([
            np.asarray(self.transform(read_image(str(p))), np.float32)
            for p in self.paths])                     # (N, H, W, 3)

    def _load_captions(self, opt: dict) -> list[str]:
        if opt.get('captions_file'):
            lines = [ln.strip() for ln in
                     Path(opt['captions_file']).read_text().splitlines()
                     if ln.strip()]
            if len(lines) != len(self.paths):
                raise ValueError(
                    f'captions_file has {len(lines)} lines for '
                    f'{len(self.paths)} images')
            return lines
        sidecars = [p.with_suffix('.txt') for p in self.paths]
        if all(s.is_file() for s in sidecars):
            return [s.read_text().strip() for s in sidecars]
        template = opt.get('caption_template')
        if template is None:
            raise ValueError('need captions_file, per-image .txt sidecars, '
                             'or caption_template')
        return [template] * len(self.paths)

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, index: int) -> dict:
        return {'pixels': self.pixels[index],
                'caption': self.captions[index]}
