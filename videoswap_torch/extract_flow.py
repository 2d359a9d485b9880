"""The flow-extraction CLI of the port: `python3 -m
videoswap_torch.extract_flow --frame_dir <dir> --out_dir <dir> [--method
auto|matching|lk] [--device cpu]` (the port of scripts/extract_flow.py).

It reads the frames of `frame_dir` in name order (RGB, [0, 1]) and writes,
for each consecutive pair i, `<out_dir>/{i:05d}.npy`: the [2, H, W, 2]
float32 forward and backward flow (`preprocess.flow.
compute_bidirectional_flow`), the layout `atlas.data.load_input_data`
reads. `--method auto` runs what the JAX CLI runs: UniMatch where its
checkpoint is on disk ($VS_UNIMATCH_CKPT, pretrained_models/, the
reference's thirdparty path), else the weight-free matching flow. It runs
on the GPU unless `--device cpu` is given.
"""

from __future__ import annotations

import argparse
import os
from pathlib import Path

import numpy as np

from videoswap_torch.preprocess.flow import (compute_bidirectional_flow,
                                             load_unimatch, resolve_method)
from videoswap_torch.utils.device import cli_device


def read_frame(path) -> np.ndarray:
    from PIL import Image
    return np.asarray(Image.open(path).convert('RGB'), np.float32) / 255.0


def main(frame_dir: str, out_dir: str, method: str = 'auto',
         device=None) -> list[str]:
    """Write the flow files; returns their paths. `device`: None means
    'cuda'. The method is resolved once, before the device is asked for."""
    method = resolve_method(method)
    device = cli_device(device)
    unimatch = load_unimatch(device) if method == 'unimatch' else None
    os.makedirs(out_dir, exist_ok=True)
    paths = sorted(Path(frame_dir).iterdir())
    written = []
    prev = read_frame(paths[0]) if paths else None
    for i in range(len(paths) - 1):
        nxt = read_frame(paths[i + 1])
        flow = compute_bidirectional_flow(prev, nxt, method=method,
                                          device=device, unimatch=unimatch)
        out = os.path.join(out_dir, f'{i:05d}.npy')
        np.save(out, flow)
        written.append(out)
        print(f'{i:05d}.npy: flow range '
              f'[{flow.min():.2f}, {flow.max():.2f}]', flush=True)
        prev = nxt
    return written


def cli(argv=None) -> list[str]:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--frame_dir', type=str, required=True)
    parser.add_argument('--out_dir', type=str, required=True)
    parser.add_argument('--method', type=str, default='auto',
                        choices=['auto', 'unimatch', 'matching', 'lk'],
                        help="'auto' is UniMatch where its checkpoint is on "
                             "disk, else 'matching'")
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs on the CPU; the default is 'cuda'")
    args = parser.parse_args(argv)
    return main(args.frame_dir, args.out_dir, args.method, device=args.device)


if __name__ == '__main__':
    cli()
