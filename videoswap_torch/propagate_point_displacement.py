"""The point-drag propagation CLI of the port: `python3 -m
videoswap_torch.propagate_point_displacement --atlas_config_path <yaml>
--atlas_model_path <models_N.pth> --source_tap_path <TAP.pth>
--source_point_path <dir>/<keyframe>.json --target_point_path
<dir>/<name>.json [--device cpu]` (the port of
propagate_point_displacement.py).

It loads a trained atlas (the config's `models` block, the checkpoint of
`save_atlas_checkpoint`), reads the keyframe's source and target points
(`{name: [y, x]}`; the keyframe index is the source file's name), moves
each dragged point's track in every frame through the atlas Jacobians
(`atlas.propagate.propagate_point_sequence`) and writes the edited TAP
file as `TAP_<target name>.pth` beside the target file, the file a swap
config's per-swap `tap_path` names. It runs on the GPU unless `--device
cpu` is given.
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
from pathlib import Path

import numpy as np
import torch

from videoswap_torch.atlas.propagate import (bind_nets,
                                             propagate_point_sequence)
from videoswap_torch.builders import build_atlas_nets, load_atlas_checkpoint
from videoswap_torch.data.frame_point_dataset import load_tap_file
from videoswap_torch.utils.device import cli_device
from videoswap_torch.utils.config import load_config


def clip_size(datasets_opt: dict) -> tuple[int, int]:
    """(num_frames, larger_dim) of the clip an atlas config trains on:
    min(max_frames, the frame files) and max(res_x, res_y), the numbers
    the shapes of `load_input_data` give, without reading the clip (paths
    relative to the working directory, as the JAX CLI reads them)."""
    frames = len(list(Path(datasets_opt['frame_path']).iterdir()))
    return (min(int(datasets_opt['max_frames']), frames),
            int(max(datasets_opt['res_x'], datasets_opt['res_y'])))


def process_displacement_propagation(atlas_config_path: str,
                                     atlas_model_path: str,
                                     source_tap_path: str,
                                     source_point_path: str,
                                     target_point_path: str,
                                     device=None) -> dict:
    """The source TAP file's contents with the dragged points' tracks
    replaced (numpy arrays where it holds tensors)."""
    cfg = load_config(atlas_config_path)
    nets = build_atlas_nets(cfg['models'], device=device)
    load_atlas_checkpoint(atlas_model_path, nets)
    fg, inv, alpha = bind_nets(nets)
    num_frames, larger_dim = clip_size(cfg['datasets'])

    def norm_s(v):
        return v / (larger_dim / 2.0) - 1.0

    def norm_t(v):
        return v / (num_frames / 2.0) - 1.0

    with open(source_point_path) as f:
        source_points = json.load(f)
    keyframe_t = int(osp.splitext(osp.basename(source_point_path))[0])
    with open(target_point_path) as f:
        target_points = json.load(f)

    tap = load_tap_file(source_tap_path)
    tap['pred_tracks'] = propagate_point_sequence(
        source_points, target_points, keyframe_t,
        np.asarray(tap['pred_tracks']), tap['point_name2id'], fg, inv,
        alpha, larger_dim, num_frames, norm_s, norm_t)
    return tap


def save_tap(tap: dict, path: str) -> None:
    """A TAP dict as the reference's torch file (numpy arrays as
    tensors)."""
    torch.save({k: torch.from_numpy(np.asarray(v))
                if isinstance(v, np.ndarray) else v
                for k, v in tap.items()}, path)


def main(argv=None) -> str:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--atlas_config_path', type=str, required=True)
    parser.add_argument('--atlas_model_path', type=str, required=True)
    parser.add_argument('--source_point_path', type=str, required=True)
    parser.add_argument('--source_tap_path', type=str, required=True)
    parser.add_argument('--target_point_path', type=str, required=True)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs on the CPU; the default is 'cuda'")
    args = parser.parse_args(argv)
    tap = process_displacement_propagation(
        args.atlas_config_path, args.atlas_model_path, args.source_tap_path,
        args.source_point_path, args.target_point_path,
        device=cli_device(args.device))
    suffix = osp.splitext(osp.basename(args.target_point_path))[0]
    out_path = os.path.join(os.path.dirname(args.target_point_path),
                            f'TAP_{suffix}.pth')
    save_tap(tap, out_path)
    print(f'save to {out_path}')
    return out_path


if __name__ == '__main__':
    main()
