"""The layered-neural-atlas training CLI of the port: `python3 -m
videoswap_torch.train_atlas -opt <yaml> [--device cpu]` (the port of
train_atlas.py).

It reads an atlas config (options/train_atlas/...) as train_atlas.py does:
the nets of its `models` block (`build_atlas_nets`, weights from
`manual_seed`), the clip's frames, masks and flows (`load_input_data`,
resized to `res_x` x `res_y`), `sample_batch_size` from `datasets` or
`train`. Both UV mappings are pretrained towards uv_mapping_scale * xy,
then the main Adam starts afresh and each iteration to `total_iter` is a
main step and an inverse step (`AtlasTrainer.run_steps`, run up to the
next print, validation or save step, where the JAX package scans the
same span). Every `logger.print_freq` iterations a `MessageLogger` line of
the last iteration's loss terms; every `val.val_freq` iterations
`evaluate_model` into `visualization/Iter_<step>/` (`val.full_eval` for
the full set of files), the "Validation Reconstruction PSNR" line and the
inverse mapping's round trip of the centre pixel of the middle frame;
every `logger.save_checkpoint_freq` iterations and at the last one the
nets as `models/models_<step>.pth` (`save_atlas_checkpoint`; the JAX
package writes flax's `.msgpack`).

Relative dataset paths resolve against the working directory. A
`manual_seed` of 0 is the seed 0 (the JAX CLI's `or` draws a random seed
for it). It runs on the GPU unless `--device cpu` is given.

`--shard N` trains data-parallel over the N ranks of a torchrun world
(`torchrun --nproc_per_node N -m videoswap_torch.train_atlas -opt <yaml>
--shard N`; any other world is refused): the mesh (N, 1, 1), each
iteration's points split over the ranks (`AtlasTrainer(mesh=...)`). Only
rank 0 evaluates and writes the log, the validation files and the
checkpoints.
"""

from __future__ import annotations

import argparse
import os
import random
import time

import torch

from videoswap_torch.atlas import trainer as atlas_trainer
from videoswap_torch.atlas.data import load_input_data
from videoswap_torch.atlas.evaluate import evaluate_model
from videoswap_torch.atlas.trainer import AtlasTrainer
from videoswap_torch.builders import build_atlas_nets, save_atlas_checkpoint
from videoswap_torch.parallel import dist as vdist
from videoswap_torch.parallel import make_mesh
from videoswap_torch.utils.config import load_config, resolve_path
from videoswap_torch.utils.device import cli_device
from videoswap_torch.utils.logger import (MessageLogger, dict2str,
                                          get_logger, set_path_logger)

NEVER = 10 ** 9


def clip_views(trainer: AtlasTrainer) -> dict:
    """The clip's planes that evaluation reads, as views of the trainer's
    fused per-pixel array on the device: video, mask, flows, flow_masks."""
    fused = trainer.fused
    return {'video': fused[..., atlas_trainer.RGB],
            'mask': fused[..., atlas_trainer.MASK],
            'flows': fused[..., atlas_trainer.FLOW_F],
            'flow_masks': fused[..., atlas_trainer.VALID_F]}


class _Clock:
    """Seconds per stage, the device synchronised at each mark."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.times: dict = {}
        self.mark()

    def mark(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()
        self.t = time.perf_counter()

    def add(self, stage: str) -> float:
        t0 = self.t
        self.mark()
        self.times[stage] = self.times.get(stage, 0.0) + self.t - t0
        return self.t - t0


@torch.no_grad()
def inverse_round_trip(trainer: AtlasTrainer):
    """The centre pixel of the middle frame through the FG mapping and back
    through the inverse mapping: (prediction, point), (1, 3) each."""
    fg = trainer.nets['FG_UV_Mapping']
    inv = trainer.nets[atlas_trainer.INVERSE_NET]
    pt = torch.tensor([[trainer.norm_s(trainer.res_x / 2.0),
                        trainer.norm_s(trainer.res_y / 2.0),
                        trainer.norm_t(trainer.num_frames // 2)]],
                      dtype=torch.float32, device=trainer.device)
    return inv(torch.cat([fg(pt), pt[:, 2:]], dim=-1)), pt


def train(root_path: str, args) -> dict:
    """Run an atlas config. `args`: `opt` (the YAML), `device` (None means
    'cuda'), `shard`. Returns {'opt', 'trainer', 'seed', 'logged' ({step:
    loss terms}), 'validation' ({step: {'psnr', 's'}}), 'checkpoints'
    ({step: path}), 'pretrain' ({net: final loss}), 'times' (s per
    stage: load, pretrain, iterations, validation, save)}."""
    shard = getattr(args, 'shard', None)
    device = cli_device(getattr(args, 'device', None))
    mesh = None
    if shard:
        vdist.join_world(int(shard), f'--shard {shard}', device.type)
        device = vdist.rank_device(device.type)
        mesh = make_mesh((int(shard), 1, 1))
    writes = vdist.is_main_process()
    opt = load_config(args.opt)
    set_path_logger(root_path, args.opt, opt, is_train=True)
    logger = get_logger()
    logger.info(dict2str(opt))
    clock = _Clock(device)

    seed = opt.get('manual_seed')
    if seed is None:
        seed = random.randint(1, 10000)
        logger.info(f'manual_seed not set, using {seed}')
    nets = build_atlas_nets(opt['models'], device=device, seed=seed)
    for n, net in nets.items():
        logger.info(f'{n}: pe={net.pe_type} layers={net.mlp_layers} '
                    f'hidden={net.hidden_0.out_features}')

    datasets_opt = dict(opt['datasets'])
    for k in ('frame_path', 'mask_path', 'flow_path'):
        datasets_opt[k] = resolve_path(root_path, datasets_opt[k])
    data = load_input_data(datasets_opt)
    num_frames = data['video'].shape[0]
    larger_dim = int(max(data['video'].shape[1:3]))
    train_opt = dict(opt['train'])
    if 'sample_batch_size' in opt['datasets']:
        train_opt.setdefault('sample_batch_size',
                             opt['datasets']['sample_batch_size'])
    trainer = AtlasTrainer(nets, data, train_opt, larger_dim=larger_dim,
                           num_frames=num_frames, device=device, mesh=mesh)
    if mesh is not None:
        logger.info(f'atlas training dp-sharded over {shard} ranks '
                    f'(backend {torch.distributed.get_backend()})')
    views = clip_views(trainer)
    gen = torch.Generator(device=device).manual_seed(seed)
    clock.add('load')

    pretrain = {}
    pre_iters = int(train_opt.get('pretrain_UV_mapping_iter', 0))
    if pre_iters > 0:
        for name in ('FG_UV_Mapping', 'BG_UV_Mapping'):
            pretrain[name] = trainer.pretrain_mapping(name, gen, pre_iters)
            logger.info(f'pretrained {name}, final loss '
                        f'{pretrain[name]:.4f}')
        # the main optimizer starts afresh after pretraining moved the nets
        trainer.init_opt_state()
    clock.add('pretrain')

    total_iter = int(train_opt['total_iter'])
    print_freq = int(opt['logger'].get('print_freq', 100))
    save_freq = int(float(opt['logger'].get('save_checkpoint_freq', 10000)))
    val_opt = opt.get('val') or {}
    val_freq = int(val_opt.get('val_freq', NEVER))
    msg = MessageLogger(opt, 0)
    lr = float(train_opt.get('optimizer', {}).get('lr', 1e-4))
    logged, validation, checkpoints = {}, {}, {}
    global_step = 0
    while global_step < total_iter:
        nxt = min(f * (global_step // f + 1)
                  for f in (print_freq, save_freq, val_freq) if f < NEVER)
        nxt = min(nxt, total_iter)
        ld = trainer.run_steps(global_step, nxt - global_step, gen)
        global_step = nxt
        clock.add('iterations')

        if global_step % print_freq == 0:
            logged[global_step] = {k: float(v) for k, v in ld.items()}
            msg({'iter': global_step, 'lrs': [lr], **logged[global_step]})

        if global_step % val_freq == 0 and writes:
            save_dir = os.path.join(opt['path']['visualization'],
                                    f'Iter_{global_step}')
            value = evaluate_model(
                trainer.nets, views['video'], trainer.res_x, trainer.res_y,
                num_frames, trainer.norm_s, trainer.norm_t,
                save_dir=save_dir, data=views,
                full=bool(val_opt.get('full_eval', False)),
                uv_mapping_scale=trainer.uv_scale,
                derivative_amount=trainer.d_amt)
            logger.info(f'Validation Reconstruction PSNR: {value:.4f}')
            if atlas_trainer.INVERSE_NET in trainer.nets:
                pred, pt = inverse_round_trip(trainer)
                logger.info(f'inverse pred: {pred.cpu().numpy()}, '
                            f'gt: {pt.cpu().numpy()}')
            validation[global_step] = {'psnr': value,
                                       's': clock.add('validation')}

        if global_step % save_freq == 0 or global_step == total_iter:
            path = os.path.join(opt['path']['models'],
                                f'models_{global_step}.pth')
            save_atlas_checkpoint(path, trainer.nets)
            checkpoints[global_step] = path
            logger.info(f'Save models to {path}')
            clock.add('save')

    logger.info('stage times (s): ' + ', '.join(
        f'{k} {v:.3f}' for k, v in clock.times.items()))
    logger.info('training done')
    vdist.barrier()
    return dict(opt=opt, trainer=trainer, seed=seed, logged=logged,
                validation=validation, checkpoints=checkpoints,
                pretrain=pretrain, times=clock.times)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--shard', type=int, default=None,
                        help='N: data-parallel over the N ranks of a '
                             'torchrun world')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs the plain version of the hash "
                             "kernel on the CPU; the default is 'cuda'")
    try:
        train(os.path.abspath('.'), parser.parse_args(argv))
    finally:
        vdist.shutdown()


if __name__ == '__main__':
    main()
