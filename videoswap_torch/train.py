"""The adapter-training CLI of the port: `python3 -m videoswap_torch.train
-opt <yaml> [--resume] [--device cpu]` (the port of train.py).

It reads a training config (options/train_videoswap/...) as train.py does:
the dataset (one clip and its TAP.pth), the models (`build_models`: the
diffusers SD-1.5 directory, the motion module, a random or pretrained
adapter), `mixed_precision` fp16 or bf16 as bf16 models (the adapter's
weights, gradients and AdamW state stay fp32), `manual_seed` for numpy and
the steps' noise generator. The video's VAE posterior moments are encoded
once (`train.cache_vae_latents`, on by default: the dataset replays one
clip); then each iteration draws the next item of the epoch-cycling
yielder and takes one `VideoSwapTrainer.step`. Every `logger.print_freq`
steps a `MessageLogger` line; every `val.val_freq` steps a blended
`validation` on the training models, without gradients, its swaps written
under `visualization/iter_<step>/`; every `logger.save_checkpoint_freq`
steps and at the last one the adapter as `models/models_<step>/adapter.pth`
(the file a swap config's `path.pretrained_adapter_path` names) and the
train state, `models/train_state.pth` (adapter, AdamW state, step), or,
with `logger.checkpoint_backend: orbax`, a step-indexed checkpoint under
`models/orbax` (utils/checkpointing.py, `logger.max_to_keep`).

`--resume` keeps the experiment directory and restores the adapter, the
AdamW state and the step from the train state (or the latest step-indexed
checkpoint); the noise generator restarts from `manual_seed`, as train.py
restarts its key. It runs on the GPU unless `--device cpu` is given.

`--distributed` runs it as one rank of a torchrun world (`torchrun
--nproc_per_node N -m videoswap_torch.train -opt <yaml> --distributed`), as
train.py runs under its multi-host launch: the process group is started,
every rank runs the same unsharded steps from the same seed, and only rank
0 writes the log, the checkpoints and the validation output (the other
ranks wait for its validation at a barrier).
"""

from __future__ import annotations

import argparse
import os
import random
import time

import numpy as np
import torch

from videoswap_torch.builders import (MIXED_PRECISION, build_models,
                                      load_train_state, restore_train_state,
                                      save_adapter_checkpoint,
                                      save_train_state, train_state_dict)
from videoswap_torch.data import build_dataset
from videoswap_torch.data.frame_point_dataset import infinite_batches
from videoswap_torch.parallel import dist as vdist
from videoswap_torch.pipelines import VideoSwapPipeline, VideoSwapTrainer
from videoswap_torch.utils.config import load_config, resolve_path
from videoswap_torch.utils.device import cli_device
from videoswap_torch.utils.logger import (MessageLogger, dict2str,
                                          get_logger, set_path_logger)
from videoswap_torch.utils.profiling import StepTimer
from videoswap_torch.utils.vis_util import save_video_to_dir

TRAIN_STATE = 'train_state.pth'


def _cpu_clone(obj):
    """A copy of a (nested) state dict with every tensor cloned to the
    CPU."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _cpu_clone(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_cpu_clone(v) for v in obj)
    return obj


def state_snapshot(trainer: VideoSwapTrainer) -> dict:
    """What a train-state checkpoint holds, copied to the CPU: the
    adapter's and the optimizer's state dicts."""
    return _cpu_clone({'adapter': trainer.adapter.state_dict(),
                       'optimizer': trainer.optimizer.state_dict()})


def train_batch(dataset, tokenizer, device, dtype) -> dict:
    """The static batch of the one cached video: its pixels (in the
    models' dtype), the prompt's ids, the point tracks and embeddings."""
    item = dataset[0]
    ids = tokenizer([item['prompt']], padding='max_length',
                    max_length=tokenizer.model_max_length,
                    truncation=True).input_ids
    return {
        'pixels': torch.from_numpy(item['pixels'])[None].to(device, dtype),
        'input_ids': torch.as_tensor(np.asarray(ids), device=device),
        'pred_tracks': torch.from_numpy(item['pred_tracks']).to(device),
        'point_embedding': torch.from_numpy(
            item['point_embedding']).to(device),
    }


def train(root_path: str, args) -> dict:
    """Run a training config. `args`: `opt` (the YAML), `resume`,
    `device` (None means 'cuda'), `distributed`. Returns {'opt',
    'trainer', 'dataset', 'start_step', 'start_state' (the
    adapter and AdamW state the loop started from, on the CPU), 'losses',
    'step_s', 'validation' ({step: {'s', 'peak_gib', 'resident_gib'}})}."""
    device = cli_device(getattr(args, 'device', None))
    if vdist.maybe_initialize_distributed(getattr(args, 'distributed', False),
                                          device.type):
        device = vdist.rank_device(device.type)
    writes = vdist.is_main_process()
    resume = getattr(args, 'resume', False)
    opt = load_config(args.opt)
    set_path_logger(root_path, args.opt, opt, is_train=True,
                    reuse_existing=resume)
    logger = get_logger()
    logger.info(dict2str(opt))

    seed = opt.get('manual_seed')
    if seed is None:
        seed = random.randint(1, 10000)
        logger.info(f'manual_seed not set, using {seed}')
    np.random.seed(seed)
    dtype = MIXED_PRECISION.get(opt.get('mixed_precision', 'no'),
                                torch.float32)

    dataset_opt = dict(opt['datasets'])
    for k in ('path', 'tap_path'):
        if dataset_opt.get(k):
            dataset_opt[k] = resolve_path(root_path, dataset_opt[k])
    dataset = build_dataset(dataset_opt)
    models = build_models(opt, root_path, device=device, dtype=dtype,
                          seed=seed)

    train_opt = opt['train']
    trainer = VideoSwapTrainer(
        **models, tune_cfg=train_opt.get('tune_cfg', {}),
        optimizer_cfg=train_opt.get('optimizer', {}),
        max_grad_norm=train_opt.get('max_grad_norm'))
    total_iter = int(train_opt['total_iter'])
    global_step = 0

    # checkpoint backend: 'msgpack' (the name the JAX package gives its
    # flat files: here the adapter's .pth and one train-state file, the
    # default) or 'orbax' (step-indexed directories with retention)
    ckpt_mgr = None
    if opt['logger'].get('checkpoint_backend', 'msgpack') == 'orbax':
        from videoswap_torch.utils.checkpointing import CheckpointManager
        ckpt_mgr = CheckpointManager(
            os.path.join(opt['path']['models'], 'orbax'),
            max_to_keep=int(opt['logger'].get('max_to_keep', 3)))

    resume_path = os.path.join(opt['path']['models'], TRAIN_STATE)
    if resume and ckpt_mgr is not None and \
            ckpt_mgr.latest_step() is not None:
        global_step = restore_train_state(
            ckpt_mgr.restore(), trainer.adapter, trainer.optimizer)
        logger.info(f'resumed from orbax step {global_step}')
    elif resume and os.path.isfile(resume_path):
        global_step = load_train_state(resume_path, trainer.adapter,
                                       trainer.optimizer)
        logger.info(f'resumed from step {global_step}')
    start_step, start_state = global_step, state_snapshot(trainer)

    batch = train_batch(dataset, models['tokenizer'], device, dtype)
    if train_opt.get('cache_vae_latents', True):
        # the dataset replays one video, so the VAE encoder's pass is
        # loop-invariant: encode the posterior moments once; each step
        # draws its own sample from them
        with torch.no_grad():
            batch['latent_mean'], batch['latent_logvar'] = \
                trainer.vae.encode_video_moments(batch.pop('pixels'))
        logger.info('cached VAE posterior moments (single-video loop)')
    yielder = infinite_batches(dataset)

    logger_msg = MessageLogger(opt, global_step)
    gen = torch.Generator(device=device).manual_seed(seed)
    timer = StepTimer(sync=True)
    print_freq = int(opt['logger'].get('print_freq', 10))
    save_freq = int(float(opt['logger'].get('save_checkpoint_freq', 10000)))
    val_freq = int(opt.get('val', {}).get('val_freq', 10 ** 9))
    lr = float(train_opt.get('optimizer', {}).get('lr', 5e-4))
    losses, validation = [], {}

    while global_step < total_iter:
        next(yielder)      # the reference's epoch cycling (one video)
        timer.start()
        loss = trainer.step(batch, gen)
        timer.stop(loss)
        global_step += 1
        losses.append(loss.item())

        if global_step % print_freq == 0:
            logger_msg({'iter': global_step, 'lrs': [lr],
                        'total_loss': losses[-1],
                        'step_time': timer.times[-1]})

        if global_step % val_freq == 0 and 'val' in opt:
            if writes:
                validation[global_step] = run_validation(
                    opt, trainer, dataset, global_step)
            vdist.barrier()

        if global_step % save_freq == 0 or global_step == total_iter:
            save_adapter_checkpoint(
                os.path.join(opt['path']['models'], f'models_{global_step}',
                             'adapter.pth'), trainer.adapter)
            if ckpt_mgr is not None:
                if writes:
                    ckpt_mgr.save(global_step, train_state_dict(
                        trainer.adapter, trainer.optimizer, global_step))
            else:
                save_train_state(resume_path, trainer.adapter,
                                 trainer.optimizer, global_step)
            logger.info(f'saved checkpoint at step {global_step}')

    s = timer.summary()
    if s:
        logger.info(
            f'step time: mean {s["mean_s"]:.3f}s  p50 {s["p50_s"]:.3f}s  '
            f'p90 {s["p90_s"]:.3f}s over {s["steps"]} steps '
            f'(total {s["total_s"]:.1f}s)')
    logger.info('training done')
    vdist.barrier()
    return dict(opt=opt, trainer=trainer, dataset=dataset,
                start_step=start_step, start_state=start_state,
                losses=losses, step_s=list(timer.times),
                validation=validation)


def run_validation(opt, trainer: VideoSwapTrainer, dataset,
                   global_step: int) -> dict:
    """The config's `val.editing_config` swaps through `validation` on the
    training models (the adapter as trained so far), without gradients;
    the frames go to `visualization/iter_<step>/<swap>`. Returns the
    wall-clock and, on the GPU, the peak memory (GiB, the process's) and
    what was resident when it started."""
    logger = get_logger()
    logger.info(f'validation at step {global_step}')
    cuda = trainer.device.type == 'cuda'
    out = {}
    if cuda:
        torch.cuda.synchronize(trainer.device)
        torch.cuda.reset_peak_memory_stats(trainer.device)
        out['resident_gib'] = torch.cuda.memory_allocated(
            trainer.device) / 2 ** 30
    t0 = time.perf_counter()
    pipeline = VideoSwapPipeline(
        unet=trainer.unet, vae=trainer.vae,
        text_encoder=trainer.text_encoder, tokenizer=trainer.tokenizer,
        sched=trainer.sched, adapter=trainer.adapter)
    with torch.no_grad():
        results = pipeline.validation(
            source_video=dataset.get_frames(),
            source_conditions=dataset.get_conditions(),
            source_prompt=dataset.prompt,
            editing_config=opt['val']['editing_config'],
            train_dataset=dataset, save_dir=opt['path']['visualization'],
            output_type='uint8')
    if cuda:
        torch.cuda.synchronize(trainer.device)
        out['peak_gib'] = torch.cuda.max_memory_allocated(
            trainer.device) / 2 ** 30
    out['s'] = time.perf_counter() - t0
    save_dir = os.path.join(opt['path']['visualization'],
                            f'iter_{global_step}')
    save_type = opt['val'].get('save_type', 'frame_gif')
    for key, frames in results.items():
        save_video_to_dir(frames, os.path.join(save_dir, key),
                          save_suffix=key, save_type=save_type)
    logger.info(f'validation saved to {save_dir}: '
                + ', '.join(f'{k} {v:.3f}' + (' GiB' if 'gib' in k else ' s')
                            for k, v in out.items()))
    return out


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--resume', action='store_true',
                        help='resume from the experiment\'s train state')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs the plain versions of the kernels "
                             "on the CPU; the default is 'cuda'")
    parser.add_argument('--distributed', action='store_true',
                        help='one rank of a torchrun world: the same steps '
                             'on every rank, rank 0 writes')
    try:
        train(os.path.abspath('.'), parser.parse_args(argv))
    finally:
        vdist.shutdown()


if __name__ == '__main__':
    main()
