"""The ED-LoRA training CLI of the port: `python3 -m
videoswap_torch.train_edlora -opt <yaml> [--device cpu]` (the port of
train_edlora.py).

It reads a concept config as train_edlora.py does:

    name: 8101_edlora_catA
    manual_seed: 0
    mixed_precision: bf16
    path: {pretrained_model_path: pretrained_models/chilloutmix}
    concepts:
      catA1: {init_token: cat}      # tokens <catA1_0> ... <catA1_15>
    datasets:
      type: ConceptImageDataset
      image_dir: datasets/concepts/catA
      caption_template: a photo of a catA1
      resolution: 512
    models: {unet: {...}, ...}      # as the train CLI's; the motion
                                    # modules are forced off
    train:
      lora_rank: 4
      lora_alpha: 1.0
      lora_scope: attn              # or 'full'
      optimizer: {emb_lr: 1.e-3, lora_lr: 1.e-4, weight_decay: 0.01}
      max_grad_norm: 1.0
      total_iter: 100
    logger: {print_freq: 10, save_checkpoint_freq: 100}

The models come from `build_models` (the diffusers SD-1.5 directory, or
seeded random weights without one) with the motion modules off: ED-LoRA
finetunes the 2D U-Net, and the swap merges the factors into the 3D model
at edit time. The concepts are registered in config order (their rows'
order in the text encoder's extra table) and warm-started from their
init token's embedding; the VAE posterior moments of every image are
encoded once; each step takes the next image of an order shuffled by
numpy from `manual_seed` (reshuffled after each pass) and one
`EDLoRATrainer.step`. Every `logger.print_freq` steps a MessageLogger
line; every `logger.save_checkpoint_freq` steps and at the last one
`models/models_<step>/edlora_model-latest.pth` (the file a swap config's
`lora_path` names; its name keeps 'edlora', which turns the per-layer
concepts on at load) and `new_concept_cfg.json` beside it; the step-time
summary at the end. It runs on the GPU unless `--device cpu` is given.
`--shard` (tensor-parallel training over several devices) is not ported
(ROADMAP.md Queue 1 item 9) and is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import random

import numpy as np
import torch

from videoswap_torch.builders import MIXED_PRECISION, build_models
from videoswap_torch.data import build_dataset
from videoswap_torch.edlora_train import (EDLoRATrainer,
                                          init_concept_embedding, lora_sites,
                                          register_concepts,
                                          save_edlora_checkpoint,
                                          tokenize_layer_prompts)
from videoswap_torch.utils.config import load_config, resolve_path
from videoswap_torch.utils.device import cli_device
from videoswap_torch.utils.logger import (MessageLogger, dict2str,
                                          get_logger, set_path_logger)
from videoswap_torch.utils.profiling import StepTimer

CHECKPOINT = 'edlora_model-latest.pth'


def train(root_path: str, args) -> dict:
    """Run a concept config. `args`: `opt` (the YAML), `device` (None
    means 'cuda'), `shard`. Returns {'opt', 'trainer', 'train_params',
    'optimizer', 'new_concept_cfg', 'dataset', 'losses', 'step_s',
    'checkpoints' (the files written, by step)}."""
    if getattr(args, 'shard', None):
        raise NotImplementedError(
            '--shard: tensor-parallel ED-LoRA training is not ported '
            '(ROADMAP.md Queue 1 item 9)')
    device = cli_device(getattr(args, 'device', None))
    opt = load_config(args.opt)
    set_path_logger(root_path, args.opt, opt, is_train=True)
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
    for k in ('image_dir', 'captions_file'):
        if dataset_opt.get(k):
            dataset_opt[k] = resolve_path(root_path, dataset_opt[k])
    dataset = build_dataset(dataset_opt)

    models_opt = dict(opt.get('models', {}))
    unet_opt = dict(models_opt.get('unet', {}))
    unet_opt['unet_cfg'] = dict(unet_opt.get('unet_cfg', {}),
                                use_motion_module=False)
    models_opt['unet'] = unet_opt
    models = build_models(dict(opt, models=models_opt), root_path,
                          device=device, dtype=dtype, seed=seed)
    tokenizer = models['tokenizer']

    # concepts in config order: their order is the extra rows' order
    concepts = opt['concepts']
    new_concept_cfg = register_concepts(tokenizer, list(concepts))
    concept_emb = {name: init_concept_embedding(
        models['text_encoder'], tokenizer, (c or {}).get('init_token', name))
        for name, c in concepts.items()}
    first_tokens = [c['concept_token_names'][0]
                    for c in new_concept_cfg.values()]
    logger.info(f'registered concepts: {first_tokens} ...')

    train_opt = opt['train']
    scope = train_opt.get('lora_scope', 'attn')
    unet_sites = lora_sites(models['unet'], 'unet', scope)
    text_sites = lora_sites(models['text_encoder'], 'text_encoder', scope)
    logger.info(f'LoRA sites: unet {len(unet_sites)}, text_encoder '
                f'{len(text_sites)} (scope={scope})')

    trainer = EDLoRATrainer(
        unet=models['unet'], text_encoder=models['text_encoder'],
        vae=models['vae'], sched=models['sched'], unet_sites=unet_sites,
        text_sites=text_sites,
        alpha=float(train_opt.get('lora_alpha', 1.0)),
        tune_cfg=train_opt.get('tune_cfg', {}),
        optimizer_cfg=train_opt.get('optimizer', {}),
        max_grad_norm=train_opt.get('max_grad_norm'))
    gen = torch.Generator(device=device).manual_seed(seed)
    train_params = trainer.init_train_params(
        gen, concept_emb, rank=int(train_opt.get('lora_rank', 4)))
    optimizer = trainer.init_state(train_params)

    # per image: the caption's 16 layer-variant ids, and the VAE posterior
    # moments, encoded once
    ids_all = torch.as_tensor(np.stack([
        tokenize_layer_prompts(tokenizer, dataset[i]['caption'],
                               new_concept_cfg)
        for i in range(len(dataset))]), device=device)     # (N, 16, 77)
    pixels = torch.from_numpy(dataset.pixels)[:, None].to(device, dtype)
    with torch.no_grad():
        mean, logvar = trainer.vae.encode_video_moments(pixels)
    logger.info(f'cached VAE posterior moments for {len(dataset)} images')

    logger_msg = MessageLogger(opt, 0)
    timer = StepTimer(sync=True)
    total_iter = int(train_opt['total_iter'])
    print_freq = int(opt['logger'].get('print_freq', 10))
    save_freq = int(float(opt['logger'].get('save_checkpoint_freq',
                                            total_iter)))
    lr = float(train_opt.get('optimizer', {}).get('lora_lr', 1e-4))
    losses, checkpoints = [], {}

    order = np.random.permutation(len(dataset))
    for global_step in range(1, total_iter + 1):
        i = int(order[(global_step - 1) % len(dataset)])
        if global_step % len(dataset) == 0:
            order = np.random.permutation(len(dataset))
        batch = {'input_ids': ids_all[i], 'latent_mean': mean[i:i + 1],
                 'latent_logvar': logvar[i:i + 1]}
        timer.start()
        loss = trainer.step(train_params, optimizer, batch, gen)
        timer.stop(loss)
        losses.append(loss.item())

        if global_step % print_freq == 0:
            logger_msg({'iter': global_step, 'lrs': [lr],
                        'total_loss': losses[-1],
                        'step_time': timer.times[-1]})

        if global_step % save_freq == 0 or global_step == total_iter:
            mdir = os.path.join(opt['path']['models'],
                                f'models_{global_step}')
            ckpt = os.path.join(mdir, CHECKPOINT)
            save_edlora_checkpoint(ckpt, train_params, unet_sites,
                                   text_sites)
            with open(os.path.join(mdir, 'new_concept_cfg.json'), 'w') as f:
                json.dump(new_concept_cfg, f, indent=2)
            checkpoints[global_step] = ckpt
            logger.info(f'saved ED-LoRA checkpoint: {ckpt}')

    s = timer.summary()
    if s:
        logger.info(
            f'step time: mean {s["mean_s"]:.3f}s  p50 {s["p50_s"]:.3f}s  '
            f'p90 {s["p90_s"]:.3f}s over {s["steps"]} steps '
            f'(total {s["total_s"]:.1f}s)')
    logger.info('ED-LoRA training done')
    return dict(opt=opt, trainer=trainer, train_params=train_params,
                optimizer=optimizer, new_concept_cfg=new_concept_cfg,
                dataset=dataset, losses=losses, step_s=list(timer.times),
                checkpoints=checkpoints)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs the plain versions of the kernels "
                             "on the CPU; the default is 'cuda'")
    parser.add_argument('--shard', type=int, default=None,
                        help='tensor-parallel training: not ported')
    train(os.path.abspath('.'), parser.parse_args(argv))


if __name__ == '__main__':
    main()
