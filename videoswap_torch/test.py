"""The swap CLI of the port: `python3 -m videoswap_torch.test -opt <yaml>
[--device cpu]` (the port of test.py).

It loads the config, builds the dataset (a frame directory and its TAP.pth)
and the models (the diffusers SD-1.5 directory, the AnimateDiff motion
module, the trained adapter), registers the persistent ED-LoRA concepts,
runs `VideoSwapPipeline.validation` over the config's editing prompts
(with `visualize_attention`, each swap's cross-attention heatmaps under
`<swap>_attention/`), writes the source video, every swap and its
`_vispoint` overlay under `results/<name>/visualization/`, and
`metrics.json` beside them: PSNR and temporal consistency, and with
`path.clip_model_path` (a local CLIP directory) the CLIP score of the source
against its prompt and of each swap against its target prompt. It runs on
the GPU unless `--device cpu` is given, and logs the wall-clock of each
stage: load, dataset, inversion, each swap (its steps and the VAE decode
inside it), save and metrics (with the CLIP scorer's build), and the
run's peak device memory (above what the calling process held on the card
when the run started).

Sharded: `torchrun --standalone --nproc_per_node DP*SP*TP -m
videoswap_torch.test -opt <yml> --shard DP,SP,TP [--device cpu]` runs the
swap over a (dp, sp, tp) mesh of the ranks (parallel/): each rank builds
the models on its device (`cuda:{LOCAL_RANK % device_count}`, or the CPU,
where the ranks talk through gloo), the U-Net is tensor-parallel over tp
and each rank runs its part of every call; the main process alone writes
the experiment directory, the frames, `metrics.json`, the CLIP scores and
the attention dumps, from the gathered results. A world size other than
DP*SP*TP is refused.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from videoswap_torch.builders import MIXED_PRECISION, build_models
from videoswap_torch.data import build_dataset
from videoswap_torch.pipelines import VideoSwapPipeline
from videoswap_torch.parallel import dist as vdist
from videoswap_torch.parallel import make_mesh, shard_pipeline
from videoswap_torch.pipelines.videoswap_pipeline import make_target_prompt
from videoswap_torch.utils.config import cfg_get, load_config, resolve_path
from videoswap_torch.utils.device import cli_device
from videoswap_torch.utils.logger import dict2str, get_logger, \
    set_path_logger
from videoswap_torch.utils.metrics import temporal_consistency, video_psnr
from videoswap_torch.utils.vis_util import save_video_to_dir


def _to_float_video(frames) -> np.ndarray:
    """uint8 (F, H, W, C) frames -> float in [0, 1]."""
    frames = np.asarray(frames)
    if frames.dtype != np.uint8:
        raise ValueError(f'metrics take uint8 frames, not {frames.dtype}')
    return frames.astype(np.float32) / 255.0


class ClipScorer:
    """CLIP(frames, prompt): 100 * max(0, cos) of each frame's image
    embedding with the prompt's text embedding, averaged over the frames.
    `embeds` and `score` are its two halves, so that a caller can hold the
    embeddings and the score of one call against another device's."""

    def __init__(self, model, tokenizer, device):
        self.model, self.tokenizer, self.device = model, tokenizer, device

    @torch.no_grad()
    def embeds(self, frames, prompt: str):
        """uint8 (F, H, W, 3) frames and a prompt -> (image embeddings
        [F, D], text embeddings [1, D]), each of unit length."""
        from videoswap_torch.models import clip_vision
        pix = clip_vision.preprocess_frames(
            _to_float_video(frames), self.model.vision_cfg.image_size,
            self.device)
        ids = self.tokenizer(prompt, padding='max_length', truncation=True,
                             max_length=77).input_ids
        # ED-LoRA concept tokens (ids >= vocab) are unknown to plain CLIP
        ids = np.minimum(np.asarray(ids, np.int64),
                         self.model.text_cfg.vocab_size - 1)
        return (self.model.image_embeds(pix),
                self.model.text_embeds(torch.as_tensor(ids,
                                                       device=self.device)))

    @staticmethod
    def score(img, txt) -> float:
        return float(((img @ txt[0]).clamp_min(0.0) * 100.0).mean())

    def __call__(self, frames, prompt: str) -> float:
        return self.score(*self.embeds(frames, prompt))


def make_clip_scorer(opt: dict, root_path: str, tokenizer, device):
    """The `ClipScorer` of `path.clip_model_path` (a local
    openai/clip-vit-large-patch14-style directory) on `device`, or None
    without the option; a directory that is not there logs a warning and
    gives None."""
    path = cfg_get(opt, 'path.clip_model_path')
    if not path:
        return None
    path = resolve_path(root_path, path)
    if not os.path.isdir(path):
        get_logger().warning(f'clip_model_path {path} missing; skipping '
                             'CLIP scores')
        return None
    from videoswap_torch.builders import build_clip_scorer
    return ClipScorer(build_clip_scorer(path, device), tokenizer, device)


def report_metrics(source_video, results: dict, save_dir: str,
                   clip_scorer=None, prompts: dict | None = None) -> dict:
    """Per swap: PSNR against the source (how much of the background and
    identity it kept), temporal consistency (a flicker proxy: compare with
    the source's own value) and, with a `clip_scorer`, CLIP(frames, prompt)
    for the source and each swap that `prompts` names. Logged and written
    to `metrics.json`."""
    logger = get_logger()
    prompts = prompts or {}
    src = _to_float_video(source_video)
    report = {'source': {
        'temporal_consistency_db': round(temporal_consistency(src), 3)}}
    if clip_scorer is not None and 'source' in prompts:
        report['source']['clip_score'] = round(
            clip_scorer(source_video, prompts['source']), 3)
    for key, frames in results.items():
        edit = _to_float_video(frames)
        h, w = edit.shape[1:3]
        entry = {'temporal_consistency_db':
                 round(temporal_consistency(edit), 3)}
        if src.shape[0] == edit.shape[0]:
            psnr_v = video_psnr(src[:, :h, :w], edit)
            entry['psnr_vs_source_db'] = (
                None if np.isinf(psnr_v) else round(psnr_v, 3))
        if clip_scorer is not None and key in prompts:
            entry['clip_score'] = round(clip_scorer(frames, prompts[key]), 3)
        report[key] = entry
        logger.info(f'metrics[{key}]: {entry}')
    with open(os.path.join(save_dir, 'metrics.json'), 'w') as f:
        json.dump(report, f, indent=2)
    return report


class StageClock:
    """Wall-clock marks of the swap's stages, the device synchronised at
    each: `step` is `validation`'s callback (one mark a step of the
    inversion and of each swap), `timed_decode` wraps the VAE decode."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == 'cuda'
        self.steps: dict[str, list[float]] = {}
        self.decodes: list[tuple[float, float]] = []

    def now(self) -> float:
        if self.cuda:
            torch.cuda.synchronize()
        return time.perf_counter()

    def step(self, stage, i, t, latents) -> None:
        self.steps.setdefault(stage, []).append(self.now())

    def timed_decode(self, decode):
        def wrapped(*args, **kwargs):
            t0 = self.now()
            out = decode(*args, **kwargs)
            self.decodes.append((t0, self.now()))
            return out
        return wrapped

    def swap_stages(self, t_start: float) -> dict:
        """{stage: {'s', 'step_s', ('decode_s')}} of one `validation`
        started at `t_start`: each swap from the end of what came before
        it to the end of its VAE decode."""
        out, prev = {}, t_start
        swaps = [k for k in self.steps if k != 'invert']
        if 'invert' in self.steps:
            marks = self.steps['invert']
            out['inversion'] = {'s': marks[-1] - prev, 'step_s': list(
                np.diff([prev] + marks))}
            prev = marks[-1]
        for key, (d0, d1) in zip(swaps, self.decodes):
            marks = self.steps[key]
            out[key] = {'s': d1 - prev,
                        'step_s': list(np.diff([prev] + marks)),
                        'decode_s': d1 - d0}
            prev = d1
        return out


def parse_shard(shard: str) -> tuple:
    shape = tuple(int(v) for v in shard.split(','))
    if len(shape) != 3 or min(shape) < 1:
        raise ValueError(f'--shard expects DP,SP,TP, got {shard!r}')
    return shape


def test(root_path: str, opt_path: str, device: str | None = None,
         shard: str | None = None) -> dict:
    """Run a swap config, sharded over the ranks of a torchrun world with
    `shard` ('DP,SP,TP'). Returns {'opt', 'pipeline', 'dataset', 'results',
    'metrics', 'timings', 'load_report'}; only the main process writes."""
    shape = parse_shard(shard) if shard else None
    opt = load_config(opt_path)
    device = cli_device(device)
    if shape is not None:
        vdist.maybe_initialize_distributed(True, device.type)
        if vdist.world_size() != int(np.prod(shape)):
            raise ValueError(f'--shard {shard} needs {int(np.prod(shape))} '
                             f'ranks; the world has {vdist.world_size()}')
        device = vdist.rank_device(device.type)
    main = vdist.is_main_process()
    set_path_logger(root_path, opt_path, opt, is_train=False)
    logger = get_logger()
    logger.info(dict2str(opt))
    clock = StageClock(device)
    if clock.cuda:
        torch.cuda.reset_peak_memory_stats(device)
        # what the calling process already holds on the card, not the run's
        resident = torch.cuda.memory_allocated(device)
    timings = {}

    t0 = clock.now()
    dtype = MIXED_PRECISION.get(opt.get('mixed_precision', 'no'),
                                torch.float32)
    load_report = {}
    pipeline = VideoSwapPipeline(**build_models(
        opt, root_path, device=device, dtype=dtype,
        seed=opt.get('manual_seed', 0), load_report=load_report))
    concept_cfg = cfg_get(opt, 'path.new_concept_cfg')
    if concept_cfg:
        from videoswap_torch.edlora import apply_new_concept_cfg
        with open(resolve_path(root_path, concept_cfg)) as f:
            apply_new_concept_cfg(pipeline, json.load(f))
    if shape is not None:
        pipeline = shard_pipeline(pipeline, make_mesh(shape))
        logger.info(f'sharded inference over mesh (dp,sp,tp)={shape}, '
                    f'{vdist.world_size()} ranks, backend '
                    f'{torch.distributed.get_backend()}')
    timings['load'] = clock.now() - t0

    t0 = clock.now()
    dataset_opt = dict(opt['datasets'])
    for k in ('path', 'tap_path'):
        if dataset_opt.get(k):
            dataset_opt[k] = resolve_path(root_path, dataset_opt[k])
    dataset = build_dataset(dataset_opt)
    source_video = dataset.get_frames()
    source_conditions = dataset.get_conditions()
    timings['dataset'] = clock.now() - t0

    save_dir = opt['path']['visualization']
    pipeline.vae.decode_video = clock.timed_decode(pipeline.vae.decode_video)
    t0 = clock.now()
    try:
        results = pipeline.validation(
            source_video=source_video, source_conditions=source_conditions,
            source_prompt=dataset.prompt,
            editing_config=opt['val']['editing_config'],
            train_dataset=dataset, save_dir=save_dir, output_type='uint8',
            callback=clock.step)
    finally:
        del pipeline.vae.decode_video         # the module's own method
    timings.update(clock.swap_stages(t0))

    t0 = clock.now()
    save_type = opt['val'].get('save_type', 'frame_gif')
    if main:
        save_video_to_dir(source_video, os.path.join(save_dir, 'source'),
                          save_suffix='source', save_type=save_type)
        for key, frames in results.items():
            save_video_to_dir(frames, os.path.join(save_dir, key),
                              save_suffix=key, save_type=save_type)
    timings['save'] = clock.now() - t0

    t0 = clock.now()
    metrics = None
    if main:
        clip_scorer = make_clip_scorer(opt, root_path, pipeline.tokenizer,
                                       device)
        prompts = None
        if clip_scorer is not None:
            prompts = {'source': dataset.prompt}
            for key, swap_cfg in opt['val']['editing_config'].get(
                    'editing_prompts', {}).items():
                prompts[key] = make_target_prompt(dataset.prompt, swap_cfg)
        metrics = report_metrics(source_video, results, save_dir,
                                 clip_scorer=clip_scorer, prompts=prompts)
    timings['metrics'] = clock.now() - t0
    if clock.cuda:
        timings['peak_gib'] = (torch.cuda.max_memory_allocated(device)
                               - resident) / 2**30
    for stage, v in timings.items():
        if isinstance(v, dict):
            steps = ' '.join(f'{s:.3f}' for s in v['step_s'])
            decode = (f', VAE decode {v["decode_s"]:.3f} s'
                      if 'decode_s' in v else '')
            logger.info(f'stage {stage}: {v["s"]:.3f} s (steps: {steps})'
                        f'{decode}')
        else:
            logger.info(f'stage {stage}: {v:.3f}'
                        + (' GiB' if stage == 'peak_gib' else ' s'))
    logger.info(f'results saved to {save_dir}' if main else
                f'rank {vdist.rank()}: done (the main process writes)')
    vdist.barrier('test')
    return dict(opt=opt, pipeline=pipeline, dataset=dataset, results=results,
                metrics=metrics, timings=timings,
                load_report=load_report)


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('-opt', type=str, required=True,
                        help='Path to option YAML file.')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs the plain versions of the kernels "
                             "on the CPU; the default is 'cuda'")
    parser.add_argument('--shard', type=str, default=None,
                        help='DP,SP,TP: sharded inference over the ranks of '
                             'a torchrun world of DP*SP*TP processes')
    args = parser.parse_args(argv)
    try:
        test(os.path.abspath('.'), args.opt, device=args.device,
             shard=args.shard)
    finally:
        vdist.shutdown()


if __name__ == '__main__':
    main()
