#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videoswap_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,kernels,unrouted,unet,small,dpm_small,sample,train_small,train,edlora_small,edlora,blend_small,blend,recipe,clip_attn,train_recipe,semantic_points,atlas_small,atlas,atlas_recipe]

Phases (all by default):

- build:       compile the CUDA kernels from videoswap_torch/csrc/ (nvcc,
               sm_90a, one process per source) and print the build time and
               each kernel's registers/spills;
- kernels:     each kernel against its plain PyTorch version at the shapes of
               the 16-frame 512x512 CFG swap (forward kernels) and of the
               16-frame 512x512 training step (flash backward kernels),
               bf16, with the tolerance stated; times of both with CUDA
               events, the bound of the same work at the H100's published
               peaks and, where one PyTorch call computes the same function,
               that call's time (scaled_dot_product_attention; timed here
               only, never on the port's path), every shape's numbers kept
               (`shapes`), the attention kernels' log lines with the exp
               floor too (one exponential a logit at the special-function
               units' rate); GEGLU by its width's route (the fused kernel
               at C <= 640; above it the split route, its gate pass also
               checked entry by entry and timed alone), beside the two
               cuBLAS products alone; temporal attention also at tiling
               edges (location counts that are not a multiple of a work
               item's, F = 1, 7, 17, 32), two calls bitwise equal at every
               shape; one gradient check each of the GEGLU
               and temporal-attention autograd Functions; the hash-grid
               table-gradient kernel (fp32) against its plain version at
               the atlas levels' table sizes and 240000 rows,
               with index_add_ as the library call, two calls (and both
               forms of its scatter) on the same inputs bitwise equal, NaN
               and infinite rows leaving their entries as the plain
               version does; one main step's 16 levels in one call, each
               level bit-equal to hash_table_grad_fixed on it alone, timed
               beside the 16 one-level calls and 16 index_add_ calls, with
               its launch count; and
               the hash encoding's gradients on the card against the CPU;
               the fused
               temporal-transformer kernel in both layouts at U-Net levels 0
               (C = 320, with the FFN) and 1 (C = 640, the attention half),
               timed beside the layer-wise module it replaces, and its
               autograd Function's gradients; then the recipe path's
               forward kernels again at the 1009 recipe's 448x768 shapes
               (recipe_shape_kernels: 56x96 latents, batch 1 and 2, GEGLU
               and the flash forward at every level, the fused temporal
               transformer at levels 0-1, temporal attention at 2-3), at
               the same limits; then the ED-LoRA path's flash forward and
               backward kernels and GEGLU at its shapes (edlora_shape_
               kernels: one 512x512 image, 8 heads, B.H = 8), timed beside
               SDPA and the cuBLAS products;
- unrouted:    the fifth slice's path, the port's counterpart of the JAX
               package's two never-routed kernels and of the scripts that
               run them (scripts/bench_spatial_attn.py,
               scripts/bench_resnet_fused.py): spatial self-attention at
               (32, 4096, 320) and (32, 1024, 640), 8 heads, and the fused
               GroupNorm-SiLU-conv3x3 at 32x64x64x320 and 32x32x32x640,
               each once through its public wrapper, then on the full-width
               U-Net's own inputs: one 16-frame 512x512 CFG forward with
               pre-hooks on the first transformer block's attn1 and the
               first ResnetBlock3D of levels 0 and 1; the spatial kernel
               against the flash route (dot_product_attention) on the
               hooked attn1's q, k, v, and the conv kernel, fed the video's
               GroupNorm statistics, against the module's own
               conv1(silu(norm1(x))); then each kernel against its plain
               version at the benchmark shapes, timed beside its bound,
               scaled_dot_product_attention and the flash forward kernel
               (spatial) or cuDNN's conv2d alone and the group_norm, silu,
               conv2d chain (conv), the conv's two calls bitwise equal at
               both shapes, its tiling and its registers and spills (the
               build log's lines);
- unet:        one full-width U-Net forward (512x512, 2 frames, CFG, adapter
               residuals): the kernel path on the GPU in bf16 against the
               plain path on the CPU in fp32, same weights and inputs;
- small:       `sample` at 256x256, 2 frames, 2 DDIM steps: GPU bf16 latents
               against the CPU fp32 pipeline;
- dpm_small:   the same with `sampler='dpmpp_2m'` and DPM_STEPS steps, at
               the same limit; and the DPM-Solver++(2M) step on the card
               (fp32) against its float64 restatement (dpm_step_reference)
               at second-order steps of 5- and 20-step schedules;
- sample:      the first slice's path, `VideoSwapPipeline.sample` at full
               width: 16 frames, 512x512, CFG 7.5, point adapter with 10
               points, 4 DDIM steps, VAE decode; the launch count of every
               forward kernel must be > 0;
- train_small: `VideoSwapTrainer.loss_fn`, its backward and one AdamW step
               at full width, 256x256, 4 frames, the same draws on both
               sides: the loss, the flattened adapter gradient and the change
               of the adapter's weights, GPU bf16 against CPU fp32, and the
               share of adapter weights the step moved;
- train:       this slice's path, `VideoSwapTrainer.step` at full width: 16
               frames, 512x512, 10 points, cached VAE moments, 'edges'
               gradient checkpointing, AdamW on the adapter, TRAIN_STEPS
               steps; the losses must be finite, the steps must move the
               adapter's weights and the launch count of every kernel must be
               > 0 (the recompute of the level-0 layers in the backward
               launches the forward kernels again, and is counted);
- edlora_small: the ED-LoRA trainer (videoswap_torch.edlora_train) on the
               2D SD-1.5-width models at 64x64, 128 + 48 LoRA sites, alpha
               EDLORA_ALPHA, non-zero factors, the same inputs and draws:
               the loss and each group's gradient (the embeddings, the
               factors), GPU bf16 against CPU fp32; then the trainer's two
               AdamW updates (each group clipped by its own norm) against
               the script's restatement of optax's on the card;
- edlora:      the ED-LoRA CLI's path (`videoswap_torch.train_edlora`) on
               train_edlora.py's docstring configuration at SD-1.5 width
               (EDLORA_YAML, written with EDLORA_IMAGES synthetic 512x512
               concept images): EDLORA_STEPS bf16 steps; the losses finite,
               the embeddings and both factor groups moved, every frozen
               weight bit-equal after the run, the checkpoint's keys the
               sites', the flash forward, dQ, dK/dV and GEGLU kernels
               launched; the file reloaded through load_edlora_into_pipeline
               into the 3D pipeline, every merged weight bit-equal to
               W + alpha up @ down from the file; the step times, peak
               memory and launches a step;
- blend_small: `VideoSwapPipeline.validation` at full width, 256x256, 2
               frames, 5 DDIM steps (the fewest that open the latent-blend
               window): inversion with attention stores, one swap with a
               synthetic ED-LoRA file, cross and self replacement 0.5 and
               latent blending, in both recompute-self tiers; GPU bf16 latents
               against the CPU fp32 pipeline, the merged weights restored,
               and, in a third GPU run at blend threshold BLEND_CHECK_TH, the
               blend seen (BlendCheck: at each blended step, the share of
               latents equal to the inversion's bit for bit, which is where
               the blend mask put them back, must exceed the chance share
               of the other steps and stay below 1);
- blend:       the fourth slice's path, `validation` on a synthetic 16-frame
               512x512 video: the `man_to_hermione` swap of options/
               train_videoswap/human/1009_final_ss1010_manwalking_T07_Iter50
               (a synthetic ED-LoRA file, alpha 0.7, cross and self
               replacement 0.5, adapter guidance 0.4, CFG 7.5, the file's
               negative prompt and t2i window), recompute-self tier, 5 DDIM
               steps; seconds a step of the inversion and of the edit, the
               merge and restore, peak memory and launches; the frames must
               be finite and the fused kernel must launch;
- recipe:      the swap CLI's path (`videoswap_torch.test`)
               on two shipped test configs (RECIPES: the 1009 blend recipe
               at 448x768 and the 2001 DPM++ recipe at 512x512), their file
               paths rewritten into a synthetic experiment tree in a
               temporary directory (write_experiment_tree, write_clip: the
               pipeline's full-width weights in fp16 under the published
               file and key names, a generated CLIP vocabulary, an adapter
               .pth, ED-LoRA files, 64 PNG frames at 512x512, TAP.pth files)
               and each cut listed on a '#' line of the rewritten file; then
               `validation` called directly on the CLI's models: every
               tensor loaded as written with 0 missing and 0 unused keys,
               the CLI's frames equal to the direct call's (RECIPE_REL_TOL;
               bit-equality printed), the `_vispoint` frames changed only in
               the discs of the visible, selected points, metrics.json and
               the frame files written, every forward kernel launched; the
               stage times, each swap's steps and VAE decode, peak memory;
               the 1009 recipe also with visualize_attention and
               path.clip_model_path (a ViT-L/14 config.json): its swap's
               heatmap strip and the CLIP scores of the source and the swap
               written;
- clip_attn:   the swap CLI's CLIP scorer (make_clip_scorer: ViT-L/14,
               random weights from the seeded CPU generator) on the 1009
               recipe CLI run's source and swap, with its tokenizer, GPU
               against CPU (fp32): the image and text embeddings and each
               score, and the CPU's scores against the clip_score values
               the CLI wrote to metrics.json; then the
               attention dumps of `validation(visualize_attention)`:
               blend_small's swap on the card, its dump of the summed stores
               (probabilities: each row sums to 1), and the one-pass dump
               of its frames on the card against the CPU;
- train_recipe: the train CLI's path (`videoswap_torch.train`) on the
               shipped 2001 training config (TRAIN_RECIPE: 16 frames,
               512x512, fp16 as bf16, the kitten_to_catA ED-LoRA swap with
               latent blending at val_freq) in the recipe phase's tree,
               each cut on a '#' line: 2 steps, then --resume to 4 with the
               validation at step 4; the resumed run must start at step 2
               from the saved adapter and AdamW state bit for bit, the
               losses be finite, the 4 steps move >= TRAIN_MOVED_MIN of
               the adapter's weights, every training kernel launch and
               visualization/iter_4/<swap> hold 16 frames;
               models_4/adapter.pth must load strictly into a fresh
               adapter as the trained weights bit for bit; and the CLI's
               first 2 losses and adapter update must agree with
               `VideoSwapTrainer.step` called directly on its models
               (TRAIN_CLI_LOSS_TOL, TRAIN_CLI_UPDATE_TOL, from the spread
               of two direct runs, which is printed); the CLI's step
               times, the train phase's, and the validation's wall-clock
               and peak memory are printed;
- semantic_points: the semantic-point CLI's path
               (`videoswap_torch.extract_semantic_point`) with the models of
               the shipped options/test_videoswap/animal/2003_swan_*.yml
               (SP_CONFIG, rewritten into the recipe phase's tree, each cut
               on a '#' line), on a synthetic clip of 64 PNG frames at
               854x480 (atlas_clip: known motion) with a keyframe annotation
               at frame 8 (five named points, one empty entry) and seeded
               synthetic cotracker_stride_4_wind_8.pth, body_pose_model.pth
               (its heat biases calibrated on the clip's first frame, so
               that the decode finds people) and UniMatch files under the
               published key sets: the object
               path with the DIFT tracker, with the native CoTracker
               ($VS_COTRACKER_CKPT), the human path on 8 frames
               (--pose_ckpt), and `extract_flow --method unimatch` on two
               pairs; then the checks: the source each run logged, the
               forward kernels launched, the TAP files' keys and shapes
               (keypoints found on the human path), the human TAP against
               the CPU (frame 0's keypoints the CPU detector's, the
               embedding the CPU's on the TAP's tracks and the CLI's
               features), the
               2003 config's dataset reading the TAP (Resize 448x768) and
               the adapter taking its embeddings once, the featurizer's
               kernels against their plain versions at its shapes (batch 1,
               8 draws on the frame axis, the 60x106 latent's ragged levels;
               dift_shape_kernels), the features' shape (the up_block_1
               tap's), one frame's features on the card (bf16, the
               featurizer's second call) against the CPU (fp32), the
               DIFT tracker on the card against the CPU fed the same
               features, the patch-descriptor stand-in's tracks against the
               known motion, and CoTracker, OpenPose (maps and people) and
               UniMatch on the card (fp32, TF32 off) against the CPU (the
               CPU's inputs cut: SP_SUB, SP_CROP), CoTracker's frames before
               the query filled by its backward run, and OpenPose finding
               people; each stage's seconds and the peak memory;
- atlas_small: the atlas_swan nets at full width (2^19 hash table) on an
               8-frame 128x96 synthetic clip, batch 10000: one main step and
               one inverse step on the same params and draws, GPU against
               CPU, both fp32: each loss term, each net's gradient (the hash
               table's apart) and each net's change under Adam's first step;
- atlas:       the third slice's path, layered-neural-atlas training at
               the published size: a synthetic 72-frame 768x448 clip built
               on the card, UV pretraining of both mappings (cut to
               ATLAS_PRETRAIN_ITER iterations a frame), ATLAS_STEPS
               iterations of main step + inverse step at batch 10000 (the
               losses must be finite and fall, the hash kernel must launch
               once a main step: all 16 levels in one launch), the
               reconstruction PSNR of 4 frames
               and one propagated point drag;
- atlas_recipe: the shape-change chain through the port's three CLIs on
               the shipped options/train_atlas/atlas_swan.yml (ATLAS_RECIPE:
               its nets, batch and losses as written; each cut on a '#'
               line of the rewritten file): 72 synthetic PNG frames and
               masks at 854x480 (atlas_clip's disk and background, known
               motion), `videoswap_torch.extract_flow --method matching`
               (71 pairs), `videoswap_torch.train_atlas` (pretraining as
               shipped, 200 iterations, the validation at 200, checkpoints
               at 100 and 200),
               `videoswap_torch.propagate_point_displacement` (a drag of
               two of three named points on the disk by ATLAS_DRAG px) to
               annotation/TAP_duck.pth; then the checks: the flows' medians
               on the disk and the background against the known motion,
               the CLI's flow file against a direct call, the card's flow
               against the CPU's on two pairs (ATLAS_FLOW_OFF_SHARE,
               ATLAS_FLOW_MEDIAN_TOL) and its box filter alone
               (ATLAS_BOX_FILTER_TOL), the CLI's logged losses bit-equal
               to an AtlasTrainer driven directly from the same seed, one
               hash launch a main step, the checkpoint reloaded bit-equal
               into fresh nets and their PSNR equal to the logged one,
               every validation file present, a full evaluation of
               ATLAS_FULL_EVAL_FRAMES frames with every file present, the
               TAP file equal to a direct propagation, with the source's
               keys, names and shapes, finite or -1 tracks, the undragged
               track kept, and the dragged tracks within ATLAS_TAP_CPU_PX
               of a propagation through the nets moved to the CPU, hidden
               in the same frames (ATLAS_TAP_ALPHA_MARGIN); the keyframe
               points' distances to source and target printed, not
               checked; the seconds of each stage and the peak memory.

Launch counts are set to 0 just before the unrouted, sample, train,
edlora, blend, recipe, train_recipe, semantic_points, atlas and atlas_recipe
paths and read
just after each (a recipe's run: the CLI, before the direct `validation`;
train_recipe: each CLI run, the two summed, not the direct steps;
semantic_points: its three CLI runs; atlas_recipe: the three CLIs, not the
direct trainer). scripts/fault_control.py shows
that the unet, small, train_small, blend_small, atlas_small and unrouted
limits fail a kernel with a planted fault, dpm_small's and the recipe
phase's checks a fault on the recipe's path, train_recipe's resume
check a resume that starts a fresh AdamW, atlas_recipe's checks five
faults of the shape-change chain, semantic_points' checks five faults
of its path on the card, edlora_small's checks a merge without alpha and
one gradient clip over both groups, and clip_attn's checks CLIP
preprocessing without its normalisation and summed attention maps not
divided by the step count;
scripts/profile_step.py breaks one full-width U-Net step, training step or
atlas iteration down by device time.

Weights are random, drawn from a seeded torch.Generator. The script fails
(exit code 1, no result line) without a CUDA device, outside a checkout of
the repository, or when any phase fails. Its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import copy
import functools
import json
import math
import os
import re
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ('build', 'kernels', 'unrouted', 'unet', 'small', 'dpm_small',
          'sample', 'train_small', 'train', 'edlora_small', 'edlora',
          'blend_small', 'blend', 'recipe', 'clip_attn', 'train_recipe',
          'semantic_points', 'atlas_small', 'atlas', 'atlas_recipe')
SEED = 0
FRAMES, SIZE, POINTS = 16, 512, 10
STEPS = 4          # DDIM steps of the full-width sample (a smoke run's time)
TRAIN_STEPS = 3    # AdamW steps of the full-width training run
# the slice's tuning (scripts/bench_train.py of the JAX package)
TRAIN_TUNE = {'drop_rate': 0.2, 'min_timestep': 0.5, 'loss_type': 'global'}
TRAIN_LR = 1e-5
# the blended path: DDIM steps (the fewest that open the latent-blend window,
# 0.2 N < step < 0.8 N), the synthetic ED-LoRA file's rank, and
# options/train_videoswap/human/1009_final_ss1010_manwalking_T07_Iter50's
# dataset prompt and val block, written out (the recipe phase reads the
# shipped files themselves through the port's YAML reader): the
# man_to_hermione swap, alpha 0.7, with the block's negative prompt,
# adapter guidance and t2i window
BLEND_STEPS = 5
LORA_RANK = 4
BLEND_PROMPT = 'a man is walking in front of trees and grass'
BLEND_NEGATIVE = ('longbody, lowres, bad anatomy, bad hands, missing fingers, '
                  'extra digit, fewer digits, cropped, worst quality, low '
                  'quality')
BLEND_CONCEPTS = ('<hermione1>', '<hermione2>')
BLEND_SWAP = {'replace': 'man -> <hermione1> <hermione2>',
              'blend_cfg': {'cross_replace_steps': 0.5,
                            'self_replace_steps': 0.5},
              't2i_guidance_scale': 0.4}
BLEND_LORA_ALPHA = 0.7
# blend_small's exact-match check of the latent blend (BlendCheck) runs the
# swap once more on the card at this blend threshold. With random weights the
# cross-attention maps are nearly flat: at the swap's own 0.3, and up to
# 0.95, the mask is 1 everywhere and the blend changes only rounding, so no
# check can see it skipped. At 0.99 the mask is 0 on about half of the
# latents (on the H100: exact-match shares 0.37-0.48 at the two blended
# steps against <= 6e-4 by chance at the others, and 0 with the blend
# skipped, scripts/fault_control.py)
BLEND_CHECK_TH = 0.99
# dpm_small: DPM-Solver++(2M) steps of the 256x256 sample (steps 1 to 3 take
# the second-order update: the first is first order, and the last when there
# are fewer than 15); its latents are held to the CPU's at SAMPLE_REL_TOL.
# The step itself, on the card in fp32 against its float64 restatement
# (dpm_step_reference), relative L2: fp32 rounding of x, x0 and the lambda
# differences, ~1e-7; a step that skips the second-order correction is off
# by ~1e-2 (scripts/fault_control.py)
DPM_STEPS = 5
DPM_STEP_TOL = 1e-5
# the recipe phase: shipped swap configs run through the CLI
# (videoswap_torch.test) on a synthetic experiment tree (write_experiment_tree,
# write_clip): their file paths point into the tree, and each cut is listed
# on a '#' line of the rewritten config. The CLI's frames against
# `validation` called directly on its models, relative L2 of the uint8
# frames: the same kernels on the same inputs in the same process
RECIPE_FRAMES = 64             # the clip's frames (total_frames of both)
RECIPE_REL_TOL = 1e-3
TAP_NAMES = ('head', 'neck', 'body', 'tail', 'left_front_leg',
             'right_front_leg', 'left_back_leg', 'right_back_leg',
             'left_ear', 'right_ear')
_SYNTHETIC = ('the paths point at a synthetic tree: random weights from a '
              'seed under the published file and key names, 64 frames of a '
              'synthetic 512x512 clip, a TAP.pth of 10 random tracks')
RECIPES = {
    '1009': {
        'path': 'options/test_videoswap/human/'
                '1009_final_ss1010_manwalking_T07_Iter50/'
                '1009_final_ss1010_manwalking_T07_Iter50.yml',
        'swap': 'man_to_hermione', 'lora': 'edlora_hermione.pth',
        'alpha': BLEND_LORA_ALPHA, 'concepts': BLEND_CONCEPTS,
        'tap': 'TAP_1009.pth', 'frame_hw': (448, 768),
        'values': {'val.editing_config.num_inference_steps': 5,
                   'val.save_type': 'frame',
                   'val.editing_config.visualize_attention': 'true'},
        'clip': True,
        'cuts': ['cut: num_inference_steps 50 -> 5 (the fewest that open '
                 'the latent-blend window)',
                 'cut: one editing prompt of five (man_to_hermione)',
                 'cut: save_type video -> frame (PNG frames)',
                 'not a cut: visualize_attention true and '
                 'path.clip_model_path (a ViT-L/14 config.json, random '
                 'weights) added, so that the swap CLI\'s attention dumps '
                 'and CLIP scores run', _SYNTHETIC]},
    '2001': {
        'path': 'options/test_videoswap/animal/2001_catheadturn_T05_Iter100/'
                '2001_catheadturn_dpmpp20.yml',
        'swap': 'kitten_to_catA', 'lora': 'edlora_catA.pth', 'alpha': 1.0,
        'concepts': ('<catA1>', '<catA2>'), 'tap': 'TAP_2001.pth',
        'frame_hw': (512, 512),
        'values': {'val.save_type': 'frame',
                   'val.editing_config.editing_prompts.kitten_to_catA.'
                   'select_point': '[head, tail]'},
        'cuts': ['cut: one editing prompt of two (kitten_to_catA)',
                 'cut: save_type video -> frame (PNG frames)',
                 'not a cut: select_point [head, tail] on kitten_to_catA, '
                 'so that the point overlay\'s selection runs (the shipped '
                 '3004 and 3009 configs select points so)', _SYNTHETIC]},
}

# the train_recipe phase: the shipped training config through the train CLI
# (videoswap_torch.train) in the recipe phase's tree, run for 2 steps, then
# resumed to 4; its cuts on '#' lines as RECIPES' are
TRAIN_RECIPE = {
    'path': 'options/train_videoswap/animal/2001_catheadturn_T05_Iter100/'
            '2001_catheadturn_T05_Iter100.yml',
    'swap': 'kitten_to_catA', 'lora': 'edlora_catA.pth', 'alpha': 1.0,
    'tap': 'TAP_2001.pth',
    'values': {'logger.save_checkpoint_freq': 2, 'val.val_freq': 4,
               'val.editing_config.num_inference_steps': 5,
               'val.save_type': 'frame'},
    'cuts': ['cut: total_iter 100 -> 4 (2 steps, then 2 more on --resume)',
             'cut: save_checkpoint_freq 100 -> 2',
             'cut: val_freq 100 -> 4',
             'cut: num_inference_steps 50 -> 5 (the fewest that open the '
             'latent-blend window)',
             'cut: one editing prompt of three (kitten_to_catA)',
             'cut: save_type video -> frame (PNG frames)', _SYNTHETIC]}
TRAIN_RECIPE_ITERS = (2, 4)
# the CLI's first TRAIN_RECIPE_ITERS[0] steps against VideoSwapTrainer.step
# called directly on its models: the losses (largest relative difference)
# and the change of the adapter's weights (relative L2). On the H100 the two
# direct runs and the CLI gave the same bits, losses and update (spread 0,
# the phase's first run), so the limits allow a few fp32 roundings and no
# more (two steps of lr 5e-4 alone move the loss on the same draws by
# 2.7e-3: the resumed run's steps 3-4 against steps 1-2)
TRAIN_CLI_LOSS_TOL = 1e-6
TRAIN_CLI_UPDATE_TOL = 1e-4

# the 1009 recipe's geometry (448x768 frames, 56x96 latents): the U-Net
# levels' token counts 5376, 1344, 336 and 84, of which only level 0's is a
# multiple of the attention kernels' 128-row query blocks (the benchmark
# shapes' 4096, 1024 and 256 all are, and 64 is one consumer's block); the
# U-Net runs them at batch 1 (the inversion, and the CFG prefix it runs once)
# and 2 (the CFG batch). The kernels phase holds the recipe path's forward
# kernels against their plain versions at these shapes too
# (recipe_shape_kernels), at the limits of TOL
RECIPE_BATCHES = (1, 2)


def recipe_levels() -> list:
    """(latent height, width, C) of the four U-Net levels at the 1009
    recipe's frame size."""
    h8, w8 = (s // 8 for s in RECIPES['1009']['frame_hw'])
    return [(h8 >> i, w8 >> i, c)
            for i, c in enumerate((320, 640, 1280, 1280))]


# kernel -> (module, launch counter, source, TPU kernel it replaces)
KERNELS = {
    'geglu_ffn': ('geglu_ffn', 'launches', 'videoswap_torch/csrc/geglu_ffn.cu',
                  'videoswap_tpu/ops/geglu_ffn.py:110'),
    # the gate pass of GEGLU's split route (C > 640), the JAX package's XLA
    # route there: no Pallas kernel
    'geglu_gate': ('geglu_ffn', 'gate_launches',
                   'videoswap_torch/csrc/geglu_ffn.cu',
                   'videoswap_tpu/ops/geglu_ffn.py:133'),
    'temporal_attention': (
        'temporal_attention', 'launches',
        'videoswap_torch/csrc/temporal_attention.cu',
        'videoswap_tpu/ops/temporal_attention.py:96'),
    'flash_attention_fwd': (
        'flash_attention', 'launches', 'videoswap_torch/csrc/flash_attention.cu',
        'videoswap_tpu/ops/flash_attention.py:91'),
    'flash_attention_bwd_dq': (
        'flash_attention', 'bwd_dq_launches',
        'videoswap_torch/csrc/flash_attention_bwd.cu',
        'videoswap_tpu/ops/flash_attention.py:194'),
    'flash_attention_bwd_dkv': (
        'flash_attention', 'bwd_dkv_launches',
        'videoswap_torch/csrc/flash_attention_bwd.cu',
        'videoswap_tpu/ops/flash_attention.py:213'),
    'hash_table_grad': (
        'hash_table_grad', 'launches', 'videoswap_torch/csrc/hash_table_grad.cu',
        'videoswap_tpu/ops/hash_table_grad.py:125'),
    'fused_temporal': (
        'fused_temporal', 'launches', 'videoswap_torch/csrc/fused_temporal.cu',
        'videoswap_tpu/ops/fused_temporal.py:243'),
    'fused_temporal_bfhw': (
        'fused_temporal', 'bfhw_launches',
        'videoswap_torch/csrc/fused_temporal.cu',
        'videoswap_tpu/ops/fused_temporal.py:282'),
    'spatial_self_attention': (
        'spatial_attention', 'launches',
        'videoswap_torch/csrc/spatial_attention.cu',
        'videoswap_tpu/ops/spatial_attention.py:108'),
    'gn_silu_conv': ('gn_silu_conv', 'launches',
                     'videoswap_torch/csrc/gn_silu_conv.cu',
                     'scripts/bench_resnet_fused.py:102'),
}
# the path whose launch count the kernels line reports for each kernel
# ('sample_4d': the sample path run again with FT_4D, the frame-major layout)
KERNEL_PATH = {'hash_table_grad': 'atlas', 'fused_temporal_bfhw': 'sample_4d',
               'spatial_self_attention': 'unrouted',
               'gn_silu_conv': 'unrouted'}
FORWARD_KERNELS = ('geglu_ffn', 'geglu_gate', 'temporal_attention',
                   'flash_attention_fwd', 'fused_temporal')
# max |kernel - plain| allowed, bf16 kernel vs fp32 plain on the same bf16
# inputs: outputs are O(1) and rounded once to bf16 (2^-8 relative), plus
# the bf16 rounding of the intermediate (gated product, probabilities). The
# backward's gradients are far from O(1) (dq ~ 1e-2 at S = 4096), so their
# error is taken relative to the largest |plain| entry: bf16 rounding of
# P, dS and the output, summed over many keys or queries
# the fused temporal transformer's outputs (x + the module) reach ~10 at
# the level-0 shape, where a bf16 ulp is 0.06, after about ten bf16
# roundings of its intermediates (LayerNorm outputs, q, k, v, P, o, the gated
# FFN product, h before proj_out): its error is taken relative to the
# largest |plain| entry; sound readings on the H100 4.1e-3 (C = 320) and
# 3.8e-3 (C = 640); a head skipped reads 0.25 (scripts/fault_control.py)
# the spatial kernel's outputs are O(1), rounded once to bf16, after the
# bf16 rounding of its exponentials (absolute, as the flash forward); the
# fused conv's outputs reach ~4 (a bf16 ulp 0.016) from bf16 activations
# summed over 9 Cin products: relative to the largest |plain| entry. Sound
# readings on the H100: spatial 8.5e-4 (level 0) and 2.7e-3 (level 1),
# conv 2.0e-3 of max|plain| at both levels (the PR 5 and PR 11 kernels); a
# skipped key tile reads 7.6e-2, a skipped tap 0.34, the conv's last pixel
# tile of each image zeroed 0.97 (scripts/fault_control.py)
# the GEGLU gate pass rounds as its plain version does in bf16 (gate/sqrt(2),
# gelu, the product) and evaluates the polynomial with every operation
# rounded apart, as PyTorch does: it is held entry by entry to the bf16
# plain version, in bf16 ulps of each entry (bf16_ulps); its error against
# the fp32 plain version is reported too
TOL = {'geglu_ffn': 3e-2, 'geglu_gate': 1, 'temporal_attention': 1e-2,
       'flash_attention_fwd': 1e-2, 'flash_attention_bwd_dq': 1e-2,
       'flash_attention_bwd_dkv': 1e-2, 'fused_temporal': 1.5e-2,
       'fused_temporal_bfhw': 1.5e-2, 'spatial_self_attention': 1e-2,
       'gn_silu_conv': 1e-2}
# the hash-grid scatter sums in 64-bit fixed point (exact to ~1e-8 of
# max|val|), its plain version in fp32 in another order (~830 rows an entry
# at level 0): they differ by a few 1e-7 of the largest |plain| entry; the
# limit is relative to that entry. The same for the hash encoding's d_x and
# d_table on the card against the CPU. Two calls on the same inputs must
# give the same bits
HASH_TOL = 1e-5
# the autograd Functions' gradients on the card (kernel forward, plain
# backward in bf16) against autograd through the fp32 plain version,
# relative to the largest entry
GRAD_TOL = 2e-2
# relative L2 error allowed for whole-model comparisons (GPU bf16 vs CPU
# fp32): bf16 activations through ~100 layers with random weights
MODEL_REL_TOL = 5e-2
# the unrouted phase on the U-Net's own level-0 and level-1 inputs, relative
# L2, both sides bf16 on the card: the spatial kernel against the flash route
# on the hooked attn1's q, k, v (each rounds its exponentials, or its
# probabilities, and its output to bf16), the fused conv fed the video's
# GroupNorm statistics against the module's conv1(silu(norm1(x))) (which
# rounds the normalised and the activated input to bf16, the kernel the
# activation once). Sound readings on the H100: spatial 8.3e-4 (level 0)
# and 7.9e-4 (level 1), conv 3.86e-3 and 3.89e-3; the spatial kernel's last
# 64-key tile skipped reads 1.6e-2 and 1.9e-2, the conv's last tap skipped
# 0.34, its last pixel tile of each image zeroed 0.15 and 0.22
# (scripts/fault_control.py): the limits sit at about 5x and 2.5x the
# sound readings
UNROUTED_ATTN_TOL = 4e-3
UNROUTED_CONV_TOL = 1e-2
# the same for sampled latents: guidance 7.5 multiplies the U-Net's bf16
# error in (eps_cond - eps_uncond) by up to 7.5 at every step
SAMPLE_REL_TOL = 5e-2
# blend_small's latents, GPU bf16 against CPU fp32: the bf16 inversion (5
# steps, each dividing by sqrt(alpha)) feeds 5 CFG-7.5 edit steps whose blend
# masks threshold the attention maps, so a map value near the threshold
# flips a mask pixel and the blend there. Sound readings on the H100:
# 4.49e-2 to 4.84e-2 (both tiers, blend thresholds 0.3 to 0.95, and the
# fault-control script's order of runs); the closest planted fault, the
# cross-attention edit skipped on the card, reads 7.19e-2
BLEND_REL_TOL = 6e-2
# train_small, GPU bf16 against CPU fp32: the loss (relative) and the
# flattened adapter gradient (relative L2), the latter a sum over every U-Net
# layer's backward in bf16. Sound readings on the H100: loss 6.7e-4, grad
# 9.85e-3; the limits sit at about 7x and 2x those. A planted fault in either
# flash backward kernel reads 3.2e-2 (dQ skips a key tile) to 8.0e-2 (dK/dV
# skips a query tile) on the gradient (scripts/fault_control.py)
TRAIN_LOSS_TOL = 5e-3
TRAIN_GRAD_TOL = 2e-2
# train_small's AdamW step from a fresh state, GPU against CPU fp32: relative
# L2 of the change of the flattened adapter weights. The first step moves
# each weight by lr * g / (|g| + eps), about lr * sign(g), so the sides
# differ only where a near-zero gradient entry changes sign. Sound reading
# on the H100: 0.103; with the adapter's weights kept in bf16 it reads 0.964
# and 0.084 of the weights move (scripts/fault_control.py)
TRAIN_UPDATE_TOL = 0.25
# the share of adapter weights that a step must move, in train_small and
# over train's TRAIN_STEPS: fp32 weights move wherever the gradient or the
# weight is non-zero; bf16 weights of ~0.03 do not move at lr 1e-5
TRAIN_MOVED_MIN = 0.99
# NVIDIA H100 SXM published dense peaks: bf16 tensor-core FLOP/s, fp32
# FLOP/s outside the tensor cores and HBM3 bytes/s (at the full 700 W power
# limit)
PEAK_FLOPS, PEAK_FP32_FLOPS, PEAK_BYTES = 989e12, 67e12, 3.35e12
# exp2 a clock on each streaming multiprocessor: the special-function units'
# rate on sm_90 (CUDA C++ Programming Guide, arithmetic instruction
# throughput); an attention forward takes one exponential a logit
EXP_PER_CLOCK_SM = 16

# options/train_atlas/atlas_swan.yml, its `models` and `train` blocks and
# its clip size (`datasets`: res_x, res_y, max_frames), written out
ATLAS_MODELS = {
    'FG_UV_Mapping': {'input_dim': 3, 'output_dim': 2, 'hidden_dim': 256,
                      'pe_type': 'none', 'pe_dim': 4, 'mlp_type': 'origin',
                      'mlp_layers': 6, 'skip_layers': []},
    'FG_UV_Mapping_Inverse': {'input_dim': 3, 'output_dim': 3,
                              'hidden_dim': 256, 'pe_type': 'none',
                              'pe_dim': 4, 'mlp_type': 'origin',
                              'mlp_layers': 6, 'skip_layers': []},
    'BG_UV_Mapping': {'input_dim': 3, 'output_dim': 2, 'hidden_dim': 256,
                      'pe_type': 'none', 'pe_dim': 2, 'mlp_type': 'origin',
                      'mlp_layers': 4, 'skip_layers': []},
    'F_Atlas': {'input_dim': 2, 'output_dim': 3, 'hidden_dim': 256,
                'pe_type': 'hash_encoding', 'pe_dim': 10,
                'mlp_type': 'origin', 'mlp_layers': 8,
                'skip_layers': [4, 7]},
    'F_Alpha': {'input_dim': 3, 'output_dim': 1, 'hidden_dim': 256,
                'pe_type': 'encoding', 'pe_dim': 5, 'mlp_type': 'origin',
                'mlp_layers': 8, 'skip_layers': []},
}
ATLAS_TRAIN = {
    'optimizer': {'type': 'Adam', 'lr': 1e-4},
    'total_iter': 50000,
    'sample_batch_size': 10000,
    'pretrain_UV_mapping_iter': 100,
    'pretrain_alpha_iter': 50000,
    'pretrain_global_rigidity_iter': 5000,
    'uv_mapping_scale': 0.8,
    'derivative_amount': 1,
    'global_derivative_amount': 100,
    'loss_cfg': {
        'reconstruction_loss': {'rgb_loss_weight': 5000.0,
                                'gradient_loss_weight': 1000.0,
                                'alpha_loss_weight': 2000.0},
        'sparsity_loss': {'sparsity_loss_weight': 1000.0},
        'rigidity_loss': {'rigidity_loss_weight': 1.0,
                          'global_rigidity_fg_loss_weight': 5.0,
                          'global_rigidity_bg_loss_weight': 50.0},
        'flow_loss': {'flow_loss_weight': 5.0,
                      'alpha_flow_loss_weight': 49.0},
    },
}
ATLAS_FRAMES, ATLAS_H, ATLAS_W = 72, 448, 768
ATLAS_STEPS = 200          # main + inverse iterations (a smoke run's time)
# the atlas phase's UV pretraining, iterations a frame: the config's 100
# cut to 10 (720 iterations a mapping instead of 7200, which took 70 s of the
# phase's 81 on a slow host) to keep the whole script well inside its limit;
# atlas_recipe pretrains as shipped, and its checks need that depth
ATLAS_PRETRAIN_ITER = 10
ATLAS_SMALL = (8, 96, 128)  # atlas_small's clip: frames, height, width
# the synthetic clip's motion, pixels a frame: background and disk
ATLAS_BG_SHIFT, ATLAS_DISK_SHIFT = (1.5, 0.5), (3.0, -1.25)
# atlas_small, GPU fp32 against CPU fp32, same params and draws: each loss
# term (relative), each net's flattened gradient and the hash table's
# (relative L2), and each net's change under Adam's first step (relative
# L2). cuBLAS and the CPU's BLAS sum fp32 products in other orders, the
# hash scatter in fixed point; the rigidity terms divide
# by the determinant of a random-init Jacobian taken as differences of
# neighbouring evaluations, which amplifies that rounding in the mappings'
# gradients (to ~1e-4 on the CPU between the JAX package and the port).
# Adam's first step moves each weight by lr g / (|g| + eps), about
# lr sign(g), so a near-zero gradient entry whose sign differs moves its
# weight the other way: the update limit covers those flips
# Sound readings on the H100: worst loss term 1.8e-7, worst net gradient
# 7.3e-5 (F_Atlas), hash table 2.9e-4, worst update 1.1e-2 (F_Atlas); the
# limits sit at 5x to 7x those
ATLAS_LOSS_TOL = 1e-6
ATLAS_GRAD_TOL = 5e-4
ATLAS_HASH_GRAD_TOL = 1.5e-3
ATLAS_UPDATE_TOL = 0.06


def clip_vocab(texts, size: int = 49408, merges: int = 2000):
    """A CLIP tokenizer's vocab.json and merges.txt contents, generated: the
    256 byte characters alone and with the word-end mark '</w>', then up
    to `merges` merges learnt from `texts` (the most frequent adjacent
    pair first, ties by order), filler entries up to `size` - 2, and the
    start and end tokens last, as CLIP-L/14's are (49406, 49407)."""
    import collections
    from videoswap_torch.utils.tokenizer import (_CLIP_PAT, _basic_clean,
                                                 _bytes_to_unicode)
    byte = _bytes_to_unicode()
    base = list(byte.values())
    vocab = {t: i for i, t in enumerate(base + [c + '</w>' for c in base])}
    words = collections.Counter()
    for text in texts:
        for w in _CLIP_PAT.findall(_basic_clean(text)):
            w = ''.join(byte[b] for b in w.encode('utf-8'))
            words[tuple(w[:-1]) + (w[-1] + '</w>',)] += 1
    rules = []
    while len(rules) < merges:
        pairs = collections.Counter()
        for w, n in words.items():
            for p in zip(w, w[1:]):
                pairs[p] += n
        if not pairs:
            break
        best = max(sorted(pairs), key=pairs.__getitem__)
        rules.append(best)
        vocab.setdefault(best[0] + best[1], len(vocab))
        merged = collections.Counter()
        for w, n in words.items():
            out, i = [], 0
            while i < len(w):
                if i + 1 < len(w) and (w[i], w[i + 1]) == best:
                    out.append(w[i] + w[i + 1])
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            merged[tuple(out)] += n
        words = merged
    i = 0
    while len(vocab) < size - 2:
        vocab.setdefault(f'<filler{i}>', len(vocab))
        i += 1
    vocab['<|startoftext|>'] = size - 2
    vocab['<|endoftext|>'] = size - 1
    return vocab, '#version: 0.2\n' + ''.join(f'{a} {b}\n' for a, b in rules)


class PhaseError(RuntimeError):
    pass


def full_fp32() -> None:
    """fp32 products and convolutions in full fp32, not TF32: the atlas
    trains in fp32, and TF32 would be a measured decision of its own."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')


def log(msg: str) -> None:
    print(msg, flush=True)


def die(msg: str) -> None:
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int, warmup: int = 2,
                 ahead: bool = False) -> float:
    """Device time per call of fn over `iters` calls, after `warmup`. With
    `ahead`, the card first spins for about 1 ms a call, so that the host
    has queued every call before the first starts: the time is then the
    device's alone, not the pace of a host that launches small kernels
    one after another."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if ahead:
        torch.cuda._sleep(2_000_000 * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------------------ build
def phase_build(report):
    from videoswap_torch.ops import _build
    path, seconds = _build.build()
    _build.library()
    log(f'# build: {path.name} in {seconds:.1f} s (0 = already built)')
    text = path.with_suffix('.log').read_text() if seconds else ''
    for line in text.splitlines():
        if re.search(r'Compiling entry|registers|spill|Performance Loss',
                     line):
            log(f'# ptxas: {line.strip()}')
    report['build_s'] = seconds


def ptxas_lines(kernel: str) -> list[str]:
    """The build log's register, spill and serialisation lines of the
    kernels whose (mangled) names contain `kernel`."""
    from videoswap_torch.ops import _build
    log_path = _build.build()[0].with_suffix('.log')
    if not log_path.exists():
        return []
    lines, inside = [], False
    for line in log_path.read_text().splitlines():
        if 'Compiling entry' in line:
            inside = kernel in line
        if (inside or kernel in line) and re.search(
                r'registers|spill|Performance Loss', line):
            lines.append(line.strip())
    return lines


# ---------------------------------------------------------------- kernels
def _rand(gen, shape, scale=1.0):
    import torch
    return (torch.randn(shape, generator=gen, device='cuda') * scale).to(
        torch.bfloat16)


def bound_ms(flops: float, nbytes: float,
             peak_flops: float = PEAK_FLOPS) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over their peak (bf16 unless given) and the bytes (each input read
    once, each output written once) over the memory rate; and which of the
    two it is."""
    t_ops, t_bytes = flops / peak_flops, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def exp_floor_ms(exps: float) -> float:
    """The least time the card's special-function units take for `exps`
    exponentials at the SMs' maximum clock (nvidia-smi clocks.max.sm)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return exps / (sms * EXP_PER_CLOCK_SM * sm_clock_hz()) * 1e3


@functools.lru_cache(maxsize=None)
def sm_clock_hz() -> float:
    out = subprocess.run(['nvidia-smi', '--query-gpu=clocks.max.sm',
                          '--format=csv,noheader,nounits'],
                         capture_output=True, text=True, timeout=60,
                         check=True)
    return float(out.stdout.split()[0]) * 1e6


def _record(report, name, shape_desc, err, ms, plain_ms, work, library,
            exps=None, **extra):
    """Print the shape's bound (and, for attention, `exps` exponentials'
    floor, on this line only) and library time; keep the largest error over
    shapes, the times, bound and library time of the first (level-0,
    largest) shape, and every shape's in `shapes`."""
    b_ms, b_by = bound_ms(*work)
    lib_ms = library() if library else None
    log(f'# kernel {name} {shape_desc}: bound {b_ms:.4f} ms ({b_by})'
        + ('' if exps is None else
           f', exp floor {exp_floor_ms(exps):.4f} ms')
        + ', library call ' + (f'{lib_ms:.4f} ms' if library else 'none'))
    entry = report['kernels'].setdefault(name, {'max_abs_err': 0.0,
                                                'ms': None, 'shapes': []})
    entry['max_abs_err'] = max(entry['max_abs_err'], err)
    row = dict(shape=shape_desc, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=lib_ms, **extra)
    entry['shapes'].append(row)
    if entry['ms'] is None:
        entry.update(row)


def bf16_ulps(out, ref) -> float:
    """Largest |out - ref| over entries, each in bf16 ulps of its entry of
    `ref` (bf16 values; an ulp of 0 is the smallest bf16 subnormal)."""
    import torch
    r = ref.double()
    ulp = torch.ldexp(torch.ones_like(r), torch.frexp(r).exponent - 8)
    ulp = torch.where(r == 0, 2.0 ** -133, ulp).clamp_min(2.0 ** -133)
    return float(((out.double() - r).abs() / ulp).max())


def _compare(name, shape_desc, kernel, plain_bf16, plain_fp32, report,
             work, library=None, iters=10, relative=False, ulps=False,
             exps=None, ahead=False, **extra):
    """Kernel against its plain version; with `relative` the limit holds
    the error over the largest |plain| entry, with `ulps` the error against
    the bf16 plain version in bf16 ulps of each entry (bf16_ulps). With
    `ahead` the kernel's time is the device's alone (cuda_time_ms), and its
    time launched one after another is kept too (`paced_ms`)."""
    import torch
    out = kernel()
    torch.cuda.synchronize()
    ref = plain_fp32()
    err = float((out.float() - ref.float()).abs().max())
    crit = err / float(ref.float().abs().max()) if relative else err
    if ulps:
        crit = bf16_ulps(out, plain_bf16())
    ms = cuda_time_ms(kernel, iters, ahead=ahead)
    if ahead:
        extra['paced_ms'] = cuda_time_ms(kernel, iters)
    plain_ms = cuda_time_ms(plain_bf16, max(2, iters // 3), warmup=1)
    ok = crit <= TOL[name] and bool(torch.isfinite(out).all())
    log(f'# kernel {name} {shape_desc}: max_abs_err {err:.3e}'
        + (f', /max|plain| {crit:.3e}' if relative else '')
        + (f', bf16 ulps of the bf16 plain version {crit:g}' if ulps
           else '')
        + f' (tol {TOL[name]:g}) kernel {ms:.4f} ms'
        + (f' (device, queued ahead; {extra["paced_ms"]:.4f} ms launched one '
           'after another)' if ahead else '')
        + f' plain(bf16) {plain_ms:.3f} ms {"ok" if ok else "FAIL"}')
    _record(report, name, shape_desc, err, ms, plain_ms, work, library, exps,
            **extra)
    if relative or ulps:
        key = 'max_bf16_ulps' if ulps else 'max_err_over_max_plain'
        entry = report['kernels'][name]
        entry[key] = max(entry.get(key, 0.0), crit)
    if not ok:
        raise PhaseError(f'{name} {shape_desc}: error {crit:.3e}')


def _sdpa(q, k, v):
    """scaled_dot_product_attention on (B, S, H, D) tensors, as views."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2))


def _sdpa_bwd_ms(q, k, v, dout, desc):
    """Time of the library's attention backward (dq, dk, dv in one call),
    and of its forward + backward, on the same inputs."""
    import torch
    qr, kr, vr = (t.detach().requires_grad_() for t in (q, k, v))
    out = _sdpa(qr, kr, vr)
    dout_t = dout.transpose(1, 2)
    bwd = cuda_time_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), dout_t, retain_graph=True), 5)
    fwd_bwd = cuda_time_ms(lambda: torch.autograd.grad(
        _sdpa(qr, kr, vr), (qr, kr, vr), dout_t), 5)
    log(f'# library sdpa {desc}: backward {bwd:.3f} ms, forward + '
        f'backward {fwd_bwd:.3f} ms')
    return bwd


def _flash_backward(fa, gen, b, h, s, sk, d, report):
    """Both backward kernels against flash_attention_bwd_plain in fp32 at
    one training shape. out and lse come from the forward kernel, as in
    training; the error is relative to the largest |plain| entry."""
    import torch
    desc = f'B={b} H={h} Sq={s} Sk={sk} d={d}'
    q = _rand(gen, (b, s, h, d))
    k, v = (_rand(gen, (b, sk, h, d)) for _ in range(2))
    dout = _rand(gen, (b, s, h, d))
    out, lse = fa.flash_attention_fwd(q, k, v)
    delta = torch.einsum('bqhd,bqhd->bhq', dout.float(), out.float()) \
        .reshape(b * h, s).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    chunk = max(1, (1 << 28) // (h * s * sk))   # <= 1 GiB of fp32 logits
    f32 = [t.float() for t in (q, k, v, out)]
    ref = fa.flash_attention_bwd_plain(*f32, lse, dout.float(), chunk)
    plain_ms = cuda_time_ms(lambda: fa.flash_attention_bwd_plain(
        q, k, v, out, lse, dout, chunk), 2, warmup=1)
    bytes_in = 2 * (2 * b * s * h * d + 2 * b * sk * h * d) + 8 * b * h * s
    flops = b * h * s * sk * d
    # one library call computes dq, dk and dv: both rows get its time
    lib_ms = _sdpa_bwd_ms(q, k, v, dout, desc)
    cases = (('flash_attention_bwd_dq',
              lambda: fa._launch_bwd_dq(q, k, v, dout, lse, delta, dq),
              ((dq, ref[0]),), (6 * flops, bytes_in + 2 * b * s * h * d)),
             ('flash_attention_bwd_dkv',
              lambda: fa._launch_bwd_dkv(q, k, v, dout, lse, delta, dk, dv),
              ((dk, ref[1]), (dv, ref[2])),
              (8 * flops, bytes_in + 4 * b * sk * h * d)))
    for name, launch, pairs, work in cases:
        launch()
        torch.cuda.synchronize()
        abs_errs = [float((o.float() - r).abs().max()) for o, r in pairs]
        rel_errs = [e / float(r.abs().max())
                    for e, (_, r) in zip(abs_errs, pairs)]
        finite = all(bool(torch.isfinite(o).all()) for o, _ in pairs)
        ms = cuda_time_ms(launch, 5)
        ok = max(rel_errs) <= TOL[name] and finite
        log(f'# kernel {name} {desc}: max_abs_err '
            + ' '.join(f'{e:.3e}' for e in abs_errs) + ', /max|plain| '
            + ' '.join(f'{e:.3e}' for e in rel_errs)
            + f' (tol {TOL[name]:g}) kernel {ms:.3f} ms plain backward '
            f'(bf16 inputs, dq+dk+dv) {plain_ms:.3f} ms '
            f'{"ok" if ok else "FAIL"}')
        _record(report, name, desc, max(abs_errs), ms, plain_ms, work,
                lambda: lib_ms, exps=b * h * s * sk)
        entry = report['kernels'][name]
        entry['max_err_over_max_plain'] = max(
            entry.get('max_err_over_max_plain', 0.0), max(rel_errs))
        if not ok:
            raise PhaseError(f'{name} {desc}: error {max(rel_errs):.3e} of '
                             'the largest |plain| entry')


def _grad_check(name, fn, plain, args, dout):
    """Gradients through a wrapper on the card (its autograd Function:
    kernel forward, plain backward) against autograd through the fp32
    plain version, relative to each gradient's largest entry."""
    import torch
    xs = [a.detach().requires_grad_() for a in args]
    out = fn(*xs)
    if out.grad_fn is None:
        raise PhaseError(f'{name}: output has no grad_fn (detached)')
    grads = torch.autograd.grad(out, xs, dout)
    refs = [a.detach().float().requires_grad_() for a in args]
    ref = torch.autograd.grad(plain(*refs), refs, dout.float())
    errs = [float((g.float() - r).abs().max() / r.abs().max())
            for g, r in zip(grads, ref)]
    ok = max(errs) <= GRAD_TOL
    log(f'# grad {name}: max_abs_err/max|plain| per input '
        + ' '.join(f'{e:.3e}' for e in errs)
        + f' (tol {GRAD_TOL:.0e}) {"ok" if ok else "FAIL"}')
    if not ok:
        raise PhaseError(f'{name} gradient: error {max(errs):.3e}')


def _geglu_case(report, gen, n, c, tag=''):
    """GEGLU at N rows and width C by its width's route (the fused kernel
    at C <= 640, above it the split route, whose gate pass is checked and
    timed alone too). No single PyTorch call computes the FFN: the two
    cuBLAS products alone on inputs of the same shapes stand in the library
    column."""
    import torch.nn.functional as F
    from videoswap_torch.ops import geglu_ffn as gf
    f32 = (lambda ts: [t.float() for t in ts])
    args = [_rand(gen, (n, c)), _rand(gen, (8 * c, c), c ** -0.5),
            _rand(gen, (8 * c,), 0.1), _rand(gen, (c, 4 * c),
                                             (4 * c) ** -0.5),
            _rand(gen, (c,), 0.1)]
    g_in = _rand(gen, (n, 4 * c))
    route = 'fused' if gf.takes_fused_route(c) else 'split'
    _compare('geglu_ffn', f'N={n} C={c} ({route}){tag}',
             lambda: gf.geglu_ffn(*args),
             lambda: gf.geglu_ffn_plain(*args),
             lambda: gf.geglu_ffn_plain(*f32(args)), report,
             (24 * n * c * c, 2 * (2 * n * c + 12 * c * c + 9 * c)),
             lambda: cuda_time_ms(lambda: (
                 F.linear(args[0], args[1], args[2]),
                 F.linear(g_in, args[3], args[4])), 10), route=route)
    if route == 'fused':
        # the split route at this width, for the choice of route (the
        # JAX package's gate fixes it at MAX_KERNEL_WIDTH)
        ms = cuda_time_ms(lambda: gf.geglu_ffn_split(*args), 10)
        report['kernels']['geglu_ffn']['shapes'][-1]['split_route_ms'] = ms
        log(f'# kernel geglu_ffn N={n} C={c}{tag}: the split route here '
            f'{ms:.4f} ms')
    if route == 'split':
        h = F.linear(args[0], args[1], args[2])
        # ~31 fp32 operations an output (gelu_fast's Horner erf)
        _compare('geglu_gate', f'N={n} 8C={8 * c}{tag}',
                 lambda: gf.geglu_gate(h),
                 lambda: gf.geglu_gate_plain(h),
                 lambda: gf.geglu_gate_plain(h.float()), report,
                 (31 * 4 * n * c, 2 * 12 * n * c, PEAK_FP32_FLOPS),
                 ulps=True)


def _temporal_case(report, gen, el, f, c, tag='') -> bool:
    """Temporal attention over L locations x F frames, 8 heads; whether two
    calls on the same inputs give the same bits. The kernel and SDPA are
    timed on the device alone (queued ahead): at the small shapes a call
    launched after another is paced by the host."""
    import torch
    from videoswap_torch.ops import temporal_attention as ta
    f32 = (lambda ts: [t.float() for t in ts])
    q, k, v = (_rand(gen, (el * f, c)) for _ in range(3))
    view = (lambda t: t.view(el, f, 8, c // 8))
    hc, lg = ta.plan(f, c, 8)
    _compare('temporal_attention', f'L={el} F={f} C={c}{tag}',
             lambda: ta.temporal_attention(q, k, v, 8, f),
             lambda: ta.temporal_attention_plain(q, k, v, 8, f),
             lambda: ta.temporal_attention_plain(*f32((q, k, v)), 8, f),
             report, (4 * el * f * f * c, 2 * 4 * el * f * c),
             lambda: cuda_time_ms(
                 lambda: _sdpa(view(q), view(k), view(v)), 10,
                 ahead=True),
             ahead=True)
    twice = [ta.temporal_attention(q, k, v, 8, f) for _ in range(2)]
    same = torch.equal(*twice)
    log(f'# kernel temporal_attention L={el} F={f} C={c}{tag}: items of '
        f'{lg} locations x {hc} heads, two calls bitwise equal {same}')
    return same


def _flash_case(report, gen, b, h, s, sk, d, tag=''):
    """The flash forward at one shape, and the logsumexp the backward
    needs (on the first batch entry)."""
    from videoswap_torch.ops import flash_attention as fa
    f32 = (lambda ts: [t.float() for t in ts])
    q = _rand(gen, (b, s, h, d))
    k, v = (_rand(gen, (b, sk, h, d)) for _ in range(2))
    chunk = max(1, (1 << 28) // (h * s * sk))   # <= 1 GiB of logits
    _compare('flash_attention_fwd', f'B={b} H={h} Sq={s} Sk={sk} d={d}{tag}',
             lambda: fa.flash_attention_fwd(q, k, v)[0],
             lambda: fa.flash_attention_plain(q, k, v, chunk)[0],
             lambda: fa.flash_attention_plain(
                 *f32((q, k, v)), max(1, chunk // 2))[0], report,
             (4 * b * h * s * sk * d,
              2 * (2 * b * s * h * d + 2 * b * sk * h * d) + 4 * b * h * s),
             lambda: cuda_time_ms(lambda: _sdpa(q, k, v), 5),
             iters=5, exps=b * h * s * sk)
    _, lse = fa.flash_attention_fwd(q[:1], k[:1], v[:1])
    _, lse_ref = fa.flash_attention_plain(*f32((q[:1], k[:1], v[:1])))
    lerr = float((lse - lse_ref).abs().max())
    if lerr > 1e-2:
        raise PhaseError(f'flash lse {s}x{sk}{tag} max_abs_err {lerr:.3e}')


def recipe_shape_kernels(report, gen) -> None:
    """The recipe path's forward kernels against their plain versions at
    the 1009 recipe's shapes (recipe_levels, RECIPE_BATCHES x 16 frames, 8
    heads), at the limits of the benchmark shapes: GEGLU at every level,
    the fused temporal transformer (both layouts) at levels 0-1, temporal
    attention at levels 2-3, the flash forward at every level, self and
    cross (Sk = 77). Raises PhaseError at the first that disagrees."""
    tag = ' (recipe)'
    same = True
    for b in RECIPE_BATCHES:
        for lvl, (h8, w8, c) in enumerate(recipe_levels()):
            hw = h8 * w8
            _geglu_case(report, gen, b * FRAMES * hw, c, tag)
            if lvl < 2:
                _fused_temporal(report, gen, h8, w8, c, b, tag)
            else:
                same = _temporal_case(report, gen, b * hw, FRAMES, c,
                                      tag) and same
            for sk in (hw, 77):
                _flash_case(report, gen, b * FRAMES, 8, hw, sk, c // 8, tag)
    if not same:
        raise PhaseError('temporal_attention (recipe shapes): two calls on '
                         'the same inputs differ')


def edlora_shape_kernels(report, gen) -> None:
    """The ED-LoRA path's kernels against their plain versions at its
    shapes: one 512x512 image, 8 heads (B.H = 8), the flash forward and
    both backward kernels at every level, self and cross (Sk = 77), and
    GEGLU at each level's rows (4096, 1024, 256, 64), at the limits of the
    benchmark shapes, timed beside SDPA and the two cuBLAS products."""
    from videoswap_torch.ops import flash_attention as fa
    tag = ' (edlora)'
    for n, c in ((4096, 320), (1024, 640), (256, 1280), (64, 1280)):
        _geglu_case(report, gen, n, c, tag)
    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)):
        for sk in (s, 77):
            _flash_case(report, gen, 1, 8, s, sk, d, tag)
            _flash_backward(fa, gen, 1, 8, s, sk, d, report)


def phase_kernels(report):
    import torch
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import geglu_ffn as gf
    from videoswap_torch.ops import temporal_attention as ta
    gen = torch.Generator(device='cuda').manual_seed(SEED)

    # GEGLU FFN: rows = CFG batch 2 x 16 frames x H*W, per U-Net level
    for n, c in ((131072, 320), (32768, 640), (8192, 1280), (2048, 1280)):
        _geglu_case(report, gen, n, c)
    report['kernels']['geglu_ffn']['library_is'] = (
        'the two cuBLAS products alone (F.linear(x, w1, b1), '
        'F.linear(g, w2, b2))')

    # temporal attention: L locations x F=16 frames, 8 heads, at the U-Net
    # levels' shapes (the swap launches it at C = 1280: 2 x 16 x 16 and
    # 2 x 8 x 8 locations), then at tiling edges: location counts that are
    # not a multiple of a work item's (ta.plan's lg, which the log line
    # prints), F around the 16-row tiles. Two calls on the same inputs must
    # give the same bits
    same = True
    for el, f, c in ((8192, FRAMES, 320), (2048, FRAMES, 640),
                     (512, FRAMES, 1280), (128, FRAMES, 1280),
                     (333, 1, 1280), (101, 7, 640), (77, 17, 320),
                     (45, 32, 1280)):
        same = _temporal_case(report, gen, el, f, c) and same
    report['kernels']['temporal_attention']['bitwise_repeatable'] = same
    if not same:
        raise PhaseError('temporal_attention: two calls on the same inputs '
                         'differ')

    # fused temporal transformer: the CFG batch of 2 x 16 frames at level 0
    # (C = 320, with the FFN) and level 1 (C = 640, the attention half)
    for side, c in ((64, 320), (32, 640)):
        _fused_temporal(report, gen, side, side, c)

    # flash forward: B = 2 CFG x 16 frames, 8 heads; self and cross (Sk=77)
    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)):
        for sk in (s, 77):
            _flash_case(report, gen, 2 * FRAMES, 8, s, sk, d)

    # flash backward: the training step's B = 16 frames, 8 heads
    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)):
        for sk in (s, 77):
            _flash_backward(fa, gen, FRAMES, 8, s, sk, d, report)

    # the autograd Functions of GEGLU and temporal attention on the card
    c = 320
    args = [_rand(gen, (4096, c)), _rand(gen, (8 * c, c), c ** -0.5),
            _rand(gen, (8 * c,), 0.1), _rand(gen, (c, 4 * c),
                                             (4 * c) ** -0.5),
            _rand(gen, (c,), 0.1)]
    _grad_check('geglu_ffn N=4096 C=320', gf.geglu_ffn, gf.geglu_ffn_plain,
                args, _rand(gen, (4096, c)))
    qkv = [_rand(gen, (256 * FRAMES, c)) for _ in range(3)]
    _grad_check('temporal_attention L=256 F=16 C=320',
                lambda *t: ta.temporal_attention(*t, 8, FRAMES),
                lambda *t: ta.temporal_attention_plain(*t, 8, FRAMES), qkv,
                _rand(gen, (256 * FRAMES, c)))

    from videoswap_torch.ops import fused_temporal as ft
    c, el = 320, 256
    g, x, pe, flat, _ = _fused_inputs(gen, 1, el, c, True)
    _grad_check(f'fused_temporal L={el} F={FRAMES} C={c}',
                lambda g_, x_: ft.fused_temporal_transformer(
                    g_, x_, pe, flat, 8, FRAMES),
                lambda g_, x_: ft.fused_temporal_plain(
                    g_, x_, pe.float(), [p.float() for p in flat], 8,
                    FRAMES),
                [ft.rows_of(g).contiguous(), ft.rows_of(x).contiguous()],
                _rand(gen, (el * FRAMES, c)))

    # their plain backwards at the training step's shapes (16 frames x H x
    # W rows per U-Net level), as training runs them: dX alone through the
    # FFN (frozen weights), dq/dk/dv through the frame attention
    for hw, c in ((64 * 64, 320), (32 * 32, 640), (16 * 16, 1280),
                  (8 * 8, 1280)):
        n = FRAMES * hw
        w = [_rand(gen, (8 * c, c), c ** -0.5), _rand(gen, (8 * c,), 0.1),
             _rand(gen, (c, 4 * c), (4 * c) ** -0.5), _rand(gen, (c,), 0.1)]
        x = _rand(gen, (n, c)).requires_grad_()
        dout = _rand(gen, (n, c))
        out = gf.geglu_ffn(x, *w)
        ms = cuda_time_ms(lambda: torch.autograd.grad(
            out, x, dout, retain_graph=True), 5)
        qkv = [_rand(gen, (n, c)).requires_grad_() for _ in range(3)]
        out = ta.temporal_attention(*qkv, 8, FRAMES)
        ms_t = cuda_time_ms(lambda: torch.autograd.grad(
            out, qkv, dout, retain_graph=True), 5)
        log(f'# plain backward N={n} C={c}: geglu_ffn (dX only) {ms:.3f} '
            f'ms, temporal_attention (L={hw} F={FRAMES}) {ms_t:.3f} ms')

    _hash_kernels(report, gen)
    recipe_shape_kernels(report, gen)
    edlora_shape_kernels(report, gen)


def _fused_inputs(gen, b, hw, c, include_ffn, f=FRAMES):
    """g, x (B, F, HW, C) bf16, the position table and a motion module's
    parameters (seeded random weights, random fp32 vectors) for the fused
    temporal kernel, and the module itself."""
    import torch
    from videoswap_torch.models.motion_module import \
        TemporalTransformer3DModel
    from videoswap_torch.ops import fused_temporal as ft
    from videoswap_torch.utils.init import init_weights
    mod = TemporalTransformer3DModel(c, 8).to('cuda')
    init_weights(mod, gen)
    with torch.no_grad():
        for p in mod.parameters():
            if p.dim() == 1:
                p.add_(torch.randn(p.shape, generator=gen, device='cuda'),
                       alpha=0.1)
    mod.to(torch.bfloat16).requires_grad_(False)
    g, x = (_rand(gen, (b, f, hw, c)) for _ in range(2))
    pe = mod.transformer_blocks[0].pe[:f].to(torch.bfloat16)
    return g, x, pe, ft.flat_params(mod, include_ffn), mod


def _fused_temporal(report, gen, h8, w8, c, b=2, tag='', f=FRAMES):
    """The fused kernel against its plain version in both layouts at one
    U-Net level of h8 x w8 latents, batch `b`, `f` frames (C <= 320 with
    the FFN, else
    the attention half), timed
    beside the layer-wise module it replaces (no single PyTorch call
    computes this function: the layer-wise time stands in the library
    column, marked so). At C = 640 the layer-wise time is of the attention
    half, and the fused route's time with `ffn_tail` is printed beside the
    whole layer-wise module's."""
    import torch
    from videoswap_torch.ops import fused_temporal as ft
    heads = 8
    hw = h8 * w8
    inc = c <= 320
    g4, x4, pe, flat, mod = _fused_inputs(gen, b, hw, c, inc, f)
    g2, x2 = ft.rows_of(g4).contiguous(), ft.rows_of(x4).contiguous()
    rows = b * hw * f
    n_mat = 22 if inc else 9             # C x C matrices
    flops = rows * ((44 if inc else 18) * c * c + 8 * f * c)
    nbytes = (2 * rows * c * (3 if inc else 2) + 2 * n_mat * c * c
              + 4 * c * (14 if inc else 8))
    x5, g5 = (t.reshape(b, f, h8, w8, c) for t in (x4, g4))
    blk = mod.transformer_blocks[0]

    def layerwise_attention_half():
        h = torch.nn.functional.linear(g5, mod.proj_in.weight,
                                       mod.proj_in.bias)
        h = h.permute(0, 2, 3, 1, 4).reshape(b * hw, f, c)
        pe_ = blk.pe[:f].to(h.dtype)
        for attn, norm in zip(blk.attention_blocks, blk.norms):
            h = attn(norm(h) + pe_[None]) + h
        return h

    with torch.no_grad():
        layerwise = (lambda: mod._layerwise(x5, g5)) if inc \
            else layerwise_attention_half
        lib_ms = cuda_time_ms(layerwise, 5)
        if not inc:
            full = cuda_time_ms(lambda: mod._layerwise(x5, g5), 5)
            route = cuda_time_ms(lambda: ft.ffn_tail(
                ft.fused_temporal_transformer(g2, x2, pe, flat, heads, f,
                                              include_ffn=False), x2, mod), 5)
            log(f'# fused_temporal rows={rows} C={c}{tag}: kernel + '
                f'ffn_tail {route:.3f} ms, the whole layer-wise module '
                f'{full:.3f} ms')
    # a model of the kernel's L2 traffic, not a measurement: each block
    # (64-row sets of 64 // F whole locations, two a block at C <= 320)
    # reads all the weights it uses
    per_block = 2 if c <= 320 else 1
    sets = -(-b * hw // (64 // f))       # over the B x HW locations
    blocks = -(-sets // per_block)
    l2_gb = blocks * 2 * n_mat * c * c / 1e9
    log(f'# fused_temporal rows={rows} C={c}{tag}: model: {blocks} blocks '
        f'of {64 * per_block} rows would read {l2_gb:.2f} GB of weights from '
        'L2')
    with torch.no_grad():
        one = ft.fused_temporal_transformer(g2, x2, pe, flat, heads, f,
                                            include_ffn=inc)
        two = ft.fused_temporal_transformer(g2, x2, pe, flat, heads, f,
                                            include_ffn=inc)
        fm = ft.fused_temporal_transformer_bfhw(g4, x4, pe, flat, heads, f,
                                                include_ffn=inc)
    same = torch.equal(one, two) and torch.equal(ft.unrows(one, b, f, hw),
                                                 fm)
    log(f'# fused_temporal rows={rows} C={c}{tag}: two calls and the two '
        f'layouts give the same bits: {same}')
    if not same:
        raise PhaseError(f'fused_temporal rows={rows} C={c}{tag}: calls or '
                         'layouts differ')
    del one, two, fm
    f32 = [p.float() for p in flat]
    desc = (f'rows={rows} F={f} C={c}' + ('' if inc else ' attention half')
            + tag)
    _compare('fused_temporal', desc,
             lambda: ft.fused_temporal_transformer(g2, x2, pe, flat, heads, f,
                                                   include_ffn=inc),
             lambda: ft.fused_temporal_plain(g2, x2, pe, flat, heads, f, 1,
                                             inc),
             lambda: ft.fused_temporal_plain(g2.float(), x2.float(),
                                             pe.float(), f32, heads, f, 1,
                                             inc),
             report, (flops, nbytes), lambda: lib_ms, iters=5,
             relative=True)
    _compare('fused_temporal_bfhw', f'B={b} F={f} HW={hw} C={c}{tag}',
             lambda: ft.fused_temporal_transformer_bfhw(
                 g4, x4, pe, flat, heads, f, include_ffn=inc),
             lambda: ft.fused_temporal_plain_bfhw(g4, x4, pe, flat, heads, f,
                                                  1, inc),
             lambda: ft.fused_temporal_plain_bfhw(
                 g4.float(), x4.float(), pe.float(), f32, heads, f, 1, inc),
             report, (flops, nbytes), lambda: lib_ms, iters=5, relative=True)
    for name in ('fused_temporal', 'fused_temporal_bfhw'):
        report['kernels'][name]['library_is'] = 'the layer-wise module'


def _hash_rows(gen, rows, entries):
    """rows int32 indices into a table of `entries` (1% of them -1, dropped)
    and (rows, 2) fp32 values."""
    import torch
    idx = torch.randint(0, entries, (rows,), generator=gen, device='cuda',
                        dtype=torch.int32)
    idx[torch.rand(rows, generator=gen, device='cuda') < 0.01] = -1
    return idx, torch.randn((rows, 2), generator=gen, device='cuda')


def _hash_work(rows, entries, nf=2):
    """(fp32 adds, bytes, peak) of one scatter: idx and val read once, the
    table written once."""
    return rows * nf, rows * (4 + 4 * nf) + entries * nf * 4, PEAK_FP32_FLOPS


def _hash_kernels(report, gen):
    """The table-gradient kernel against its plain version at 240000 rows
    (the 4 corners x 60000 points of a main step's six F_Atlas sites; not a
    multiple of the kernel's 256-row block) and the table sizes of atlas
    levels 0, 1, 7, 11 (the last dense one) and 15 (hashed). Then the 16
    calls of one step's backward at the geometry of random UVs, and the
    hash encoding's gradients on the card against the CPU."""
    import torch
    from videoswap_torch.atlas.imlp import (_level_geometry,
                                            _level_resolutions, hash_encode)
    from videoswap_torch.ops import hash_table_grad as hg
    rows = 240000
    for lv, entries in ((0, 289), (1, 529), (7, 23409), (11, 306916),
                        (15, 524288)):
        desc = f'level {lv} T={entries} R={rows} F=2'
        idx, val = _hash_rows(gen, rows, entries)
        out = hg.hash_table_grad(idx, val, entries)
        torch.cuda.synchronize()
        ref = hg.hash_table_grad_plain(idx, val, entries)
        err = float((out - ref).abs().max())
        rel = err / float(ref.abs().max())
        call = (lambda: hg.hash_table_grad(idx, val, entries))
        ms = cuda_time_ms(call, 20, ahead=True)
        paced_ms = cuda_time_ms(call, 20)
        plain_ms = cuda_time_ms(
            lambda: hg.hash_table_grad_plain(idx, val, entries), 10)
        keep = idx >= 0
        il, vl = idx[keep].long(), val[keep]
        modes = {m: cuda_time_ms(lambda: hg._launch(
            idx, val, torch.zeros((entries, 2), device='cuda'), m), 20,
            ahead=True)
            for m in ('global', 'shared') if entries * 16 <= 48 * 1024}
        # the same inputs again, through each form of the scatter: the
        # fixed-point sums give the same bits whatever order the atomics
        # commit in
        again = [hg.hash_table_grad(idx, val, entries)] + [
            hg._launch(idx, val, torch.zeros((entries, 2), device='cuda'), m)
            for m in modes]
        same = all(torch.equal(out.view(torch.int32), a.view(torch.int32))
                   for a in again)
        ok = rel <= HASH_TOL and bool(torch.isfinite(out).all()) and same
        log(f'# kernel hash_table_grad {desc}: max_abs_err {err:.3e}, '
            f'/max|plain| {rel:.3e} (tol {HASH_TOL:.0e}) kernel {ms:.4f} ms '
            f'(device, queued ahead; table zeroing included), '
            f'{paced_ms:.4f} ms a call launched one after another; plain '
            f'(mask, which syncs, + index_add_) {plain_ms:.4f} ms'
            + ''.join(f', {m} form {t:.4f} ms' for m, t in modes.items())
            + f'; {1 + len(again)} calls bitwise equal {same} '
            f'{"ok" if ok else "FAIL"}')
        _record(report, 'hash_table_grad', desc, err, ms, plain_ms,
                _hash_work(rows, entries), lambda: cuda_time_ms(
                    lambda: torch.zeros((entries, 2), device='cuda')
                    .index_add_(0, il, vl), 20, ahead=True))
        entry = report['kernels']['hash_table_grad']
        entry['max_err_over_max_plain'] = max(
            entry.get('max_err_over_max_plain', 0.0), rel)
        entry['bitwise_repeatable'] = same
        if not ok:
            raise PhaseError(f'hash_table_grad {desc}: error {rel:.3e} of '
                             f'the largest |plain| entry, calls bitwise '
                             f'equal {same}')

    # one main step's backward at the geometry of random UVs: all 16
    # levels in one call, as HashEncode's backward makes it, against 16
    # one-level calls (a call a level, as the backward made them before the
    # all-levels kernel) and 16 index_add_ calls (the library column), each
    # with the 64 MiB table zeroing
    res = _level_resolutions(16, 16, 1.38)
    uv = torch.rand((6 * 10000, 2), generator=gen, device='cuda') * 1.4 - 0.7
    idx, u, v, _ = _level_geometry(uv, res, 2 ** 19)
    idx = idx.to(torch.int32).reshape(16, -1)
    vals = ((u * v)[..., None] * torch.randn(
        (16, 1, 60000, 2), generator=gen, device='cuda')).reshape(
        16, -1, 2).contiguous()
    used = [min((r + 1) ** 2, 2 ** 19) for r in res]
    d_table = torch.zeros((16, 2 ** 19, 2), device='cuda')
    before = hg.launches
    out = hg.hash_table_grad_levels(idx, vals, used, d_table.clone())
    torch.cuda.synchronize()
    step_launches = hg.launches - before
    ref = hg.hash_table_grad_levels_plain(idx, vals, used,
                                          torch.zeros_like(d_table))
    err = float((out - ref).abs().max())
    rel = err / float(ref.abs().max())
    bits = all(torch.equal(out[lv, :n].view(torch.int32),
                           hg.hash_table_grad_fixed(idx[lv], vals[lv], n)
                           .view(torch.int32))
               and not out[lv, n:].any() for lv, n in enumerate(used))
    same = torch.equal(out.view(torch.int32), hg.hash_table_grad_levels(
        idx, vals, used, d_table.clone()).view(torch.int32))
    keep = [(idx[lv] >= 0) & (idx[lv] < n) for lv, n in enumerate(used)]
    il = [idx[lv][k].long() for lv, k in enumerate(keep)]
    vl = [vals[lv][k] for lv, k in enumerate(keep)]

    def levels_call():
        d_table.zero_()
        hg.hash_table_grad_levels(idx, vals, used, d_table)

    def level_calls():
        d_table.zero_()
        for lv, n in enumerate(used):
            hg.hash_table_grad(idx[lv], vals[lv], n, out=d_table[lv, :n])

    def index_adds():
        d_table.zero_()
        for lv, n in enumerate(used):
            d_table[lv, :n].index_add_(0, il[lv], vl[lv])
    step_ms = cuda_time_ms(levels_call, 10, ahead=True)
    step_paced_ms = cuda_time_ms(levels_call, 10)
    calls_ms = cuda_time_ms(level_calls, 10, ahead=True)
    calls_paced_ms = cuda_time_ms(level_calls, 10)
    adds_ms = cuda_time_ms(index_adds, 10, ahead=True)
    zero_ms = cuda_time_ms(d_table.zero_, 10, ahead=True)
    plain_ms = cuda_time_ms(lambda: hg.hash_table_grad_levels_plain(
        idx, vals, used, d_table.zero_()), 3)
    work = [_hash_work(idx.shape[1], n) for n in used]
    work = (sum(w[0] for w in work), sum(w[1] for w in work),
            PEAK_FP32_FLOPS)
    ok = bits and same and rel <= HASH_TOL and step_launches <= 3
    log(f'# kernel hash_table_grad one main step (16 levels, random UVs in '
        f'[-0.7, 0.7], R={idx.shape[1]}): one call {step_ms:.4f} ms on the '
        f'device with the 64 MiB table zeroing ({step_paced_ms:.4f} ms '
        f'launched one after another), {step_launches} launch(es); the 16 '
        f'one-level calls {calls_ms:.4f} ms ({calls_paced_ms:.4f} ms); 16 '
        f'index_add_ calls {adds_ms:.4f} ms; the zeroing alone '
        f'{zero_ms:.4f} ms; plain (16 masks + index_add_) {plain_ms:.4f} ms; '
        f'max_abs_err/max|plain| {rel:.3e} (tol {HASH_TOL:.0e}); every level '
        f'bit-equal to hash_table_grad_fixed {bits}, two calls bitwise equal '
        f'{same} {"ok" if ok else "FAIL"}')
    _record(report, 'hash_table_grad', f'one main step, 16 levels R='
            f'{idx.shape[1]} F=2 (one call)', err, step_ms, plain_ms, work,
            lambda: adds_ms, launches_a_call=step_launches,
            one_level_calls_ms=calls_ms, zeroing_ms=zero_ms)
    b_ms, _ = bound_ms(*work)
    report['kernels']['hash_table_grad'].update(
        step_ms=step_ms, step_bound_ms=b_ms, step_library_ms=adds_ms,
        step_one_level_calls_ms=calls_ms, step_launches=step_launches)
    if not ok:
        raise PhaseError(f'hash_table_grad levels call: error {rel:.3e}, '
                         f'levels bit-equal {bits}, repeatable {same}, '
                         f'{step_launches} launches')
    del d_table, out, ref

    # a diverging step: rows that are NaN or infinite leave their entries
    # NaN or infinite as the plain version leaves them, in both forms, and
    # take no part in the scale of the others
    idx, val = _hash_rows(gen, rows, 289)
    idx[:6] = torch.tensor([5, 5, 6, 7, 7, 8], dtype=torch.int32,
                           device='cuda')
    inf = float('inf')
    val[:6, 0] = torch.tensor([inf, -inf, float('nan'), inf, inf, -inf],
                              device='cuda')
    plain = hg.hash_table_grad_plain(idx, val, 289)
    finite = torch.isfinite(plain)
    outs = [hg._launch(idx, val, torch.zeros((289, 2), device='cuda'), m)
            for m in ('global', 'shared')]
    same = int(finite.sum()) == plain.numel() - 4 and all(
        torch.equal(f(o), f(plain)) for o in outs
        for f in (torch.isnan, torch.isposinf, torch.isneginf))
    rel = max(float((o - plain)[finite].abs().max()) for o in outs) / float(
        plain[finite].abs().max())
    ok = same and rel <= HASH_TOL
    log(f'# kernel hash_table_grad T=289 R={rows} with NaN and infinite '
        f'rows: NaN/inf entries as plain {same}, other entries '
        f'max_abs_err/max|plain| {rel:.3e} (tol {HASH_TOL:.0e}) '
        f'{"ok" if ok else "FAIL"}')
    if not ok:
        raise PhaseError(f'hash_table_grad with non-finite rows: entries as '
                         f'plain {same}, error {rel:.3e}')

    # the hash encoding's gradients, card against CPU, at the full grid
    x = torch.rand((10000, 2), generator=gen, device='cuda') * 1.4 - 0.2
    table = torch.randn((16, 2 ** 19, 2), generator=gen,
                        device='cuda') * 1e-2
    cot = torch.randn((10000, 32), generator=gen, device='cuda')
    grads = []
    for dev in ('cuda', 'cpu'):
        xs, ts = (t.detach().to(dev).requires_grad_() for t in (x, table))
        grads.append(torch.autograd.grad(hash_encode(xs, ts), (xs, ts),
                                         cot.to(dev)))
    errs = [float((g.cpu() - r).abs().max() / r.abs().max())
            for g, r in zip(*grads)]
    ok = max(errs) <= HASH_TOL
    log(f'# grad hash_encode N=10000 L=16 T=2^19: d_x, d_table '
        f'max_abs_err/max|CPU| {errs[0]:.3e} {errs[1]:.3e} (tol '
        f'{HASH_TOL:.0e}) {"ok" if ok else "FAIL"}')
    if not ok:
        raise PhaseError(f'hash_encode gradients on the card: {errs}')


# --------------------------------------------------------------- unrouted
# the JAX package's benchmark shapes: the 16-frame CFG batch of 32 images at
# U-Net levels 0 and 1, 8 heads; (S, C) for attention, (side, C) for the conv
UNROUTED_BATCH = 2 * FRAMES
UNROUTED_ATTN = ((4096, 320), (1024, 640))
UNROUTED_CONV = ((64, 320), (32, 640))


def unrouted_sites(unet) -> dict:
    """The U-Net modules whose inputs the unrouted phase takes: the first
    transformer block's self-attention and the first ResnetBlock3D of down
    levels 0 and 1."""
    sites = {}
    for lv in (0, 1):
        blk = unet.down_blocks[lv]
        sites[f'attn1 level {lv}'] = blk.attentions[0].transformer_blocks[0] \
            .attn1
        sites[f'resnet level {lv}'] = blk.resnets[0]
    return sites


def unrouted_inputs(unet) -> dict:
    """The hidden states each unrouted site receives in one 16-frame
    512x512 CFG U-Net forward (forward pre-hooks, removed afterwards)."""
    captured = {}

    def hook(name):
        def fn(module, args):
            captured[name] = args[0].detach().clone()
        return fn

    handles = [m.register_forward_pre_hook(hook(name))
               for name, m in unrouted_sites(unet).items()]
    try:
        unet_forward(unet, FRAMES)
    finally:
        for h in handles:
            h.remove()
    return captured


def unrouted_module_errors(unet, captured) -> dict:
    """Both kernels on the U-Net's own inputs, relative L2: the spatial
    kernel against the flash route on the hooked attn1's q, k, v; the fused
    conv, fed the video's GroupNorm statistics (over its frames, as
    ResnetBlock3D takes them) repeated as per-frame rows, against the
    module's own conv1(silu(norm1(x)))."""
    import torch
    import torch.nn.functional as F
    from videoswap_torch.ops import gn_silu_conv as gc
    from videoswap_torch.ops import spatial_attention as sa
    from videoswap_torch.ops.attention import dot_product_attention
    sites = unrouted_sites(unet)
    errs = {}

    def err(out, ref):
        return rel_err(out, ref) if bool(torch.isfinite(out).all()) \
            else math.inf

    with torch.no_grad():
        for lv in (0, 1):
            attn = sites[f'attn1 level {lv}']
            h = captured[f'attn1 level {lv}']
            q, k, v = attn.to_q(h), attn.to_k(h), attn.to_v(h)
            errs[f'spatial level {lv}'] = err(
                sa.spatial_self_attention(q, k, v, attn.heads),
                dot_product_attention(q, k, v, attn.heads))
            blk = sites[f'resnet level {lv}']
            x = captured[f'resnet level {lv}']
            b, f, hh, ww, c = x.shape
            scale, shift = gc.gn_scale_shift(
                *gc.gn_stats(x.reshape(b, f * hh, ww, c), blk.norm1.num_groups,
                             blk.norm1.eps), blk.norm1.weight, blk.norm1.bias)
            out = gc.gn_silu_conv_kernel(
                x.reshape(b * f, hh, ww, c), scale.repeat_interleave(f, 0),
                shift.repeat_interleave(f, 0), blk.conv1.weight,
                blk.conv1.bias)
            errs[f'conv level {lv}'] = err(
                out, blk.conv1(F.silu(blk.norm1(x))).reshape(out.shape))
    return errs


def unrouted_fails(errs) -> bool:
    return any(v > (UNROUTED_ATTN_TOL if k.startswith('spatial')
                    else UNROUTED_CONV_TOL) for k, v in errs.items())


def _unrouted_conv_args(gen, side, c):
    """x, gamma, beta, an OIHW weight on a (9 C)^-1/2 scale and a bias, as
    scripts/bench_resnet_fused.py draws them."""
    import torch
    x = _rand(gen, (UNROUTED_BATCH, side, side, c))
    gamma = torch.rand(c, generator=gen, device='cuda') + 0.5
    beta = torch.randn(c, generator=gen, device='cuda') * 0.1
    weight = _rand(gen, (c, c, 3, 3), (9 * c) ** -0.5)
    bias = torch.randn(c, generator=gen, device='cuda') * 0.01
    return x, gamma, beta, weight, bias


def phase_unrouted(report, state):
    import torch
    import torch.nn.functional as F
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import gn_silu_conv as gc
    from videoswap_torch.ops import spatial_attention as sa
    unet = state['pipe'].unet
    gen = torch.Generator(device='cuda').manual_seed(SEED + 8)
    heads = 8
    attn_args = [[_rand(gen, (UNROUTED_BATCH, s, c)) for _ in range(3)]
                 for s, c in UNROUTED_ATTN]
    conv_args = [_unrouted_conv_args(gen, side, c)
                 for side, c in UNROUTED_CONV]

    # ---- the path: each kernel once through its public wrapper at the
    # benchmark's two shapes, then on the U-Net's own level-0 and level-1
    # inputs
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        outs = [sa.spatial_self_attention(*a, heads) for a in attn_args]
        outs += [gc.fused_gn_silu_conv(*a) for a in conv_args]
        captured = unrouted_inputs(unet)
        errs = unrouted_module_errors(unet, captured)
    torch.cuda.synchronize()
    t_path = time.perf_counter() - t0
    counts = read_launches()
    report['launches']['unrouted'] = counts
    report['unrouted'] = errs
    finite = all(bool(torch.isfinite(o).all()) for o in outs)
    shapes = {k: list(v.shape) for k, v in captured.items()}
    log(f'# unrouted path ({t_path:.2f} s, the 16-frame U-Net forward '
        f'included): outputs finite {finite}; U-Net inputs {json.dumps(shapes)}'
        f'; rel L2 against the routed computation {json.dumps(errs)} (tol '
        f'spatial {UNROUTED_ATTN_TOL:g}, conv {UNROUTED_CONV_TOL:g}) '
        f'{"FAIL" if unrouted_fails(errs) or not finite else "ok"}')
    log(f'# unrouted kernel launches: {json.dumps(counts)}')
    del outs, captured
    if not finite or unrouted_fails(errs):
        raise PhaseError(f'unrouted path: outputs finite {finite}, module '
                         f'errors {errs}')
    missing = [n for n, p in KERNEL_PATH.items()
               if p == 'unrouted' and counts[n] <= 0]
    if missing:
        raise PhaseError(f'kernels not launched on the unrouted path: '
                         f'{missing}')

    # ---- each kernel against its plain version, timed
    f32 = (lambda ts: [t.float() for t in ts])
    for (s, c), (q, k, v) in zip(UNROUTED_ATTN, attn_args):
        b, d = UNROUTED_BATCH, c // heads
        chunk = max(1, (1 << 28) // (heads * s * s))   # <= 1 GiB of logits
        view = (lambda t: t.view(b, s, heads, d))
        with torch.no_grad():
            flash_ms = cuda_time_ms(lambda: fa.flash_attention_kernel(
                view(q), view(k), view(v)), 5)
            desc = f'B={b} S={s} C={c} h={heads}'
            _compare('spatial_self_attention', desc,
                     lambda: sa.spatial_attention_kernel(q, k, v, heads),
                     lambda: sa.spatial_attention_plain(q, k, v, heads, chunk),
                     lambda: sa.spatial_attention_plain(
                         *f32((q, k, v)), heads, max(1, chunk // 2)), report,
                     (4 * b * heads * s * s * d, 2 * 4 * b * s * c),
                     lambda: cuda_time_ms(
                         lambda: _sdpa(view(q), view(k), view(v)), 5),
                     iters=5, exps=b * heads * s * s, flash_ms=flash_ms)
        log(f'# kernel spatial_self_attention {desc}: the port\'s flash '
            f'forward kernel (its routed counterpart) {flash_ms:.3f} ms')
    for (side, c), (x, gamma, beta, weight, bias) in zip(UNROUTED_CONV,
                                                          conv_args):
        n = UNROUTED_BATCH
        scale, shift = gc.gn_scale_shift(*gc.gn_stats(x, 32), gamma, beta)
        a = F.silu(x.float() * scale[:, None, None] + shift[:, None, None]) \
            .bfloat16().permute(0, 3, 1, 2)              # NCHW view, NHWC
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = weight.contiguous(memory_format=torch.channels_last)
        b16 = [t.bfloat16() for t in (gamma, beta, bias)]
        with torch.no_grad():
            conv_ms = cuda_time_ms(lambda: F.conv2d(a, w_cl, b16[2],
                                                    padding=1), 10)
            chain_ms = cuda_time_ms(lambda: F.conv2d(F.silu(F.group_norm(
                x_cl, 32, b16[0], b16[1])), w_cl, b16[2], padding=1), 10)
            wrapper_ms = cuda_time_ms(lambda: gc.fused_gn_silu_conv(
                x, gamma, beta, weight, bias), 10)
            desc = f'N={n} H=W={side} C={c}'
            pixels = n * side * side
            first = gc.gn_silu_conv_kernel(x, scale, shift, weight, bias)
            same = torch.equal(first.view(torch.int16), gc.gn_silu_conv_kernel(
                x, scale, shift, weight, bias).view(torch.int16))
            del first
            _compare('gn_silu_conv', desc,
                     lambda: gc.gn_silu_conv_kernel(x, scale, shift, weight,
                                                    bias),
                     lambda: gc.gn_silu_conv_plain(x, scale, shift, weight,
                                                   bias),
                     lambda: gc.gn_silu_conv_plain(x.float(), scale, shift,
                                                   weight.float(), bias),
                     report, (2 * pixels * c * 9 * c,
                              2 * pixels * 2 * c + 2 * 9 * c * c + 8 * n * c
                              + 4 * c),
                     lambda: conv_ms, relative=True)
        tw, pw, segments, tiles = gc.plan(side, side)
        log(f'# kernel gn_silu_conv {desc}: with the GroupNorm statistics '
            f'(fused_gn_silu_conv) {wrapper_ms:.3f} ms; cuDNN conv2d alone '
            f'(channels-last bf16) {conv_ms:.3f} ms; group_norm + silu + '
            f'conv2d {chain_ms:.3f} ms; plan: {segments} segment(s) of '
            f'{tw} columns at pitch {pw}, {tiles} tiles of '
            f'{gc.ROWS} rows an image; two calls bitwise equal {same}')
        entry = report['kernels']['gn_silu_conv']
        entry.setdefault('chain_ms', chain_ms)
        entry.setdefault('wrapper_ms', wrapper_ms)
        entry['bitwise_repeatable'] = entry.get('bitwise_repeatable',
                                                True) and same
        if not same:
            raise PhaseError(f'gn_silu_conv {desc}: two calls differ')
    for line in ptxas_lines('gn_silu_conv'):
        log(f'# kernel gn_silu_conv ptxas: {line}')
        entry['library_is'] = ('F.conv2d alone (cuDNN, channels-last bf16) '
                               'on the activated input; chain_ms: '
                               'group_norm + silu + conv2d')


# --------------------------------------------------------------- models
def build_pipeline(device, dtype):
    """The full-width models from videoswap_torch.builders (random weights
    from SEED), frozen, as a sampling pipeline."""
    from videoswap_torch.builders import build_models
    from videoswap_torch.pipelines import VideoSwapPipeline
    built = build_models({}, device=device, dtype=dtype, seed=SEED)
    for name in ('unet', 'vae', 'text_encoder', 'adapter'):
        built[name].requires_grad_(False)
    return VideoSwapPipeline(**built)


def cpu_copy(pipe):
    """The same pipeline on the CPU in fp32 (plain versions of every
    kernel), built module by module to bound host memory."""
    import torch
    mods = {}
    for name in ('unet', 'vae', 'text_encoder', 'adapter'):
        m = getattr(pipe, name)
        mods[name] = copy.deepcopy(m).to('cpu', torch.float32)
        torch.cuda.empty_cache()
    return type(pipe)(tokenizer=pipe.tokenizer, sched=pipe.sched, **mods)


def rel_err(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).norm() / b.norm().clamp_min(1e-12))


def conditions(frames, size, points=POINTS):
    import numpy as np
    rs = np.random.RandomState(SEED)
    return {'pred_tracks': (rs.rand(frames, points, 2) * size).astype(
                np.float32),
            'point_embedding': rs.randn(points, 1280).astype(np.float32),
            'index_list': None}


def unet_forward(unet, frames=2):
    """The unet phase's forward: 512x512, 2 frames (or `frames`),
    CFG-prefix dedup, adapter residuals. Inputs come from SEED + 1 rounded to
    bf16, so the GPU bf16 model and the CPU fp32 model see the same values."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 1)
    h8 = SIZE // 8
    x = torch.randn((1, frames, h8, h8, 4), generator=gen)
    text = torch.randn((2, 77, 768), generator=gen)
    res = [torch.randn((2, frames, h8 // r, h8 // r, c), generator=gen) * 0.1
           for r, c in ((1, 320), (2, 640), (4, 1280), (8, 1280))]
    p = next(unet.parameters())
    put = (lambda a: a.to(torch.bfloat16).to(p.device, p.dtype))
    with torch.no_grad():
        return unet(put(x), torch.tensor([501], device=p.device), put(text),
                    [put(r) for r in res], cfg_prefix_dedup=True)


def small_sample(pipe, sampler='ddim', steps=2):
    """The small phase's `sample`: 256x256, 2 frames, 2 DDIM steps (or
    `steps` of `sampler`), CFG and adapter; initial latents from SEED + 2
    rounded to bf16."""
    import numpy as np
    import torch
    size, frames = 256, 2
    lat0 = np.random.RandomState(SEED + 2).randn(
        1, frames, size // 8, size // 8, 4).astype(np.float32)
    dt = next(pipe.unet.parameters()).dtype
    with torch.no_grad():
        return pipe.sample(
            latents=torch.from_numpy(lat0).to(torch.bfloat16).to(dt),
            prompt='a white dog on a wooden floor', video_length=frames,
            height=size, width=size, num_inference_steps=steps,
            guidance_scale=7.5, negative_prompt='low quality',
            conditions=conditions(frames, size), t2i_guidance_scale=0.5,
            t2i_end=0.5, output_type='latent', sampler=sampler)


def phase_unet(report, state):
    import torch
    pipe, cpu = state['pipe'], state['cpu']
    h8 = SIZE // 8
    t0 = time.perf_counter()
    out_gpu = unet_forward(pipe.unet)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_cpu = unet_forward(cpu.unet)
    t_cpu = time.perf_counter() - t0
    err = rel_err(out_gpu, out_cpu)
    ok = (tuple(out_gpu.shape) == (2, 2, h8, h8, 4)
          and bool(torch.isfinite(out_gpu).all()) and err <= MODEL_REL_TOL)
    log(f'# unet 512x512 2 frames CFG: GPU kernels bf16 {t_gpu:.2f} s '
        f'(first call), CPU plain fp32 {t_cpu:.1f} s, rel L2 err {err:.3e} '
        f'(tol {MODEL_REL_TOL:.0e}) {"ok" if ok else "FAIL"}')
    report['unet_rel_err'] = err
    if not ok:
        raise PhaseError(f'unet kernel path vs plain path: rel err {err:.3e}')


def phase_small(report, state):
    import torch
    out_gpu = small_sample(state['pipe'])
    out_cpu = small_sample(state['cpu'])
    err = rel_err(out_gpu, out_cpu)
    ok = bool(torch.isfinite(out_gpu).all()) and err <= SAMPLE_REL_TOL
    log(f'# sample 256x256 2 frames 2 steps: GPU bf16 vs CPU fp32 latents '
        f'rel L2 err {err:.3e} (tol {SAMPLE_REL_TOL:.0e}) '
        f'{"ok" if ok else "FAIL"}')
    report['small_rel_err'] = err
    if not ok:
        raise PhaseError(f'small sample GPU vs CPU: rel err {err:.3e}')


def _kernel_modules():
    import importlib
    return {name: importlib.import_module(f'videoswap_torch.ops.{m}')
            for name, (m, _, _, _) in KERNELS.items()}


def reset_launches():
    mods = _kernel_modules()
    for name, (_, counter, _, _) in KERNELS.items():
        setattr(mods[name], counter, 0)


def read_launches() -> dict:
    mods = _kernel_modules()
    return {name: getattr(mods[name], counter)
            for name, (_, counter, _, _) in KERNELS.items()}


def phase_sample(report, state):
    import numpy as np
    import torch
    pipe = state['pipe']
    kw = dict(prompt='a <catA1> <catA2> with a red bell sitting on a '
                     'wooden floor',
              video_length=FRAMES, height=SIZE, width=SIZE,
              num_inference_steps=STEPS, guidance_scale=7.5,
              negative_prompt='worst quality, low quality, deformed',
              conditions=conditions(FRAMES, SIZE), t2i_guidance_scale=0.5,
              t2i_start=0.0, t2i_end=0.5, output_type='np',
              generator=torch.Generator(device='cuda').manual_seed(SEED))
    marks, last = [], []

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())
        last[:] = [latents]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    t0 = time.perf_counter()
    with torch.no_grad():
        video = pipe.sample(callback=on_step, **kw)
    t_total = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps_s = np.diff([t0] + marks)
    log(f'# sample {FRAMES}x{SIZE}x{SIZE} CFG+adapter {STEPS} DDIM steps: '
        f'total {t_total:.2f} s (text, adapter, steps, VAE decode); per '
        f'U-Net step (s): {" ".join(f"{s:.3f}" for s in steps_s)}; '
        f'peak memory {peak:.2f} GiB')
    log(f'# sample kernel launches: {json.dumps(counts)}')
    report['launches']['sample'] = counts
    report['step_s'] = [float(s) for s in steps_s]
    report['peak_gib'] = peak
    ok = (video.shape == (1, FRAMES, SIZE, SIZE, 3)
          and bool(np.isfinite(video).all()))
    if not ok:
        raise PhaseError(f'sample output {video.shape}, finite '
                         f'{np.isfinite(video).all()}')
    missing = [n for n in FORWARD_KERNELS if counts[n] <= 0]
    if missing:
        raise PhaseError(f'kernels not launched on the sample path: '
                         f'{missing}')

    # the same path with FT_4D: the motion modules take the fused kernel's
    # frame-major layout, whose blocks hold the same locations and do the
    # same arithmetic as the row layout's, so the latents must be equal
    main_lat = last[0]
    marks.clear()
    os.environ['FT_4D'] = '1'
    try:
        reset_launches()
        with torch.no_grad():
            lat4 = pipe.sample(callback=on_step, **dict(
                kw, output_type='latent', generator=torch.Generator(
                    device='cuda').manual_seed(SEED)))
        counts4 = read_launches()
    finally:
        del os.environ['FT_4D']
    diff = float((lat4.float() - main_lat.float()).abs().max())
    steps4 = np.diff([marks[0]] + marks[1:]) if marks else []
    log(f'# sample with FT_4D: per U-Net step (s) after the first '
        f'{" ".join(f"{s:.3f}" for s in steps4)}; latents against the row '
        f'layout\'s: max abs diff {diff:.3e} (must be equal); launches '
        f'{json.dumps(counts4)}')
    report['launches']['sample_4d'] = counts4
    report['sample_4d_max_diff'] = diff
    if counts4['fused_temporal_bfhw'] <= 0 or counts4['fused_temporal'] > 0:
        raise PhaseError(f'FT_4D sample launches: {counts4}')
    if not torch.equal(lat4, main_lat):
        raise PhaseError(f'FT_4D sample latents differ from the row '
                         f'layout\'s: max abs diff {diff:.3e}')


# ---------------------------------------------------------------- training
def make_trainer(pipe, remat='edges'):
    from videoswap_torch.pipelines import VideoSwapTrainer
    return VideoSwapTrainer(
        unet=pipe.unet, vae=pipe.vae, text_encoder=pipe.text_encoder,
        tokenizer=pipe.tokenizer, sched=pipe.sched, adapter=pipe.adapter,
        tune_cfg=dict(TRAIN_TUNE, remat=remat),
        optimizer_cfg={'lr': TRAIN_LR})


def train_batch(frames, size, seed):
    """Frames in [-1, 1], the prompt's ids, point tracks and embeddings, as
    the training dataset gives them, rounded to bf16 so that a bf16 and an
    fp32 model see the same values."""
    import numpy as np
    import torch
    from videoswap_torch.utils.tokenizer import HashTokenizer
    rs = np.random.RandomState(seed)
    cond = conditions(frames, size)
    ids = HashTokenizer()(['a cat with a red bell sitting on a wooden '
                           'floor'], padding='max_length',
                          max_length=77).input_ids
    bf = (lambda a: torch.from_numpy(np.asarray(a, np.float32)).bfloat16()
          .float())
    return {'pixels': bf(rs.rand(1, frames, size, size, 3) * 2 - 1),
            'input_ids': torch.from_numpy(np.asarray(ids)),
            'pred_tracks': bf(cond['pred_tracks']),
            'point_embedding': bf(cond['point_embedding'])}


def adapter_weights(trainer):
    """The adapter's weights, flattened, fp32 on the CPU."""
    import torch
    return torch.cat([p.detach().float().flatten().cpu()
                      for p in trainer.adapter.parameters()])


def moved_share(update) -> float:
    return float((update != 0).float().mean())


def small_train_step(trainer, batch, draws):
    """One loss_fn + backward + AdamW step from a fresh optimizer state:
    (loss, flattened adapter gradient, flattened change of the adapter's
    weights), fp32 on the CPU. The weights are put back afterwards, so that
    every call starts from the same point."""
    import torch
    params = list(trainer.adapter.parameters())
    saved = [p.detach().clone() for p in params]
    before = adapter_weights(trainer)
    trainer.optimizer = trainer.init_state()
    trainer.optimizer.zero_grad(set_to_none=True)
    loss = trainer.loss_fn(batch, draws)
    loss.backward()
    grad = torch.cat([p.grad.float().flatten().cpu() for p in params])
    trainer.optimizer.step()
    update = adapter_weights(trainer) - before
    with torch.no_grad():
        for p, s in zip(params, saved):
            p.copy_(s)
    trainer.optimizer.zero_grad(set_to_none=True)
    trainer.optimizer = trainer.init_state()
    return loss.item(), grad, update


def small_train_inputs(trainer):
    """train_small's batch (256x256, 4 frames) and draws (from SEED + 4 on
    the CPU, rounded to bf16)."""
    import torch
    batch = train_batch(4, 256, SEED + 3)
    draws = trainer.make_draws(batch, torch.Generator().manual_seed(SEED + 4))
    return batch, {k: v.bfloat16().float() if v.is_floating_point() else v
                   for k, v in draws.items()}


def phase_train_small(report, state):
    import torch
    gpu, cpu = make_trainer(state['pipe']), make_trainer(state['cpu'], False)
    batch, draws = small_train_inputs(cpu)
    t0 = time.perf_counter()
    loss_gpu, grad_gpu, upd_gpu = small_train_step(gpu, batch, draws)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    loss_cpu, grad_cpu, upd_cpu = small_train_step(cpu, batch, draws)
    t_cpu = time.perf_counter() - t0
    loss_err = abs(loss_gpu - loss_cpu) / abs(loss_cpu)
    grad_err = rel_err(grad_gpu, grad_cpu)
    upd_err = rel_err(upd_gpu, upd_cpu)
    moved, moved_cpu = moved_share(upd_gpu), moved_share(upd_cpu)
    ok = (torch.isfinite(grad_gpu).all() and loss_err <= TRAIN_LOSS_TOL
          and grad_err <= TRAIN_GRAD_TOL and upd_err <= TRAIN_UPDATE_TOL
          and moved >= TRAIN_MOVED_MIN)
    log(f'# train_small 256x256 4 frames: loss GPU {loss_gpu:.6f} CPU '
        f'{loss_cpu:.6f} rel err {loss_err:.3e} (tol {TRAIN_LOSS_TOL:.0e}); '
        f'adapter grad rel L2 err {grad_err:.3e} (tol {TRAIN_GRAD_TOL:.0e}, '
        f'|grad| {float(grad_cpu.norm()):.4e}); AdamW update rel L2 err '
        f'{upd_err:.3e} (tol {TRAIN_UPDATE_TOL:g}), weights moved GPU '
        f'{moved:.6f} CPU {moved_cpu:.6f} (min {TRAIN_MOVED_MIN}); GPU '
        f'{t_gpu:.2f} s (first call), CPU {t_cpu:.1f} s '
        f'{"ok" if ok else "FAIL"}')
    report.update(train_small_loss_rel_err=loss_err,
                  train_small_grad_rel_err=grad_err,
                  train_small_update_rel_err=upd_err,
                  train_small_moved=moved)
    if not ok:
        raise PhaseError(f'train_small GPU vs CPU: loss {loss_err:.3e}, '
                         f'grad {grad_err:.3e}, update {upd_err:.3e}, '
                         f'moved {moved:.6f}')


def phase_train(report, state):
    import torch
    trainer = make_trainer(state['pipe'])
    dev = trainer.device
    batch = {k: v.to(dev) for k, v in
             train_batch(FRAMES, SIZE, SEED + 5).items()}
    # cached VAE moments, as the training CLI encodes the video once
    with torch.no_grad():
        mean, logvar = trainer.vae.encode_video_moments(
            batch.pop('pixels').bfloat16())
    batch.update(latent_mean=mean, latent_logvar=logvar)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    before = adapter_weights(trainer)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, steps_s = [], []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        loss = trainer.step(batch, gen)
        torch.cuda.synchronize()
        steps_s.append(time.perf_counter() - t0)
        losses.append(loss.item())
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    update = adapter_weights(trainer) - before
    moved = moved_share(update)
    change = float(update.norm() / before.norm())
    log(f'# train {FRAMES}x{SIZE}x{SIZE} {POINTS} points, cached moments, '
        f"remat {trainer.unet.gradient_checkpointing!r}, AdamW lr "
        f'{TRAIN_LR:g}: s per step {" ".join(f"{s:.3f}" for s in steps_s)} '
        f'(first includes cuDNN algorithm selection); losses '
        f'{" ".join(f"{v:.6f}" for v in losses)}; peak memory {peak:.2f} GiB')
    log(f'# train adapter weights ({before.numel()}, fp32): moved '
        f'{moved:.6f} (min {TRAIN_MOVED_MIN}), |change| / |weights| '
        f'{change:.4e}, |change| / (lr sqrt(n)) '
        f'{float(update.norm()) / (TRAIN_LR * before.numel() ** 0.5):.4f}')
    log(f'# train kernel launches ({TRAIN_STEPS} steps, the level-0 '
        f'recompute included): {json.dumps(counts)}')
    report['launches']['train'] = counts
    report.update(train_step_s=steps_s, train_losses=losses,
                  train_peak_gib=peak, train_moved=moved,
                  train_weight_change=change)
    if not all(math.isfinite(v) for v in losses):
        raise PhaseError(f'train losses not finite: {losses}')
    if moved < TRAIN_MOVED_MIN:
        raise PhaseError(f'{TRAIN_STEPS} steps moved {moved:.6f} of the '
                         f'adapter weights (min {TRAIN_MOVED_MIN})')
    missing = [n for n, c in counts.items()
               if c <= 0 and KERNEL_PATH.get(n, 'train') == 'train']
    if missing:
        raise PhaseError(f'kernels not launched on the train path: '
                         f'{missing}')


# ----------------------------------------------------------------- ED-LoRA
# the ED-LoRA path: options of train_edlora.py's docstring at SD-1.5
# defaults (the 2D U-Net (320, 640, 1280, 1280), 8 heads, cross-attention
# width 768; CLIP-L's 12 text layers; the SD VAE), 512x512, batch 1, bf16,
# rank 4, scope attn (128 U-Net and 48 text-encoder sites), on
# EDLORA_IMAGES synthetic concept images, EDLORA_STEPS steps through the
# CLI (the cuts on the written file's '#' lines)
EDLORA_STEPS = 6
EDLORA_IMAGES = 4
EDLORA_SITES = (128, 48)
EDLORA_YAML = """\
# train_edlora.py's docstring config at SD-1.5 defaults
# cut: total_iter 100 -> {steps}
# cut: print_freq 10 -> 1, save_checkpoint_freq 100 -> {steps}
# cut: no path.pretrained_model_path: random weights from manual_seed
# cut: {images} synthetic 512x512 concept images (a disc on noise)
name: edlora_catA
manual_seed: 0
mixed_precision: bf16
path: {{}}
concepts:
  catA1: {{init_token: cat}}
datasets:
  type: ConceptImageDataset
  image_dir: {image_dir}
  caption_template: a photo of a catA1
  resolution: 512
models: {{}}
train:
  lora_rank: 4
  lora_alpha: 1.0
  lora_scope: attn
  optimizer: {{emb_lr: 1.e-3, lora_lr: 1.e-4}}
  max_grad_norm: 1.0
  total_iter: {steps}
logger: {{print_freq: 1, save_checkpoint_freq: {steps}}}
"""
# edlora_small: the same models at 64x64 (8x8 latents: level 0's spatial
# attention on the flash kernels at S = 64, levels 1-3, S <= 16, on the
# temporal-attention kernel and its plain backward), alpha EDLORA_ALPHA and
# non-zero factors (so that the merge shows in the loss and in both
# factors' gradients), the same inputs and draws on both sides: the loss
# (relative) and each group's flattened gradient (relative L2), GPU bf16
# against CPU fp32; then the trainer's update (each group clipped by its
# own norm, AdamW) on the card against the script's restatement of optax's
# (edlora_update_reference) on the same two gradients, both groups above
# the clip norm: relative L2 of the change, fp32 on the card. The change
# (about lr an entry) is read as the difference of fp32 weights of ~0.05,
# whose rounding (torch's decay and step round twice, the restatement
# once) is ~1e-5 of it: on the CPU at the smoke widths the sound reading
# is 2.7e-5, one clip over both groups reads 1.1e-2. Sound readings on the
# H100 (the phase's first run): loss 2.0e-4, gradients 1.79e-2
# (embeddings: a sum over every text-encoder and U-Net cross-attention
# layer's bf16 backward) and 1.53e-2 (factors), update 6.1e-6; the
# gradients' limit sits at about 2x those
EDLORA_SMALL_SIZE = 64
EDLORA_ALPHA = 0.7
EDLORA_OPT = {'emb_lr': 1e-3, 'lora_lr': 1e-4, 'weight_decay': 0.01}
EDLORA_LOSS_TOL = 5e-3
EDLORA_GRAD_TOL = 4e-2
EDLORA_UPDATE_TOL = 2e-4


def edlora_models(device, dtype):
    """The ED-LoRA path's 2D models at SD-1.5 width from SEED
    (build_models without motion modules), frozen, and the tokenizer."""
    from videoswap_torch.builders import build_models
    built = build_models({'models': {'unet': {'unet_cfg': {
        'use_motion_module': False}}}}, device=device, dtype=dtype,
        seed=SEED)
    for name in ('unet', 'vae', 'text_encoder'):
        built[name].requires_grad_(False)
    built.pop('adapter')
    return built


def edlora_trainer(models, max_grad_norm=None):
    from videoswap_torch.edlora_train import EDLoRATrainer, lora_sites
    return EDLoRATrainer(
        unet=models['unet'], text_encoder=models['text_encoder'],
        vae=models['vae'], sched=models['sched'],
        unet_sites=lora_sites(models['unet'], 'unet'),
        text_sites=lora_sites(models['text_encoder'], 'text_encoder'),
        alpha=EDLORA_ALPHA, optimizer_cfg=EDLORA_OPT,
        max_grad_norm=max_grad_norm)


def edlora_small_inputs(trainer, cfg_tokenizer):
    """The train params (the concept's warm start plus noise, down ~ U(+-1/
    sqrt(I)), up ~ N(0, 0.02^2): non-zero, so the merge matters), a
    64x64 image and the 16 layer-variant ids, and two draws, all made on
    the CPU from SEED + 8 and rounded to bf16: (params, batch, [draws,
    draws])."""
    import numpy as np
    import torch
    from videoswap_torch.edlora_train import (init_concept_embedding,
                                              register_concepts,
                                              tokenize_layer_prompts)
    gen = torch.Generator().manual_seed(SEED + 8)
    bf = (lambda t: t.bfloat16().float())
    cfg = register_concepts(cfg_tokenizer, ['catA1'])
    emb = init_concept_embedding(trainer.text_encoder, cfg_tokenizer, 'cat')
    params = {'concept_emb': {'catA1': bf(
        emb.cpu() + 0.01 * torch.randn(emb.shape, generator=gen))},
        'unet_lora': {}, 'text_lora': {}}
    for part, module, sites in (
            ('unet_lora', trainer.unet, trainer.unet_sites),
            ('text_lora', trainer.text_encoder, trainer.text_sites)):
        for site in sites:
            o, i = module.get_parameter(site.name).shape[:2]
            params[part][site.torch_key] = {
                'down': bf((torch.rand((LORA_RANK, i), generator=gen) * 2
                            - 1) * i ** -0.5),
                'up': bf(torch.randn((o, LORA_RANK), generator=gen) * 0.02)}
    size = EDLORA_SMALL_SIZE
    batch = {'pixels': bf(torch.rand((1, 1, size, size, 3), generator=gen)
                          * 2 - 1),
             'input_ids': torch.from_numpy(np.asarray(tokenize_layer_prompts(
                 cfg_tokenizer, 'a photo of a catA1', cfg)))}
    draws = [{k: bf(v) if v.is_floating_point() else v
              for k, v in trainer.make_draws(batch, gen).items()}
             for _ in range(2)]
    return params, batch, draws


def edlora_params_on(params, device):
    """A copy of the train params on `device`, fp32 leaves that require
    grad."""
    from videoswap_torch.edlora_train import param_groups
    out = {'concept_emb': {k: v.to(device, copy=True)
                           for k, v in params['concept_emb'].items()},
           **{part: {k: {n: t.to(device, copy=True) for n, t in p.items()}
                     for k, p in params[part].items()}
              for part in ('unet_lora', 'text_lora')}}
    groups = param_groups(out)
    for t in groups['emb'] + groups['lora']:
        t.requires_grad_(True)
    return out


def edlora_grads(trainer, params, batch, draws):
    """(loss, {group: flattened gradient, fp32 on the card's device}) of one
    loss_fn + backward."""
    import torch
    from videoswap_torch.edlora_train import param_groups
    groups = param_groups(params)
    for t in groups['emb'] + groups['lora']:
        t.grad = None
    loss = trainer.loss_fn(params, batch, draws)
    loss.backward()
    return loss.item(), {k: torch.cat([t.grad.float().flatten() for t in v])
                         for k, v in groups.items()}


def edlora_update_reference(params, grads_seq, max_norm):
    """optax's multi_transform of two adamw groups, each chained after
    clip_by_global_norm, restated: per group and step, g scaled by
    max_norm / |g| where |g| >= max_norm, then Adam's moments, the
    bias-corrected update and the decoupled decay (the embeddings without
    decay). params: {group: flat tensor}; grads_seq: [{group: flat}]."""
    import torch
    b1, b2, eps = 0.9, 0.999, 1e-8
    lr = {'emb': EDLORA_OPT['emb_lr'], 'lora': EDLORA_OPT['lora_lr']}
    wd = {'emb': 0.0, 'lora': EDLORA_OPT['weight_decay']}
    out = {}
    for k, p in params.items():
        p = p.clone()
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        for t, grads in enumerate(grads_seq, 1):
            g = grads[k]
            norm = g.norm()
            if norm >= max_norm:
                g = g / norm * max_norm
            m = b1 * m + (1 - b1) * g
            v = b2 * v + (1 - b2) * g * g
            upd = (m / (1 - b1 ** t)) / ((v / (1 - b2 ** t)).sqrt() + eps)
            p = p - lr[k] * (upd + wd[k] * p)
        out[k] = p
    return out


def edlora_update_error(trainer, params, grads_seq) -> tuple[float, float]:
    """The trainer's update (its optimizer from init_state, two steps of
    `update` on the given gradients) against edlora_update_reference from
    the same params, with the clip norm half the smallest group norm (every
    group clipped at every step): (relative L2 error of the change, the
    clip norm)."""
    import torch
    from videoswap_torch.edlora_train import param_groups
    dev = trainer.device
    max_norm = 0.5 * min(float(g.norm()) for gs in grads_seq
                         for g in gs.values())
    trainer.max_grad_norm = max_norm
    tp = edlora_params_on(params, dev)
    groups = param_groups(tp)
    flat = (lambda: {k: torch.cat([t.detach().flatten() for t in v])
                     for k, v in groups.items()})
    before = flat()
    opt = trainer.init_state(tp)
    for grads in grads_seq:
        for k, ts in groups.items():
            off = 0
            for t in ts:
                t.grad = grads[k][off:off + t.numel()].view_as(t).clone()
                off += t.numel()
        trainer.update(opt)
    after = flat()
    ref = edlora_update_reference(before, grads_seq, max_norm)
    change = torch.cat([after[k] - before[k] for k in before])
    ref_change = torch.cat([ref[k] - before[k] for k in before])
    return rel_err(change, ref_change), max_norm


def edlora_small_errors(gpu, cpu_ref, inputs) -> dict:
    """edlora_small's readings for the card's trainer `gpu` against the CPU's
    (loss, grads) `cpu_ref` on `inputs` (edlora_small_inputs)."""
    params, batch, draws = inputs
    tp = edlora_params_on(params, gpu.device)
    loss, grads = edlora_grads(gpu, tp, batch, draws[0])
    _, grads2 = edlora_grads(gpu, tp, batch, draws[1])
    ref_loss, ref_grads = cpu_ref
    upd_err, max_norm = edlora_update_error(gpu, params, [grads, grads2])
    return {'loss': abs(loss - ref_loss) / abs(ref_loss),
            'grad_emb': rel_err(grads['emb'], ref_grads['emb']),
            'grad_lora': rel_err(grads['lora'], ref_grads['lora']),
            'update': upd_err, 'clip_norm': max_norm,
            'finite': bool(all(g.isfinite().all() for g in grads.values()))}


def edlora_small_fails(errs) -> list:
    fails = [k for k, tol in (('loss', EDLORA_LOSS_TOL),
                              ('grad_emb', EDLORA_GRAD_TOL),
                              ('grad_lora', EDLORA_GRAD_TOL),
                              ('update', EDLORA_UPDATE_TOL))
             if not errs[k] <= tol]
    return fails + ([] if errs['finite'] else ['finite'])


def edlora_small_setup() -> dict:
    """The card's trainer (bf16 models), the CPU's (fp32 copies), the
    inputs and the CPU's loss and gradients."""
    import torch
    gpu_models = edlora_models('cuda', torch.bfloat16)
    cpu_models = dict(gpu_models)
    for name in ('unet', 'vae', 'text_encoder'):
        cpu_models[name] = copy.deepcopy(gpu_models[name]).to(
            'cpu', torch.float32)
    gpu, cpu = edlora_trainer(gpu_models), edlora_trainer(cpu_models)
    inputs = edlora_small_inputs(cpu, cpu_models['tokenizer'])
    t0 = time.perf_counter()
    params, batch, draws = inputs
    cpu_ref = edlora_grads(cpu, edlora_params_on(params, 'cpu'), batch,
                           draws[0])
    return {'gpu': gpu, 'cpu_ref': cpu_ref, 'inputs': inputs,
            'cpu_s': time.perf_counter() - t0}


def phase_edlora_small(report, state):
    import torch
    s = edlora_small_setup()
    t0 = time.perf_counter()
    errs = edlora_small_errors(s['gpu'], s['cpu_ref'], s['inputs'])
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    fails = edlora_small_fails(errs)
    n_u, n_t = len(s['gpu'].unet_sites), len(s['gpu'].text_sites)
    log(f'# edlora_small {EDLORA_SMALL_SIZE}x{EDLORA_SMALL_SIZE}, SD-1.5 '
        f'width 2D, {n_u} + {n_t} sites, rank {LORA_RANK}, alpha '
        f'{EDLORA_ALPHA}: GPU bf16 vs CPU fp32 loss rel err '
        f'{errs["loss"]:.3e} (tol {EDLORA_LOSS_TOL:.0e}), grads rel L2 '
        f'embeddings {errs["grad_emb"]:.3e}, factors {errs["grad_lora"]:.3e}'
        f' (tol {EDLORA_GRAD_TOL:.0e}); the trainer\'s two updates (clip '
        f'norm {errs["clip_norm"]:.4e} a group) vs the restated optax on '
        f'the card: change rel L2 {errs["update"]:.3e} (tol '
        f'{EDLORA_UPDATE_TOL:.0e}); GPU {t_gpu:.2f} s (two passes, first '
        f'calls), CPU {s["cpu_s"]:.1f} s '
        f'{"FAIL " + str(fails) if fails else "ok"}')
    report['edlora_small'] = errs
    del s
    torch.cuda.empty_cache()
    if fails:
        raise PhaseError(f'edlora_small: {fails} {json.dumps(errs)}')


def write_concept_images(image_dir: Path, n: int, size: int,
                         seed: int = SEED) -> None:
    """n synthetic concept images, size x size PNG: a coloured disc at a
    random place on uniform noise."""
    import numpy as np
    from videoswap_torch.utils.png import write_png
    rs = np.random.RandomState(seed)
    image_dir.mkdir(parents=True, exist_ok=True)
    yy, xx = np.mgrid[0:size, 0:size]
    for i in range(n):
        img = rs.rand(size, size, 3) * 0.6
        cy, cx = rs.uniform(0.3, 0.7, 2) * size
        disc = (yy - cy) ** 2 + (xx - cx) ** 2 < (0.2 * size) ** 2
        img[disc] = rs.rand(3)
        write_png(str(image_dir / f'{i}.png'),
                  (img * 255).round().astype(np.uint8))


def edlora_run(tree: Path) -> dict:
    """The ED-LoRA CLI (`videoswap_torch.train_edlora`) on EDLORA_YAML in
    `tree`: the readings of the edlora phase's checks (with the LoRA init
    and every frozen weight copied when the trainer is built), the step
    times, peak memory and launches."""
    from unittest import mock

    import torch
    from videoswap_torch import train_edlora as tcli
    from videoswap_torch.edlora_train import EDLoRATrainer, param_groups
    write_concept_images(tree / 'concepts', EDLORA_IMAGES, 512)
    yml = tree / 'edlora_catA.yml'
    yml.write_text(EDLORA_YAML.format(steps=EDLORA_STEPS,
                                      images=EDLORA_IMAGES,
                                      image_dir=tree / 'concepts'))
    seen = {}

    class Recording(EDLoRATrainer):
        def __post_init__(self):
            super().__post_init__()
            seen['frozen'] = {
                name: {k: v.detach().clone() for k, v in
                       getattr(self, name).state_dict().items()}
                for name in ('unet', 'text_encoder', 'vae')}

        def init_train_params(self, generator, concept_emb, rank=4):
            out = super().init_train_params(generator, concept_emb, rank)
            seen['init'] = {k: [t.detach().clone() for t in v]
                            for k, v in param_groups(out).items()}
            return out

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    resident = torch.cuda.memory_allocated() / 2 ** 30
    reset_launches()
    t0 = time.perf_counter()
    with mock.patch.object(tcli, 'EDLoRATrainer', Recording):
        out = tcli.train(str(tree), types.SimpleNamespace(
            opt=str(yml), device='cuda', shard=None))
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    trainer, tp = out['trainer'], out['train_params']
    groups = param_groups(tp)
    # the U-Net's factors and the text encoder's apart: {part: moved share}
    n_unet = 2 * len(trainer.unet_sites)
    moved = {}
    for part, sl in (('embeddings', ('emb', slice(None))),
                     ('unet factors', ('lora', slice(0, n_unet))),
                     ('text factors', ('lora', slice(n_unet, None)))):
        new = torch.cat([t.detach().flatten() for t in groups[sl[0]][sl[1]]])
        old = torch.cat([t.flatten() for t in seen['init'][sl[0]][sl[1]]])
        moved[part] = float((new != old).float().mean())
    changed = [f'{name}.{k}' for name in seen['frozen']
               for k, v in getattr(trainer, name).state_dict().items()
               if not torch.equal(v, seen['frozen'][name][k])]
    ckpt = out['checkpoints'][EDLORA_STEPS]
    sd = torch.load(ckpt, map_location='cpu', weights_only=True)
    want = {part: {f'{s.torch_key[:-len(".weight")]}.lora_{f}.weight'
                   for s in sites for f in ('down', 'up')}
            for part, sites in (('unet', trainer.unet_sites),
                                ('text_encoder', trainer.text_sites))}
    keys_ok = all(set(sd[p]) == want[p] for p in want)
    cfg_file = Path(ckpt).parent / 'new_concept_cfg.json'
    steps = out['step_s']
    return {'losses': out['losses'], 'step_s': steps,
            'mean_step_s': sum(steps[1:]) / max(len(steps) - 1, 1),
            'total_s': total, 'peak_gib': peak, 'resident_gib': resident,
            'launches': counts,
            'launches_per_step': {k: v / EDLORA_STEPS
                                  for k, v in counts.items() if v},
            'sites': [len(trainer.unet_sites), len(trainer.text_sites)],
            'moved': moved, 'frozen_changed': changed[:8],
            'n_frozen_changed': len(changed), 'checkpoint': ckpt,
            'checkpoint_keys_ok': keys_ok,
            'new_concept_cfg': json.loads(cfg_file.read_text())
            if cfg_file.is_file() else None,
            'concept_rows': {k: list(v.shape) for k, v in
                             sd['new_concept_embedding'].items()}}


def edlora_reload(pipe, ckpt: str, alpha: float = 1.0) -> dict:
    """The trained file through load_edlora_into_pipeline into the 3D
    pipeline: every merged weight against W + alpha up @ down from the
    file (the sum in fp32, rounded once to W's bf16, as the consumer's
    docstring states), bit for bit; the concept's 16 rows registered; the
    weights restored after."""
    import torch
    from videoswap_torch.edlora import (load_edlora_into_pipeline,
                                        restore_pipeline)
    from videoswap_torch.models.converters import clip_key_unmap
    sd = torch.load(ckpt, map_location='cpu', weights_only=True)
    # the concept's tokens go into a copy of the tokenizer: added to the
    # pipeline's own, they would shift the ids of the later phases' concepts
    tokenizer, pipe.tokenizer = pipe.tokenizer, copy.deepcopy(pipe.tokenizer)
    ctx = load_edlora_into_pipeline(pipe, ckpt, alpha)
    try:
        worst, merged = 0.0, {}
        for part, module, unmap in (('unet', pipe.unet, None),
                                    ('text_encoder', pipe.text_encoder,
                                     clip_key_unmap)):
            n = 0
            for key in sd[part]:
                if not key.endswith('.lora_down.weight'):
                    continue
                base = key[:-len('.lora_down.weight')]
                name = (unmap or (lambda k: k))(base + '.weight')
                w0 = ctx[part][name]
                down = sd[part][key].to(w0.device)
                up = sd[part][base + '.lora_up.weight'].to(w0.device)
                ref = (w0.float() + alpha * (
                    up.reshape(up.shape[0], -1) @ down.reshape(
                        down.shape[0], -1)).reshape(w0.shape)).to(w0.dtype)
                got = module.get_parameter(name).detach()
                worst = max(worst, float((got.float() - ref.float())
                                         .abs().max()))
                n += 1
            merged[part] = n
        rows = (pipe.extra_token_embeds.shape[0]
                if pipe.extra_token_embeds is not None else 0)
        concepts = sorted(pipe.new_concept_cfg or {})
    finally:
        restore_pipeline(pipe, ctx)
        pipe.tokenizer = tokenizer
    return {'merged': merged, 'max_abs_diff': worst, 'rows': rows,
            'concepts': concepts}


def edlora_fails(r) -> list:
    fails = []
    if not all(math.isfinite(v) for v in r['losses']):
        fails.append('losses not finite')
    fails += [f'{k} not moved' for k, v in r['moved'].items() if v <= 0]
    if r['n_frozen_changed']:
        fails.append('frozen weights changed')
    if r['sites'] != list(EDLORA_SITES):
        fails.append('sites')
    if not r['checkpoint_keys_ok']:
        fails.append('checkpoint keys')
    rel = r['reload']
    if rel['merged'] != {'unet': EDLORA_SITES[0],
                         'text_encoder': EDLORA_SITES[1]} \
            or rel['max_abs_diff'] != 0.0 or rel['rows'] != 16 \
            or rel['concepts'] != ['catA1']:
        fails.append('reload')
    fails += [f'{n} not launched' for n in
              ('flash_attention_fwd', 'flash_attention_bwd_dq',
               'flash_attention_bwd_dkv', 'geglu_ffn', 'geglu_gate')
              if r['launches'][n] <= 0]
    return fails


def phase_edlora(report, state):
    import tempfile
    import torch
    with tempfile.TemporaryDirectory() as d:
        r = edlora_run(Path(d))
        torch.cuda.empty_cache()
        r['reload'] = edlora_reload(state['pipe'], r['checkpoint'])
    report['launches']['edlora'] = r['launches']
    report['edlora'] = r
    fails = edlora_fails(r)
    log(f'# edlora (train_edlora CLI, {EDLORA_STEPS} steps at 512x512 '
        f'bf16, SD-1.5 width 2D, rank {LORA_RANK}, sites unet '
        f'{r["sites"][0]} text {r["sites"][1]}): s per step '
        f'{" ".join(f"{v:.3f}" for v in r["step_s"])} (mean of steps 2-'
        f'{EDLORA_STEPS} {r["mean_step_s"]:.4f} s; the first includes '
        f'cuDNN algorithm selection), CLI total {r["total_s"]:.1f} s, peak '
        f'{r["peak_gib"]:.2f} GiB (the {r["resident_gib"]:.2f} GiB this '
        f'script held included); losses '
        f'{" ".join(f"{v:.6f}" for v in r["losses"])}; launches a step '
        f'{json.dumps(r["launches_per_step"])}')
    log(f'# edlora checks: moved shares {json.dumps(r["moved"])}; frozen '
        f'weights changed {r["n_frozen_changed"]}; checkpoint keys = sites '
        f'{r["checkpoint_keys_ok"]}, concept rows '
        f'{json.dumps(r["concept_rows"])}; reload into the 3D pipeline '
        f'{json.dumps(r["reload"])} '
        f'{"FAIL " + str(fails) if fails else "ok"}')
    if fails:
        raise PhaseError(f'edlora: {fails}')


# ---------------------------------------------------------------- blended
def blend_video(frames, size, seed):
    """A synthetic source video from the seed, (1, F, size, size, 3) in
    [-1, 1]: random plane waves translating 2 px a frame, rounded to bf16
    values so that a bf16 and an fp32 model see the same input."""
    import numpy as np
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
    out = np.zeros((1, frames, size, size, 3), np.float32)
    for _ in range(6):
        k = rs.randn(2) * 2 * np.pi / 40
        phase, amp = rs.rand() * 2 * np.pi, rs.rand(3) * 0.3
        for f in range(frames):
            wave = np.sin(k[0] * (yy - f) + k[1] * (xx - 2 * f) + phase)
            out[0, f] += wave[..., None] * amp
    import torch
    return torch.from_numpy(np.clip(out, -1, 1)).bfloat16().float().numpy()


def edlora_file(pipe, path, seed=SEED, concepts=BLEND_CONCEPTS):
    """A synthetic ED-LoRA checkpoint for the pipeline's models: the
    concepts' 16 layer embeddings each, and a rank-LORA_RANK LoRA (down ~
    N(0, 1/in), up ~ N(0, 0.02^2)) on every eligible U-Net and text-encoder
    weight."""
    import torch
    from videoswap_torch.edlora import _TEXT_LORA, _UNET_LORA, _eligible
    from videoswap_torch.models.converters import clip_key_map
    gen = torch.Generator().manual_seed(seed)

    def loras(module, names, key_map=None):
        out = {}
        for k, w in module.state_dict().items():
            if _eligible(k, names):
                key = key_map(k) if key_map else k
                o, i, *kern = w.shape
                out[key.replace('.weight', '.lora_down.weight')] = \
                    torch.randn((LORA_RANK, i, *kern), generator=gen) \
                    * i ** -0.5
                out[key.replace('.weight', '.lora_up.weight')] = \
                    torch.randn((o, LORA_RANK, *kern), generator=gen) * 0.02
        return out

    hid = pipe.text_encoder.cfg.hidden_size
    sd = {'new_concept_embedding': {
        c: torch.randn((16, hid), generator=gen) * 0.02
        for c in concepts},
        'unet': loras(pipe.unet, _UNET_LORA),
        'text_encoder': loras(pipe.text_encoder, _TEXT_LORA, clip_key_map)}
    torch.save({'params': sd}, path)
    return len(sd['unet']) // 2, len(sd['text_encoder']) // 2


def blend_config(lora_path, recompute):
    return {'use_invertion_latents': True, 'use_blend': True,
            'guidance_scale': 7.5, 'num_inference_steps': BLEND_STEPS,
            'negative_prompt': BLEND_NEGATIVE, 't2i_guidance_scale': 0.5,
            't2i_start': 0.0, 't2i_end': 0.3,
            'recompute_self_stores': recompute,
            'editing_prompts': {'man_to_hermione': dict(
                BLEND_SWAP, lora_path=f'{lora_path}---{BLEND_LORA_ALPHA}')}}


def blend_open_steps(steps: int) -> list[int]:
    """The edit steps at which the latent blend runs: its gate in
    videoswap_torch/p2p/edit.py, 0.2 N < step + 1 < 0.8 N (int parts)."""
    return [i for i in range(steps)
            if int(0.2 * steps) < i + 1 < int(0.8 * steps)]


class BlendCheck:
    """A `validation(callback=...)` that sees the latent blend. The blend
    returns x_src + m (x_tgt - x_src) with x_src the inversion's latents
    (edit step i takes inversion step N-1-i's, cast to the latents' dtype):
    where the mask m is 0 the edited latents equal them bit for bit. So at
    each step where the blend runs, `shares` holds the share of the
    latents' entries equal to those inversion latents; at the other edit
    steps `chance` holds the same share, the rate at which edited latents
    meet the inversion's by chance. `ok()`: every blended step's share
    exceeds every chance share (the blend put latents back) and is below 1
    (the mask is not 0 everywhere)."""

    def __init__(self, steps: int):
        self.steps, self.open = steps, set(blend_open_steps(steps))
        self.inv, self.shares, self.chance = {}, {}, {}

    def __call__(self, stage, i, t, latents):
        if stage == 'invert':
            self.inv[i] = latents.detach().clone()
            return
        ref = self.inv[self.steps - 1 - i].to(latents.dtype)
        share = float((latents == ref).float().mean())
        (self.shares if i in self.open else self.chance)[f'{stage} {i}'] = \
            share

    def ok(self) -> bool:
        floor = max(self.chance.values(), default=0.0)
        return bool(self.shares) and all(
            floor < v < 1.0 for v in self.shares.values())

    def summary(self) -> str:
        return (f'exact-match shares at the blended steps '
                f'{json.dumps(self.shares)}, at the others (chance) '
                f'{json.dumps(self.chance)}')


def blend_small_run(pipe, lora, recompute, blend_th=None):
    """blend_small's swap: `validation` of a synthetic 2-frame 256x256
    clip, BLEND_STEPS steps, with the ED-LoRA file `lora` (and `blend_th`
    for the blend threshold, if given); its latents and the BlendCheck of
    the run."""
    frames, size = 2, 256
    config = blend_config(lora, recompute)
    if blend_th is not None:
        swap = config['editing_prompts']['man_to_hermione']
        swap['blend_cfg'] = dict(swap['blend_cfg'], blend_th=blend_th)
    check = BlendCheck(BLEND_STEPS)
    out = pipe.validation(blend_video(frames, size, SEED + 6),
                          conditions(frames, size), BLEND_PROMPT, config,
                          output_type='latent',
                          callback=check)['man_to_hermione']
    return out, check


def phase_blend_small(report, state):
    import tempfile
    import torch
    pipe, cpu = state['pipe'], state['cpu']
    probe = [pipe.unet.down_blocks[0].attentions[0].transformer_blocks[0]
             .attn1.to_q.weight, pipe.text_encoder.layers[0].self_attn
             .q_proj.weight]
    before = [p.detach().clone() for p in probe]
    errs = {}
    with tempfile.TemporaryDirectory() as d:
        lora = os.path.join(d, 'edlora_hermione.pth')
        edlora_file(pipe, lora)
        for tier in (False, True):
            t0 = time.perf_counter()
            out, _ = blend_small_run(pipe, lora, tier)
            torch.cuda.synchronize()
            t_gpu = time.perf_counter() - t0
            t0 = time.perf_counter()
            ref, _ = blend_small_run(cpu, lora, tier)
            t_cpu = time.perf_counter() - t0
            err = rel_err(out, ref)
            errs[tier] = err
            ok = bool(torch.isfinite(out).all()) and err <= BLEND_REL_TOL
            log(f'# blend_small 256x256 2 frames {BLEND_STEPS} steps, '
                f'ED-LoRA swap, recompute_self {tier}: GPU bf16 vs CPU fp32 '
                f'latents rel L2 err {err:.3e} (tol {BLEND_REL_TOL:g}); GPU '
                f'{t_gpu:.2f} s, CPU {t_cpu:.1f} s {"ok" if ok else "FAIL"}')
            if not ok:
                raise PhaseError(f'blend_small (recompute_self {tier}) GPU '
                                 f'vs CPU: rel err {err:.3e}')
        _, check = blend_small_run(pipe, lora, True, BLEND_CHECK_TH)
        log(f'# blend_small recompute_self True, blend_th {BLEND_CHECK_TH}, '
            f'GPU: {check.summary()} {"ok" if check.ok() else "FAIL"}')
        if not check.ok():
            raise PhaseError(f'blend_small: the latent blend is not seen: '
                             f'{check.summary()}')
    restored = all(torch.equal(a, b) for a, b in zip(before, probe))
    report['blend_small_rel_err'] = {('recompute' if k else 'stored'): v
                                     for k, v in errs.items()}
    report['blend_small_exact_shares'] = check.shares
    if not restored:
        raise PhaseError('blend_small: the ED-LoRA merge was not undone')


def phase_blend(report, state):
    import tempfile
    import numpy as np
    import torch
    from videoswap_torch.edlora import (load_edlora_into_pipeline,
                                        restore_pipeline)
    pipe = state['pipe']
    video = blend_video(FRAMES, SIZE, SEED + 7)
    cond = conditions(FRAMES, SIZE)
    marks = {'invert': [], 'edit': []}

    def on_step(stage, i, t, latents):
        torch.cuda.synchronize()
        marks['invert' if stage == 'invert' else 'edit'].append(
            time.perf_counter())

    def timed(fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory() as d:
        lora = os.path.join(d, 'edlora_hermione.pth')
        n_unet, n_text = edlora_file(pipe, lora)
        # the merge and restore that validation runs around the swap, alone
        ctx, t_merge = timed(load_edlora_into_pipeline, pipe, lora,
                             BLEND_LORA_ALPHA)
        _, t_restore = timed(restore_pipeline, pipe, ctx)
        del ctx                  # the originals' copies, off the peak
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        video_out = pipe.validation(
            video, cond, BLEND_PROMPT, blend_config(lora, True),
            output_type='np', callback=on_step)['man_to_hermione']
        torch.cuda.synchronize()
        t_total = time.perf_counter() - t0
        counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    inv_s = np.diff([t0] + marks['invert'])
    edit_s = np.diff(marks['invert'][-1:] + marks['edit'])
    log(f'# blend {FRAMES}x{SIZE}x{SIZE} man_to_hermione, recompute_self, '
        f'{BLEND_STEPS} DDIM steps: total {t_total:.2f} s; inversion s per '
        f'step (the first with the VAE encode) '
        f'{" ".join(f"{v:.3f}" for v in inv_s)}; edit s per step (the '
        f'first with the ED-LoRA merge, its 16-layer text encode, the edit '
        f'bundle and the adapter; the recompute pass in the first '
        f'{int(0.5 * BLEND_STEPS)}) {" ".join(f"{v:.3f}" for v in edit_s)}; '
        f'ED-LoRA merge of {n_unet} U-Net and {n_text} text-encoder LoRAs '
        f'(rank {LORA_RANK}) {t_merge:.3f} s, restore {t_restore:.3f} s '
        f'(alone, before the swap); peak memory {peak:.2f} GiB')
    log(f'# blend kernel launches: {json.dumps(counts)}')
    report['launches']['blend'] = counts
    report.update(blend_invert_s=[float(v) for v in inv_s],
                  blend_edit_s=[float(v) for v in edit_s],
                  blend_merge_s=t_merge, blend_restore_s=t_restore,
                  blend_peak_gib=peak, blend_total_s=t_total)
    if not (video_out.shape == (1, FRAMES, SIZE, SIZE, 3)
            and bool(np.isfinite(video_out).all())):
        raise PhaseError(f'blend output {video_out.shape}, finite '
                         f'{np.isfinite(video_out).all()}')
    missing = [n for n in FORWARD_KERNELS if counts[n] <= 0]
    if missing:
        raise PhaseError(f'kernels not launched on the blend path: {missing}')


# ----------------------------------------------------------------- recipes
def dpm_step_reference(alphas_cumprod, t, delta, x, eps, prev_x0, i, n):
    """One DPM-Solver++(2M) step restated in float64 numpy (the scheduler's
    module docstring's formulas), an epsilon-predicting model: (x_t,
    x0_s)."""
    import numpy as np

    def alpha(tt):
        return 1.0 if tt < 0 else float(alphas_cumprod[min(tt, 999)])

    def als(a):
        al, sg = np.sqrt(a), max(np.sqrt(1.0 - a), 1e-4)
        return al, sg, np.log(al / sg)

    a_cur = alpha(t)
    x0 = (x - np.sqrt(1.0 - a_cur) * eps) / np.sqrt(a_cur)
    _, sg_c, lam_c = als(a_cur)
    al_n, sg_n, lam_n = als(alpha(t - delta))
    _, _, lam_p = als(alpha(t + delta))
    h = lam_n - lam_c
    d = x0
    if not (i == 0 or (n < 15 and i == n - 1)):
        r = (lam_c - lam_p) / h
        d = (1 + 1 / (2 * r)) * x0 - (1 / (2 * r)) * prev_x0
    return (sg_n / sg_c) * x - al_n * np.expm1(-h) * d, x0


def dpm_step_errors(sched) -> dict:
    """The DPM++ step on the card (fp32, the sampler's own call) against
    its float64 restatement, relative L2, at second-order steps of 5- and
    20-step schedules (and 20's last, second order there)."""
    import numpy as np
    import torch
    from videoswap_torch.schedulers import dpm
    rs = np.random.RandomState(SEED + 8)
    ac = sched.alphas_cumprod.double().numpy()
    errs = {}
    for n, i in ((DPM_STEPS, 1), (DPM_STEPS, DPM_STEPS - 2), (20, 1),
                 (20, 10), (20, 19)):
        t = int(dpm.dpm_timesteps(1000, n)[i])
        x, eps, prev = (rs.randn(1, 2, 32, 32, 4) for _ in range(3))
        put = (lambda a: torch.from_numpy(a).float().cuda())
        out, x0 = dpm.dpm_pp_2m_step(sched, put(eps), t, put(x), put(prev),
                                     i, n)
        ref, ref_x0 = dpm_step_reference(ac, t, 1000 // n, x, eps, prev, i,
                                         n)
        errs[f'{n} steps, step {i}'] = max(
            float(np.linalg.norm(out.double().cpu().numpy() - ref)
                  / np.linalg.norm(ref)),
            float(np.linalg.norm(x0.double().cpu().numpy() - ref_x0)
                  / np.linalg.norm(ref_x0)))
    return errs


def dpm_small_errors(pipe, cpu=None, ref=None) -> dict:
    """dpm_small's readings: the latents of `sample(sampler='dpmpp_2m')`,
    GPU against the CPU pipeline `cpu` (or its latents `ref`), and the step
    on the card against float64."""
    import torch
    out = small_sample(pipe, 'dpmpp_2m', DPM_STEPS)
    if ref is None:
        ref = small_sample(cpu, 'dpmpp_2m', DPM_STEPS)
    return {'latents': rel_err(out, ref),
            'finite': bool(torch.isfinite(out).all()),
            'step': dpm_step_errors(pipe.sched)}


def dpm_small_fails(errs) -> list:
    fails = []
    if not errs['finite'] or errs['latents'] > SAMPLE_REL_TOL:
        fails.append('latents')
    if max(errs['step'].values()) > DPM_STEP_TOL:
        fails.append('step')
    return fails


def phase_dpm_small(report, state):
    errs = dpm_small_errors(state['pipe'], state['cpu'])
    fails = dpm_small_fails(errs)
    log(f'# dpm_small 256x256 2 frames {DPM_STEPS} DPM++(2M) steps: GPU bf16 '
        f'vs CPU fp32 latents rel L2 err {errs["latents"]:.3e} (tol '
        f'{SAMPLE_REL_TOL:.0e}); the step on the card (fp32) vs float64, '
        f'rel L2: {json.dumps({k: float(f"{v:.3e}") for k, v in errs["step"].items()})} '
        f'(tol {DPM_STEP_TOL:.0e}) {"FAIL " + str(fails) if fails else "ok"}')
    report['dpm_small'] = errs
    if fails:
        raise PhaseError(f'dpm_small: {fails} off: {errs}')


def rewrite_yaml(text: str, values: dict, keep: dict) -> str:
    """A config's text with the value of each dotted key of `values` set
    (the `key: value` line at that nesting; a trailing comment goes with
    the old value; a key the file lacks is added as its parent mapping's
    first entry), and in each mapping `keep` names (dotted) only the entry
    it keeps, the others' lines dropped."""
    out, stack, drop_indent = [], [], None
    parents, seen = {}, set()
    for line in text.splitlines():
        body = line.lstrip(' ')
        indent = len(line) - len(body)
        if drop_indent is not None:
            if not body or body.startswith('#') or indent > drop_indent:
                continue
            drop_indent = None
        m = re.match(r'([^:#\-{\[][^:#]*):(\s|$)', body)
        if not m:
            out.append(line)
            continue
        key = m.group(1).strip()
        while stack and stack[-1][0] >= indent:
            stack.pop()
        parent = '.'.join(k for _, k in stack)
        if parent in keep and key != keep[parent]:
            drop_indent = indent
            continue
        stack.append((indent, key))
        path = '.'.join(k for _, k in stack)
        seen.add(path)
        if path in values:
            line = f'{" " * indent}{key}: {values[path]}'
        out.append(line)
        parents.setdefault(path, (len(out), indent))
    for path in [p for p in values if p not in seen][::-1]:
        parent, _, leaf = path.rpartition('.')
        at, indent = parents[parent]
        out.insert(at, f'{" " * (indent + 2)}{leaf}: {values[path]}')
        parents = {k: (i + (i >= at), d) for k, (i, d) in parents.items()}
    return '\n'.join(out) + '\n'


def recipe_texts() -> list:
    """The RECIPES' prompts, negative prompts and replacements: the corpus
    of the generated tokenizer's merges."""
    from videoswap_torch.utils.config import load_config
    texts = []
    for recipe in RECIPES.values():
        opt = load_config(str(ROOT / recipe['path']))
        cfg = opt['val']['editing_config']
        texts += [opt['datasets']['prompt'], cfg.get('negative_prompt', '')]
        texts += [s['replace'] for s in cfg['editing_prompts'].values()]
    return texts


def write_experiment_tree(models: dict, root: Path, concepts: dict,
                          dtype=None) -> dict:
    """`models` (unet, vae, text_encoder, adapter) written under `root` as
    the shipped recipes' files are: `pretrained/` a diffusers SD-1.5
    directory (`unet/diffusion_pytorch_model.bin` without the motion
    modules, with its `config.json`; `vae/...` with the attention under the
    deprecated query/key/value/proj_attn names; `text_encoder/
    pytorch_model.bin` under transformers' names with the position-id
    buffer old exports carry; `tokenizer/` a generated vocabulary, see
    clip_vocab), the motion modules alone in `mm_sd_v14.ckpt` with their
    sinusoidal `pos_encoder.pe` tables as AnimateDiff stores them, the
    adapter's fp32 state dict in `adapter.pth`, and one synthetic ED-LoRA
    file a swap (`concepts`: {file name: concept names}), weights in
    `dtype` (fp16 as published). Returns {model: {the model's key: the
    tensor written}}."""
    import torch
    from videoswap_torch.models.converters import clip_key_map
    dtype = dtype or torch.float16
    pre = root / 'pretrained'
    for sub in ('unet', 'vae', 'text_encoder', 'tokenizer'):
        (pre / sub).mkdir(parents=True, exist_ok=True)

    def cast(module, dt):
        return {k: v.detach().to('cpu', dt)
                for k, v in module.state_dict().items()}

    written = {name: cast(models[name], dtype)
               for name in ('unet', 'vae', 'text_encoder')}
    written['adapter'] = cast(models['adapter'], torch.float32)
    unet = models['unet']
    motion = {k: v for k, v in written['unet'].items()
              if '.motion_modules.' in k}
    for name, buf in unet.named_buffers():
        if '.motion_modules.' in name and name.endswith('.pe'):
            for j in (0, 1):
                motion[f'{name[:-3]}.attention_blocks.{j}.pos_encoder.pe'] = \
                    buf[None].detach().to('cpu', dtype)
    torch.save({k: v for k, v in written['unet'].items() if k not in motion},
               pre / 'unet' / 'diffusion_pytorch_model.bin')
    torch.save(motion, root / 'mm_sd_v14.ckpt')
    cfg = unet.cfg
    (pre / 'unet' / 'config.json').write_text(json.dumps({
        'block_out_channels': list(cfg.block_out_channels),
        'layers_per_block': cfg.layers_per_block,
        'attention_head_dim': cfg.attention_head_dim,
        'cross_attention_dim': cfg.cross_attention_dim,
        'norm_num_groups': cfg.norm_num_groups}))
    legacy = {'.to_q.': '.query.', '.to_k.': '.key.', '.to_v.': '.value.',
              '.to_out.0.': '.proj_attn.'}

    def vae_key(k):
        for new, old in legacy.items():
            if 'attentions' in k and new in k:
                return k.replace(new, old)
        return k
    torch.save({vae_key(k): v for k, v in written['vae'].items()},
               pre / 'vae' / 'diffusion_pytorch_model.bin')
    text = {clip_key_map(k): v for k, v in written['text_encoder'].items()}
    text['text_model.embeddings.position_ids'] = torch.arange(77)[None]
    torch.save(text, pre / 'text_encoder' / 'pytorch_model.bin')
    vocab, merges = clip_vocab(recipe_texts())
    (pre / 'tokenizer' / 'vocab.json').write_text(json.dumps(vocab))
    (pre / 'tokenizer' / 'merges.txt').write_text(merges)
    (pre / 'tokenizer' / 'tokenizer_config.json').write_text(
        json.dumps({'model_max_length': 77}))
    torch.save(written['adapter'], root / 'adapter.pth')
    for name, names in concepts.items():
        edlora_file(types.SimpleNamespace(**models), root / name,
                    concepts=names)
    return written


def write_clip(root: Path, frames: int, size: int, taps: dict,
               points: int = POINTS, emb: int = 1280) -> None:
    """blend_video's synthetic clip as `frames` PNG frames at size x size
    under `root/frames/`, and a TAP.pth for each entry of `taps` ({file
    name: (height, width) of the recipe's transformed frames}): `points`
    random tracks in those pixels (the last point hidden, x = -1, in every
    other frame), `emb`-wide embeddings, a name for each point."""
    import numpy as np
    import torch
    from videoswap_torch.utils.png import write_png
    video = blend_video(frames, size, SEED + 9)[0]
    u8 = np.clip(np.round((video + 1.0) * 127.5), 0, 255).astype(np.uint8)
    (root / 'frames').mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(u8):
        write_png(str(root / 'frames' / f'{i:05d}.png'), f)
    rs = np.random.RandomState(SEED + 10)
    for name, (h, w) in taps.items():
        tracks = rs.rand(frames, points, 2) * [w, h]
        tracks[::2, -1] = -1.0
        torch.save({'pred_tracks': torch.from_numpy(tracks).float(),
                    'point_embedding': torch.from_numpy(
                        rs.randn(points, emb)).float(),
                    'point_name2id': {n: i for i, n in
                                      enumerate(TAP_NAMES[:points])}},
                   root / name)


def load_errors(models: dict, written: dict, load_report: dict) -> dict:
    """For each model the recipe loaded: its missing and unused keys (the
    loader's report) and the number of its tensors that differ from the
    tensor written, cast to the model's dtype (a key not written or not
    loaded counts)."""
    import torch
    out = {}
    for name, sd in written.items():
        own = models[name].state_dict()
        missing, unused = load_report.get(name, (list(own), []))
        differ = sum(k not in own or not torch.equal(
            own[k].cpu(), v.to(own[k].dtype)) for k, v in sd.items())
        differ += sum(k not in sd for k in own)
        out[name] = {'missing': len(missing), 'unused': len(unused),
                     'differ': differ, 'tensors': len(own)}
    return out


def load_fails(errs) -> list:
    return [n for n, e in errs.items()
            if e['missing'] or e['unused'] or e['differ']]


def vispoint_errors(plain, vis, conditions, radius=5) -> dict:
    """Where a swap's `_vispoint` frames differ from its frames: pixels
    outside every disc of radius + 2 around a visible, selected point
    (`outside`: PIL's raster of a radius-5 disc lies within 6.5 px of the
    point), changed pixels not the overlay's green (`not_green`), and
    visible, selected points whose own pixel is not green
    (`centres_missed`); each must be 0."""
    import numpy as np
    tracks = np.asarray(conditions['pred_tracks'], np.float64)
    sel = conditions.get('index_list')
    sel = range(tracks.shape[1]) if sel is None else sel
    f, h, w = plain.shape[:3]
    yy, xx = np.mgrid[0:h, 0:w]
    allowed = np.zeros((f, h, w), bool)
    missed = 0
    green = np.array([0, 255, 0], np.uint8)
    for i in range(f):
        for p in sel:
            x, y = tracks[i, p]
            if x < 0 or y < 0:
                continue
            allowed[i] |= (xx - x) ** 2 + (yy - y) ** 2 <= (radius + 2) ** 2
            if int(y) < h and int(x) < w and \
                    (vis[i, int(y), int(x)] != green).any():
                missed += 1
    changed = (vis != plain).any(-1)
    return {'outside': int((changed & ~allowed).sum()),
            'not_green': int((changed & (vis != green).any(-1)).sum()),
            'centres_missed': missed, 'changed': int(changed.sum())}


def vispoint_fails(errs) -> bool:
    return bool(errs['outside'] or errs['not_green'] or errs['centres_missed']
                or not errs['changed'])


def recipe_config(root: Path, name: str, tree: Path, recipe=None,
                  extra=None, suffix: str = '') -> Path:
    """RECIPES[name]'s shipped config (or `recipe`'s) rewritten into
    `tree` as `<its stem><suffix>.yml`: its file paths pointing at the
    tree's files, its cuts and the `extra` values made (each cut listed
    on a '#' line at its top)."""
    recipe = recipe or RECIPES[name]
    text = (root / recipe['path']).read_text()
    swap = recipe['swap']
    sw = f'val.editing_config.editing_prompts.{swap}'
    values = {
        'datasets.path': tree / 'frames',
        'datasets.tap_path': tree / recipe['tap'],
        'models.unet.inference_config_path':
            root / 'options/model_cfg/inference.yml',
        'models.unet.motion_module_path': tree / 'mm_sd_v14.ckpt',
        'models.adapter.model_config_path':
            root / 'options/model_cfg/point_adapter.yml',
        'path.pretrained_model_path': tree / 'pretrained',
        'path.pretrained_adapter_path': tree / 'adapter.pth',
        f'{sw}.lora_path': f'{tree / recipe["lora"]}---{recipe["alpha"]}',
        **recipe['values'], **(extra or {})}
    if recipe.get('clip'):
        values['path.clip_model_path'] = tree / CLIP_DIR
    text = rewrite_yaml(text, {k: str(v) for k, v in values.items()},
                        {'val.editing_config.editing_prompts': swap})
    head = ''.join(f'# {c}\n' for c in recipe['cuts'])
    out = tree / f'{Path(recipe["path"]).stem}{suffix}.yml'
    out.write_text(head + text)
    return out


def recipe_run(name: str, tree: Path, written: dict,
               device: str = 'cuda') -> dict:
    """One recipe through the CLI (`videoswap_torch.test.test`) on the
    card (or `device`), then `validation` called directly on the CLI's
    models with the same inputs: the readings of the phase's checks and
    the stage times."""
    import numpy as np
    import torch
    from videoswap_torch.pipelines.videoswap_pipeline import \
        make_target_prompt
    from videoswap_torch.test import test
    from videoswap_torch.utils.config import load_config
    recipe = RECIPES[name]
    yml = recipe_config(ROOT, name, tree)
    opt = load_config(str(yml))
    swap = recipe['swap']
    if list(opt['val']['editing_config']['editing_prompts']) != [swap]:
        raise PhaseError(f'recipe {name}: the rewritten config keeps '
                         f'{list(opt["val"]["editing_config"]["editing_prompts"])}')
    torch.cuda.empty_cache()
    resident = torch.cuda.memory_allocated() / 2 ** 30 if device == 'cuda' \
        else 0.0
    reset_launches()
    out = test(str(tree), str(yml), device=device)
    counts = read_launches()
    pipe, ds = out['pipeline'], out['dataset']
    models = {k: getattr(pipe, k) for k in written}
    load = load_errors(models, written, out['load_report'])
    del models
    cfg = out['opt']['val']['editing_config']
    t0 = time.perf_counter()
    direct = pipe.validation(ds.get_frames(), ds.get_conditions(),
                             ds.prompt, cfg, train_dataset=ds,
                             output_type='uint8')
    if device == 'cuda':
        torch.cuda.synchronize()
    t_direct = time.perf_counter() - t0
    frames, ref = out['results'][swap], direct[swap]
    err = float(np.linalg.norm(frames.astype(np.float64) - ref)
                / np.linalg.norm(ref.astype(np.float64)))
    cond = ds.get_conditions()
    names = opt['val']['editing_config']['editing_prompts'][swap].get(
        'select_point')
    cond['index_list'] = (None if not names else
                          [cond['point_name2id'][n] for n in names])
    vis = vispoint_errors(frames, out['results'][swap + '_vispoint'], cond)
    vis_dir = Path(out['opt']['path']['visualization'])
    files = {'metrics.json': (vis_dir / 'metrics.json').is_file(),
             **{f'{k}/frames_{k}': len(list(
                 (vis_dir / k / f'frames_{k}').glob('*.png')))
                == len(frames) for k in ('source', swap, swap + '_vispoint')}}
    if recipe.get('clip'):
        files[f'{swap}_attention/cross_attention.png'] = (
            vis_dir / f'{swap}_attention' / 'cross_attention.png').is_file()
        files['clip_score source, swap'] = all(
            'clip_score' in out['metrics'][k] for k in ('source', swap))
    return {'load': load, 'rel_err': err,
            'bit_equal': bool(np.array_equal(frames, ref)),
            'vispoint': vis, 'files': files, 'launches': counts,
            'timings': out['timings'], 'direct_s': t_direct,
            'resident_gib': resident,
            'shape': list(frames.shape), 'index_list': cond['index_list'],
            'metrics': out['metrics'], 'frames': frames,
            'source_frames': ds.get_frames(), 'opt': out['opt'],
            'tokenizer': pipe.tokenizer, 'prompts': {
                'source': ds.prompt,
                swap: make_target_prompt(ds.prompt, cfg['editing_prompts'][
                    swap])}}


def recipe_fails(r) -> list:
    fails = [f'load {n}' for n in load_fails(r['load'])]
    if r['rel_err'] > RECIPE_REL_TOL:
        fails.append('frames vs direct validation')
    if vispoint_fails(r['vispoint']):
        fails.append('vispoint')
    fails += [f'file {k}' for k, ok in r['files'].items() if not ok]
    fails += [f'launches {k}' for k in FORWARD_KERNELS
              if r['launches'][k] <= 0]
    return fails


def make_recipe_tree(pipe, tree: Path) -> dict:
    """The experiment tree both recipes read, written from `pipe`'s models:
    the models' files, 64 frames at 512x512 and a TAP.pth for each
    recipe's frame size. Returns the written tensors."""
    written = write_experiment_tree(
        {k: getattr(pipe, k) for k in ('unet', 'vae', 'text_encoder',
                                       'adapter')}, tree,
        {r['lora']: r['concepts'] for r in RECIPES.values()})
    write_clip(tree, RECIPE_FRAMES, SIZE,
               {r['tap']: r['frame_hw'] for r in RECIPES.values()})
    write_clip_dir(tree / CLIP_DIR)
    return written


def recipe_tree(state) -> tuple[Path, dict]:
    """The experiment tree of the recipe and train_recipe phases
    (make_recipe_tree from the smoke's pipeline), written once into a
    temporary directory that is removed when `state` lets it go; returns
    (tree, the written tensors)."""
    import tempfile
    if 'recipe_tree' not in state:
        d = tempfile.TemporaryDirectory()
        t0 = time.perf_counter()
        written = make_recipe_tree(state['pipe'], Path(d.name))
        log(f'# recipe: experiment tree written in '
            f'{time.perf_counter() - t0:.1f} s')
        state['recipe_tree'] = (d, written)
    d, written = state['recipe_tree']
    return Path(d.name), written


def phase_recipe(report, state):
    import torch
    report['recipe'] = {}
    tree, written = recipe_tree(state)
    for name in RECIPES:
        r = recipe_run(name, tree, written)
        torch.cuda.empty_cache()
        out = {k: r.pop(k) for k in ('frames', 'source_frames', 'prompts',
                                     'opt', 'tokenizer')}
        if RECIPES[name].get('clip'):
            state['recipe_output'] = dict(out, metrics=r['metrics'])
        report['recipe'][name] = r
        report['launches'][f'recipe_{name}'] = r['launches']
        fails = recipe_fails(r)
        tm = r['timings']
        stages = {k: (round(v['s'], 3) if isinstance(v, dict)
                      else round(v, 3)) for k, v in tm.items()}
        swap = RECIPES[name]['swap']
        log(f'# recipe {name} ({RECIPES[name]["path"]}; '
            f'{"; ".join(RECIPES[name]["cuts"])}): frames '
            f'{r["shape"]}, stages (s; the CLI run\'s peak GiB above the '
            f'{r["resident_gib"]:.3f} GiB this script holds) '
            f'{json.dumps(stages)}; '
            f'{swap} steps (s) '
            f'{" ".join(f"{v:.3f}" for v in tm[swap]["step_s"])}, VAE '
            f'decode {tm[swap]["decode_s"]:.3f} s; inversion steps (s) '
            f'{" ".join(f"{v:.3f}" for v in tm["inversion"]["step_s"])}; '
            f'direct validation {r["direct_s"]:.2f} s')
        log(f'# recipe {name} checks: load {json.dumps(r["load"])}; CLI '
            f'frames vs direct validation rel L2 {r["rel_err"]:.3e} (tol '
            f'{RECIPE_REL_TOL:.0e}), bit-equal {r["bit_equal"]}; '
            f'vispoint (index_list {r["index_list"]}) '
            f'{json.dumps(r["vispoint"])}; files {json.dumps(r["files"])}'
            f'; metrics {json.dumps(r["metrics"])}; launches '
            f'{json.dumps(r["launches"])} '
            f'{"FAIL " + str(fails) if fails else "ok"}')
        if fails:
            raise PhaseError(f'recipe {name}: {fails}')



# ---------------------------------------------------- CLIP and attention
# the swap CLI's CLIP scorer: ViT-L/14 with CLIP-L's text tower (the sizes
# of openai/clip-vit-large-patch14's config.json), random weights from a
# seeded CPU generator (build_clip_scorer, no weights file), at 224x224
CLIP_DIR = 'clip-vit-large-patch14'
CLIP_CONFIG = {
    'projection_dim': 768,
    'vision_config': {'image_size': 224, 'patch_size': 14,
                      'hidden_size': 1024, 'num_hidden_layers': 24,
                      'num_attention_heads': 16, 'intermediate_size': 4096},
    'text_config': {'vocab_size': 49408, 'hidden_size': 768,
                    'num_hidden_layers': 12, 'num_attention_heads': 12,
                    'max_position_embeddings': 77,
                    'intermediate_size': 3072}}
# clip_attn: the swap CLI's scorer (make_clip_scorer) on the card and on the
# CPU, the same weights, fp32 both (TF32 off), on the 1009 recipe CLI run's
# source and swap frames with its prompts and tokenizer (its concept tokens
# included): the image and text embeddings (relative L2) and each score
# (absolute, on the 0-100 scale; the towers' products sum in other orders),
# and the CPU's scores against the clip_score values the CLI wrote to
# metrics.json (rounded there to 3 decimals). The attention dumps: the maps
# of a swap's summed stores (blend_small's swap at its 256x256, 2 frames,
# BLEND_STEPS steps) must be probabilities over the 77 tokens (each row's
# sum 1 within ATTN_ROW_TOL: bf16 maps, summed over the steps in fp32); the
# one-pass dump of the same frames on the card (bf16) against the CPU
# (fp32), relative L2 at MODEL_REL_TOL
CLIP_EMBED_TOL = 1e-4
CLIP_SCORE_TOL = 1e-2
ATTN_ROW_TOL = 1e-2


def write_clip_dir(path: Path, config: dict = CLIP_CONFIG) -> None:
    """A CLIP directory that sizes the scorer (config.json) and holds no
    weights: build_clip_scorer draws them from a fixed seed."""
    path.mkdir(parents=True, exist_ok=True)
    (path / 'config.json').write_text(json.dumps(config))


def clip_inputs(state, d: str) -> dict:
    """What clip_attn scores: the 1009 recipe CLI run's config, root,
    tokenizer, videos ({'source': source frames, swap: swap frames}),
    prompts and metrics.json when the recipe phase ran; else a synthetic
    16-frame 512x512 source clip against BLEND_PROMPT, a CLIP directory
    written into `d`, and no metrics."""
    from videoswap_torch.utils.tokenizer import HashTokenizer
    rec = state.get('recipe_output')
    if rec is not None:
        swap = RECIPES['1009']['swap']
        return {'opt': rec['opt'], 'root': str(recipe_tree(state)[0]),
                'tokenizer': rec['tokenizer'], 'prompts': rec['prompts'],
                'videos': {'source': rec['source_frames'],
                           swap: rec['frames']},
                'metrics': rec['metrics'],
                'source': 'the 1009 recipe CLI run'}
    clip_dir = Path(d) / CLIP_DIR
    write_clip_dir(clip_dir)
    frames = ((blend_video(FRAMES, SIZE, SEED + 7)[0] + 1) * 127.5
              ).round().astype('uint8')
    return {'opt': {'path': {'clip_model_path': str(clip_dir)}}, 'root': d,
            'tokenizer': HashTokenizer(), 'prompts': {'source': BLEND_PROMPT},
            'videos': {'source': frames}, 'metrics': None,
            'source': 'synthetic'}


def clip_scorer(inputs: dict, device: str):
    """The swap CLI's scorer of `inputs`' config on `device`."""
    from videoswap_torch.test import make_clip_scorer
    return make_clip_scorer(inputs['opt'], inputs['root'],
                            inputs['tokenizer'], device)


def clip_readings(scorer, inputs: dict) -> dict:
    """A ClipScorer's embeddings (each video's image embeddings and its
    prompt's text embedding, concatenated, on the CPU) and its score of
    each video against its prompt."""
    import torch
    embeds, scores = [], {}
    for key, prompt in inputs['prompts'].items():
        img, txt = scorer.embeds(inputs['videos'][key], prompt)
        embeds += [img.float().cpu(), txt.float().cpu()]
        scores[key] = scorer.score(img, txt)
    return {'embeds': torch.cat(embeds), 'scores': scores}


def clip_errors(gpu_scorer, inputs: dict, ref: dict) -> dict:
    """The card's embeddings and scores against the CPU's `ref`, and the
    CPU's scores against the CLI's metrics.json where there is one."""
    out = clip_readings(gpu_scorer, inputs)
    keys = inputs['prompts']
    errs = {'embeds_rel_err': rel_err(out['embeds'], ref['embeds']),
            'score_abs_err': max(abs(out['scores'][k] - ref['scores'][k])
                                 for k in keys),
            'scores': out['scores'], 'ref_scores': ref['scores']}
    metrics = inputs['metrics']
    if metrics is not None:
        errs['cli_scores'] = {k: metrics[k].get('clip_score') for k in keys}
        errs['cli_score_abs_err'] = max(
            abs(errs['cli_scores'][k] - ref['scores'][k])
            if errs['cli_scores'][k] is not None else float('inf')
            for k in keys)
    return errs


def clip_fails(errs) -> list:
    return [k for k, tol in (('embeds_rel_err', CLIP_EMBED_TOL),
                             ('score_abs_err', CLIP_SCORE_TOL),
                             ('cli_score_abs_err', CLIP_SCORE_TOL))
            if k in errs and not errs[k] <= tol]


def attn_dump_run(pipe, lora: str, save_dir: str) -> dict:
    """blend_small's swap (256x256, 2 frames, BLEND_STEPS steps, the
    ED-LoRA file `lora`) through `validation` with visualize_attention:
    the maps its dump aggregated from the summed stores, the heatmap strip
    written, and the swap's frames."""
    from unittest import mock

    import numpy as np
    frames, size = 2, 256
    config = dict(blend_config(lora, True), visualize_attention=True)
    seen = {}
    real = pipe._dump_attention_maps

    def dump(*args, **kw):
        seen['summed'] = bool(kw.get('attn_sums'))
        seen['maps'] = real(*args, **kw)
        return seen['maps']

    with mock.patch.object(pipe, '_dump_attention_maps', dump):
        out = pipe.validation(blend_video(frames, size, SEED + 6),
                              conditions(frames, size), BLEND_PROMPT, config,
                              save_dir=save_dir, output_type='uint8')
    strip = Path(save_dir) / 'man_to_hermione_attention' / \
        'cross_attention.png'
    return {'maps': np.asarray(seen['maps']), 'summed': seen['summed'],
            'strip': strip.is_file(), 'frames': out['man_to_hermione']}


def attn_row_error(maps) -> float:
    """The largest |sum over the 77 tokens - 1| of a dump's maps."""
    import numpy as np
    return float(np.abs(maps.astype(np.float64).sum(-1) - 1.0).max())


def attn_dump_fails(run) -> list:
    """attn_dump_run's checks: the dump took the summed stores, wrote its
    strip, and its maps are finite probabilities (rows summing to 1)."""
    import numpy as np
    ok = (run['summed'] and run['strip']
          and bool(np.isfinite(run['maps']).all())
          and attn_row_error(run['maps']) <= ATTN_ROW_TOL)
    return [] if ok else ['attention summed maps']


def phase_clip_attn(report, state):
    import tempfile
    import torch
    pipe, cpu = state['pipe'], state['cpu']
    r = {}
    with tempfile.TemporaryDirectory() as d:
        # the CLIP scorer: the recipe's source and swap (the 1009 swap
        # through the CLI) when the recipe phase ran, else a synthetic clip
        inputs = clip_inputs(state, d)
        t0 = time.perf_counter()
        cpu_scorer = clip_scorer(inputs, 'cpu')
        t_build = time.perf_counter() - t0
        gpu_scorer = clip_scorer(inputs, 'cuda')
        t0 = time.perf_counter()
        ref = clip_readings(cpu_scorer, inputs)
        t_cpu = time.perf_counter() - t0
        del cpu_scorer
        clip_readings(gpu_scorer, inputs)                       # warm-up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        errs = clip_errors(gpu_scorer, inputs, ref)
        torch.cuda.synchronize()
        t_gpu = time.perf_counter() - t0
        del gpu_scorer
        torch.cuda.empty_cache()
        shapes = {k: list(v.shape) for k, v in inputs['videos'].items()}
        r['clip'] = dict(errs, videos=shapes, build_s=t_build, gpu_s=t_gpu,
                         cpu_s=t_cpu)
        fails = [f'clip {k}' for k in clip_fails(errs)]
        cli = ('' if 'cli_scores' not in errs else
               f', metrics.json {json.dumps(errs["cli_scores"])} vs CPU max '
               f'abs err {errs["cli_score_abs_err"]:.3e} (tol '
               f'{CLIP_SCORE_TOL:g})')
        log(f'# clip_attn CLIP ViT-L/14 scorer (make_clip_scorer; '
            f'{inputs["source"]}, videos {json.dumps(shapes)}): GPU vs CPU '
            f'fp32 image and text embeddings rel L2 '
            f'{errs["embeds_rel_err"]:.3e} (tol {CLIP_EMBED_TOL:.0e}), scores '
            f'GPU {json.dumps(errs["scores"])} CPU '
            f'{json.dumps(errs["ref_scores"])}, max abs err '
            f'{errs["score_abs_err"]:.3e} (tol {CLIP_SCORE_TOL:g}){cli}; '
            f'seconds: build (random init on the CPU) {t_build:.1f}, GPU '
            f'scoring {t_gpu:.3f}, CPU scoring {t_cpu:.1f}')

        # the attention dumps: the summed stores of blend_small's swap on
        # the card, then the one-pass dump of its frames, card against CPU
        lora = os.path.join(d, 'edlora_hermione.pth')
        edlora_file(pipe, lora)
        run = attn_dump_run(pipe, lora, os.path.join(d, 'attn'))
        row_err = attn_row_error(run['maps'])
        one = {}
        for side, p in (('gpu', pipe), ('cpu', cpu)):
            with torch.no_grad():
                one[side] = p._dump_attention_maps(
                    BLEND_PROMPT, run['frames'], 'one_pass',
                    os.path.join(d, f'one_{side}'))
        one_err = rel_err(torch.from_numpy(one['gpu']),
                          torch.from_numpy(one['cpu']))
        one_row_err = attn_row_error(one['gpu'])
    r['attention'] = {'summed': run['summed'], 'strip': run['strip'],
                      'shape': list(run['maps'].shape),
                      'row_err': row_err, 'one_pass_rel_err': one_err,
                      'one_pass_row_err': one_row_err}
    report['clip_attn'] = r
    fails += attn_dump_fails(run)
    if not (one_err <= MODEL_REL_TOL and one_row_err <= ATTN_ROW_TOL):
        fails.append('attention one pass')
    log(f'# clip_attn attention dumps (blend_small\'s swap, '
        f'visualize_attention): summed stores {run["summed"]}, strip '
        f'written {run["strip"]}, maps {list(run["maps"].shape)}, rows\' '
        f'|sum - 1| max {row_err:.3e} (tol {ATTN_ROW_TOL:g}); one pass on '
        f'its frames GPU bf16 vs CPU fp32 rel L2 {one_err:.3e} (tol '
        f'{MODEL_REL_TOL:g}), rows\' |sum - 1| {one_row_err:.3e} '
        f'{"FAIL " + str(fails) if fails else "ok"}')
    if fails:
        raise PhaseError(f'clip_attn: {fails}')


# ------------------------------------------------------------- train recipe
def flat_state(sd: dict):
    """A state dict's tensors, flattened in key order, fp32 on the CPU."""
    import torch
    return torch.cat([sd[k].detach().float().flatten().cpu()
                      for k in sorted(sd)])


def state_differences(a, b, path: str = '') -> list[str]:
    """The places where two nested state dicts differ: tensors bit for bit
    (dtype and shape included), everything else by equality."""
    import torch
    if isinstance(a, torch.Tensor) or isinstance(b, torch.Tensor):
        same = (isinstance(a, torch.Tensor) and isinstance(b, torch.Tensor)
                and a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a.cpu(), b.cpu()))
        return [] if same else [path]
    if isinstance(a, dict) and isinstance(b, dict):
        out = [f'{path}.{k}' for k in set(a) ^ set(b)]
        for k in a.keys() & b.keys():
            out += state_differences(a[k], b[k], f'{path}.{k}')
        return out
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)) \
            and len(a) == len(b):
        return [d for i, (x, y) in enumerate(zip(a, b))
                for d in state_differences(x, y, f'{path}[{i}]')]
    return [] if a == b else [path]


def train_cli(yml: Path, tree: Path, resume: bool):
    """One run of the train CLI (`videoswap_torch.train.train`, its default
    device): (its result, its kernel launches, its wall-clock s)."""
    import torch
    from videoswap_torch.train import train
    reset_launches()
    t0 = time.perf_counter()
    out = train(str(tree), types.SimpleNamespace(
        opt=str(yml), resume=resume, device=None, distributed=False))
    torch.cuda.synchronize()
    return out, read_launches(), time.perf_counter() - t0


def direct_train_steps(out: dict, steps: int):
    """`VideoSwapTrainer.step` called directly `steps` times on a train CLI
    run's models, from the adapter its loop started with and a fresh AdamW,
    on a batch made here from its dataset (moments of the bf16 pixels),
    the noise from the config's manual_seed: (losses, the adapter's state
    dict after, on the CPU)."""
    import numpy as np
    import torch
    from videoswap_torch.pipelines import VideoSwapTrainer
    tr, opt = out['trainer'], out['opt']
    tr.adapter.load_state_dict(out['start_state']['adapter'])
    trainer = VideoSwapTrainer(
        unet=tr.unet, vae=tr.vae, text_encoder=tr.text_encoder,
        tokenizer=tr.tokenizer, sched=tr.sched, adapter=tr.adapter,
        tune_cfg=opt['train']['tune_cfg'],
        optimizer_cfg=opt['train']['optimizer'])
    dev = trainer.device
    item = out['dataset'][0]
    tok = trainer.tokenizer
    ids = tok([item['prompt']], padding='max_length',
              max_length=tok.model_max_length, truncation=True).input_ids
    pixels = torch.from_numpy(item['pixels'])[None].to(
        dev, next(trainer.vae.parameters()).dtype)
    with torch.no_grad():
        mean, logvar = trainer.vae.encode_video_moments(pixels)
    batch = {'latent_mean': mean, 'latent_logvar': logvar,
             'input_ids': torch.as_tensor(np.asarray(ids), device=dev),
             'pred_tracks': torch.from_numpy(item['pred_tracks']).to(dev),
             'point_embedding': torch.from_numpy(
                 item['point_embedding']).to(dev)}
    gen = torch.Generator(device=dev).manual_seed(opt['manual_seed'])
    losses = [trainer.step(batch, gen).item() for _ in range(steps)]
    return losses, {k: v.detach().cpu().clone()
                    for k, v in trainer.adapter.state_dict().items()}


def _loss_diff(a: list, b: list) -> float:
    return max(abs(x - y) / abs(y) for x, y in zip(a, b))


def train_recipe_run(tree: Path) -> dict:
    """TRAIN_RECIPE through the train CLI in `tree`: TRAIN_RECIPE_ITERS[0]
    steps; two direct runs of as many steps on that run's models; then
    --resume to TRAIN_RECIPE_ITERS[1], the validation at its last step.
    Returns the readings of the phase's checks."""
    import torch
    from videoswap_torch.builders import load_adapter_checkpoint
    from videoswap_torch.models import SparsePointAdapter
    from videoswap_torch.train import state_snapshot
    n1, n2 = TRAIN_RECIPE_ITERS
    ymls = [recipe_config(ROOT, 'train', tree, TRAIN_RECIPE,
                          {'train.total_iter': n}, f'_iter{n}')
            for n in TRAIN_RECIPE_ITERS]
    torch.cuda.empty_cache()
    first, launches, wall1 = train_cli(ymls[0], tree, resume=False)
    saved = state_snapshot(first['trainer'])
    init = first['start_state']['adapter']
    cli_update = flat_state(saved['adapter']) - flat_state(init)
    direct = [direct_train_steps(first, n1) for _ in range(2)]
    updates = [flat_state(sd) - flat_state(init) for _, sd in direct]
    losses, steps_s = list(first['losses']), list(first['step_s'])
    del first
    torch.cuda.empty_cache()

    second, launches2, wall2 = train_cli(ymls[1], tree, resume=True)
    launches = {k: c + launches2[k] for k, c in launches.items()}
    exp = Path(second['opt']['path']['exp_root'])
    swap = TRAIN_RECIPE['swap']
    frames = len(list((exp / 'visualization' / f'iter_{n2}' / swap /
                       f'frames_{swap}').glob('*.png')))
    trained = {k: v.detach().cpu() for k, v in
               second['trainer'].adapter.state_dict().items()}
    fresh = SparsePointAdapter(second['trainer'].adapter.cfg)
    missing, unused = load_adapter_checkpoint(
        str(exp / 'models' / f'models_{n2}' / 'adapter.pth'), fresh)
    return {
        'start_step': second['start_step'],
        'resume_differences': state_differences(second['start_state'],
                                                saved),
        'losses': losses + second['losses'],
        'moved': moved_share(flat_state(trained) - flat_state(init)),
        'launches': launches, 'iter_frames': frames,
        'adapter_file': {'missing': len(missing), 'unused': len(unused),
                         'differ': len(state_differences(
                             fresh.state_dict(), trained))},
        'cli_vs_direct': {'loss': _loss_diff(losses, direct[0][0]),
                          'update': rel_err(cli_update, updates[0])},
        'direct_spread': {'loss': _loss_diff(direct[1][0], direct[0][0]),
                          'update': rel_err(updates[1], updates[0])},
        'direct_losses': [d[0] for d in direct],
        'step_s': steps_s + second['step_s'],
        'validation': second['validation'].get(n2, {}),
        'wall_s': [wall1, wall2]}


def train_recipe_fails(r) -> list:
    fails = []
    if r['start_step'] != TRAIN_RECIPE_ITERS[0] or r['resume_differences']:
        fails.append('resume')
    if not all(math.isfinite(v) for v in r['losses']):
        fails.append('losses not finite')
    if r['moved'] < TRAIN_MOVED_MIN:
        fails.append('moved')
    fails += [f'launches {k}' for k, c in r['launches'].items()
              if c <= 0 and KERNEL_PATH.get(k, 'train') == 'train']
    if r['iter_frames'] != FRAMES:
        fails.append('validation frames')
    if any(r['adapter_file'].values()):
        fails.append('adapter file')
    if r['cli_vs_direct']['loss'] > TRAIN_CLI_LOSS_TOL or \
            r['cli_vs_direct']['update'] > TRAIN_CLI_UPDATE_TOL:
        fails.append('CLI vs direct')
    return fails


def phase_train_recipe(report, state):
    tree, _ = recipe_tree(state)
    r = train_recipe_run(tree)
    report['train_recipe'] = r
    report['launches']['train_recipe'] = r['launches']
    fails = train_recipe_fails(r)
    steps = r['step_s']
    train_steps = ' '.join(f'{v:.3f}' for v in report.get('train_step_s',
                                                         []))
    val = r['validation']
    log(f'# train_recipe ({TRAIN_RECIPE["path"]}; '
        f'{"; ".join(TRAIN_RECIPE["cuts"])}): CLI steps (s) '
        f'{" ".join(f"{v:.3f}" for v in steps)}, p50 '
        f'{sorted(steps)[len(steps) // 2]:.3f}; the train phase\'s steps '
        f'in this run (s) {train_steps or "not run"}; validation at step {TRAIN_RECIPE_ITERS[1]} '
        f'{val.get("s", float("nan")):.2f} s, peak '
        f'{val.get("peak_gib", float("nan")):.2f} GiB (the process\'s; '
        f'{val.get("resident_gib", float("nan")):.2f} GiB resident at its '
        f'start); CLI runs {" ".join(f"{v:.1f}" for v in r["wall_s"])} s '
        f'(build, load and steps)')
    log(f'# train_recipe checks: resumed at step {r["start_step"]}, state '
        f'differences {r["resume_differences"][:5]}; losses '
        f'{" ".join(f"{v:.6f}" for v in r["losses"])}; adapter weights '
        f'moved {r["moved"]:.6f} (min {TRAIN_MOVED_MIN}); iter frames '
        f'{r["iter_frames"]}; adapter file {json.dumps(r["adapter_file"])}; '
        f'CLI vs direct: loss {r["cli_vs_direct"]["loss"]:.3e} (tol '
        f'{TRAIN_CLI_LOSS_TOL:g}), update rel L2 '
        f'{r["cli_vs_direct"]["update"]:.3e} (tol {TRAIN_CLI_UPDATE_TOL:g}); '
        f'two direct runs: loss {r["direct_spread"]["loss"]:.3e}, update '
        f'{r["direct_spread"]["update"]:.3e} (direct losses '
        f'{json.dumps(r["direct_losses"])}); launches '
        f'{json.dumps(r["launches"])} '
        f'{"FAIL " + str(fails) if fails else "ok"}')
    if fails:
        raise PhaseError(f'train_recipe: {fails}')

# ------------------------------------------------------------------ atlas
def atlas_clip(frames: int, height: int, width: int, device, seed=SEED):
    """A synthetic clip made on `device` from the seed, in the layout of
    `load_input_data`: a background of random plane waves translating by
    ATLAS_BG_SHIFT pixels a frame, and a disk of its own waves moving by
    ATLAS_DISK_SHIFT over it. The mask is the disk, the forward and
    backward flows are exact, the consistency masks come from
    videoswap_torch.atlas.data, dx and dy are the frames' differences."""
    import torch
    from videoswap_torch.atlas.data import get_consistency_mask
    g = torch.Generator(device=device).manual_seed(seed)
    kw = dict(generator=g, device=device)

    def waves(n=4):
        # wavelengths of 20 px and more, random directions and phases
        return ((torch.rand((3, n, 2), **kw) - 0.5) * (4 * math.pi / 20),
                torch.rand((3, n), **kw) * 2 * math.pi)

    def texture(u, v, w):
        freq, phase = w
        arg = (u * freq[..., 0, None, None] + v * freq[..., 1, None, None]
               + phase[..., None, None])
        return (0.5 + 0.5 * torch.sin(arg).mean(1)).permute(1, 2, 0)

    bg_w, disk_w = waves(), waves()
    ys, xs = torch.meshgrid(torch.arange(height, device=device).float(),
                            torch.arange(width, device=device).float(),
                            indexing='ij')
    radius = 0.15 * height
    (bvx, bvy), (dvx, dvy) = ATLAS_BG_SHIFT, ATLAS_DISK_SHIFT
    video = torch.empty((frames, height, width, 3), device=device)
    mask = torch.empty((frames, height, width), device=device)
    for i in range(frames):
        cx, cy = 0.3 * width + dvx * i, 0.55 * height + dvy * i
        inside = (xs - cx) ** 2 + (ys - cy) ** 2 < radius ** 2
        video[i] = torch.where(inside[..., None],
                               texture(xs - cx, ys - cy, disk_w),
                               texture(xs - bvx * i, ys - bvy * i, bg_w))
        mask[i] = inside.float()
    inside = mask[..., None] > 0
    fwd = torch.where(inside, torch.tensor([dvx, dvy], device=device),
                      torch.tensor([bvx, bvy], device=device))
    data = {'video': video, 'mask': mask,
            'dx': torch.zeros_like(video), 'dy': torch.zeros_like(video),
            'flows': torch.zeros((frames, height, width, 2), device=device),
            'flows_rev': torch.zeros((frames, height, width, 2),
                                     device=device),
            'flow_masks': torch.zeros_like(mask),
            'flow_masks_rev': torch.zeros_like(mask)}
    data['dx'][:, :, :-1] = video[:, :, 1:] - video[:, :, :-1]
    data['dy'][:, :-1] = video[:, 1:] - video[:, :-1]
    for i in range(frames - 1):
        data['flows'][i] = fwd[i]
        data['flows_rev'][i + 1] = -fwd[i + 1]
        mf, mb = get_consistency_mask(fwd[i], -fwd[i + 1])
        data['flow_masks'][i] = mf.float()
        data['flow_masks_rev'][i + 1] = mb.float()
    return data


def atlas_trainer(nets, data, device):
    """An AtlasTrainer on the atlas_swan train block for the clip `data`."""
    from videoswap_torch.atlas.trainer import AtlasTrainer
    frames, height, width = data['mask'].shape
    return AtlasTrainer(nets, data, ATLAS_TRAIN, larger_dim=max(height, width),
                        num_frames=frames, device=device)


def atlas_small_inputs(device):
    """atlas_small's trainers: the atlas_swan nets at full width from SEED on
    the card and a CPU copy of them, on one 8-frame 128x96 clip; and the
    draws of a main and an inverse step, from SEED + 6."""
    import numpy as np
    import torch
    from videoswap_torch.builders import build_atlas_nets
    frames, height, width = ATLAS_SMALL
    nets = build_atlas_nets(ATLAS_MODELS, device=device, seed=SEED)
    cpu_nets = {n: copy.deepcopy(net).cpu() for n, net in nets.items()}
    clip = atlas_clip(frames, height, width, 'cpu')
    rs = np.random.RandomState(SEED + 6)
    draws = [tuple(torch.from_numpy(rs.randint(0, hi, 10000))
                   for hi in (width, height, frames)) for _ in range(2)]
    return (atlas_trainer(nets, clip, device),
            atlas_trainer(cpu_nets, clip, 'cpu'), draws)


def atlas_small_step(trainer, draws, global_step=1):
    """One main step and one inverse step from fresh Adam states on the
    given draws: (loss terms as floats, each net's flattened gradient and
    the hash table's, each net's flattened change), fp32 on the CPU. The
    weights are put back afterwards, so every call starts from one point."""
    import torch
    from videoswap_torch.atlas.trainer import INVERSE_NET, MAIN_NETS

    def flat(net, grad=False):
        return torch.cat([(p.grad if grad else p).detach().flatten().cpu()
                          for p in net.parameters()])
    dev = trainer.device
    main, inv = ([t.to(dev) for t in d] for d in draws)
    saved = {n: copy.deepcopy(net.state_dict())
             for n, net in trainer.nets.items()}
    before = {n: flat(net) for n, net in trainer.nets.items()}
    trainer.init_opt_state()
    ld = {k: float(v) for k, v in trainer.step(global_step,
                                               draws=main).items()}
    grads = {n: flat(trainer.nets[n], True) for n in MAIN_NETS}
    grads['hash_table'] = trainer.nets['F_Atlas'].hash_table.grad.flatten() \
        .cpu()
    ld['fg_inv_loss'] = float(trainer.inverse_step(draws=inv))
    grads[INVERSE_NET] = flat(trainer.nets[INVERSE_NET], True)
    updates = {n: flat(net) - before[n] for n, net in trainer.nets.items()}
    for n, net in trainer.nets.items():
        net.load_state_dict(saved[n])
    trainer.init_opt_state()
    return ld, grads, updates


def atlas_small_errors(gpu, cpu) -> dict:
    """GPU against CPU: the worst loss term (relative), the worst net
    gradient and the hash table's (relative L2), the worst net update."""
    (ld_g, gr_g, up_g), (ld_c, gr_c, up_c) = gpu, cpu
    nets = [n for n in gr_c if n != 'hash_table']
    return {
        'loss': max(abs(ld_g[k] - ld_c[k]) / abs(ld_c[k]) for k in ld_c),
        'grad': max(rel_err(gr_g[n], gr_c[n]) for n in nets),
        'hash_grad': rel_err(gr_g['hash_table'], gr_c['hash_table']),
        'update': max(rel_err(up_g[n], up_c[n]) for n in up_c),
        'per_net': {n: [rel_err(gr_g[n], gr_c[n]), rel_err(up_g[n], up_c[n])]
                    for n in up_c},
    }


def atlas_small_fails(errs) -> dict:
    return {'loss': errs['loss'] > ATLAS_LOSS_TOL,
            'grad': errs['grad'] > ATLAS_GRAD_TOL,
            'hash_grad': errs['hash_grad'] > ATLAS_HASH_GRAD_TOL,
            'update': errs['update'] > ATLAS_UPDATE_TOL}


def phase_atlas_small(report, state):
    import torch
    gpu, cpu, draws = atlas_small_inputs('cuda')
    t0 = time.perf_counter()
    out_gpu = atlas_small_step(gpu, draws)
    torch.cuda.synchronize()
    t_gpu = time.perf_counter() - t0
    t0 = time.perf_counter()
    out_cpu = atlas_small_step(cpu, draws)
    t_cpu = time.perf_counter() - t0
    errs = atlas_small_errors(out_gpu, out_cpu)
    fails = atlas_small_fails(errs)
    finite = all(math.isfinite(v) for v in out_gpu[0].values())
    log(f'# atlas_small {"x".join(map(str, ATLAS_SMALL))} batch 10000, '
        f'atlas_swan nets: losses GPU {json.dumps(out_gpu[0])}')
    log(f'# atlas_small GPU vs CPU fp32: worst loss term rel err '
        f'{errs["loss"]:.3e} (tol {ATLAS_LOSS_TOL:.0e}); worst net grad rel '
        f'L2 {errs["grad"]:.3e} (tol {ATLAS_GRAD_TOL:.0e}); hash table grad '
        f'rel L2 {errs["hash_grad"]:.3e} (tol {ATLAS_HASH_GRAD_TOL:g}); '
        f'worst Adam update rel L2 {errs["update"]:.3e} (tol '
        f'{ATLAS_UPDATE_TOL:g}); per net [grad, update] '
        f'{json.dumps(errs["per_net"])}; GPU {t_gpu:.2f} s (first call), '
        f'CPU {t_cpu:.1f} s {"FAIL" if any(fails.values()) else "ok"}')
    report['atlas_small'] = {k: v for k, v in errs.items()}
    if not finite or any(fails.values()):
        raise PhaseError(f'atlas_small GPU vs CPU: {errs}')


def phase_atlas(report, state):
    import numpy as np
    import torch
    from videoswap_torch.atlas.evaluate import evaluate_model
    from videoswap_torch.atlas.propagate import (bind_nets,
                                                 propagate_point_sequence)
    from videoswap_torch.builders import build_atlas_nets
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    nets = build_atlas_nets(ATLAS_MODELS, device='cuda', seed=SEED)
    data = atlas_clip(ATLAS_FRAMES, ATLAS_H, ATLAS_W, 'cuda')
    trainer = atlas_trainer(nets, data, 'cuda')
    del data
    torch.cuda.synchronize()
    log(f'# atlas {ATLAS_FRAMES}x{ATLAS_W}x{ATLAS_H} synthetic clip and '
        f'nets on the card: {time.perf_counter() - t0:.2f} s; fused per-pixel '
        f'array {trainer.fused.numel() * 4 / 2 ** 30:.3f} GiB')
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    reset_launches()
    pre_iters = ATLAS_PRETRAIN_ITER
    pre = {}
    for name in ('FG_UV_Mapping', 'BG_UV_Mapping'):
        t0 = time.perf_counter()
        loss = trainer.pretrain_mapping(name, gen, pre_iters)
        pre[name] = [loss, time.perf_counter() - t0]
    # the main Adam starts afresh after pretraining, as train_atlas.py does
    trainer.init_opt_state()
    log(f'# atlas pretraining, {pre_iters} x {ATLAS_FRAMES} iterations a '
        f'mapping at batch 10000: [final loss, s] {json.dumps(pre)}')
    ev = [[torch.cuda.Event(enable_timing=True) for _ in range(3)]
          for _ in range(ATLAS_STEPS)]
    totals, inv_losses = [], []
    t0 = time.perf_counter()
    for it in range(1, ATLAS_STEPS + 1):
        e = ev[it - 1]
        e[0].record()
        ld = trainer.step(it, gen)
        e[1].record()
        inv_losses.append(trainer.inverse_step(gen))
        e[2].record()
        totals.append(ld['total_loss'])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    warm = ev[10:]
    main_ms = float(np.median([e[0].elapsed_time(e[1]) for e in warm]))
    inv_ms = float(np.median([e[1].elapsed_time(e[2]) for e in warm]))
    totals = torch.stack(totals).cpu().numpy()
    inv_losses = torch.stack(inv_losses).cpu().numpy()
    first, last = float(totals[:20].mean()), float(totals[-20:].mean())
    per_50k = (main_ms + inv_ms) * ATLAS_TRAIN['total_iter'] / 1e3
    log(f'# atlas {ATLAS_STEPS} iterations (main + inverse) at batch 10000: '
        f'{wall:.2f} s; median after 10 iterations: main step {main_ms:.3f} '
        f'ms, inverse step {inv_ms:.3f} ms (CUDA events); '
        f'{ATLAS_TRAIN["total_iter"]} iterations would take {per_50k:.1f} s; '
        f'peak memory {peak:.2f} GiB')
    log(f'# atlas total loss mean of the first 20 iterations {first:.4f}, '
        f'of the last 20 {last:.4f}; inverse loss {inv_losses[0]:.4f} -> '
        f'{inv_losses[-1]:.4f}; last terms '
        f'{json.dumps({k: round(float(v), 6) for k, v in ld.items()})}')
    t0 = time.perf_counter()
    psnr = evaluate_model(trainer.nets, trainer.fused[..., :3], ATLAS_W,
                          ATLAS_H, 4, trainer.norm_s, trainer.norm_t)
    t_psnr = time.perf_counter() - t0
    # drag the disk's centre on frame 0 by (+20, +10) pixels
    cx, cy = round(0.3 * ATLAS_W), round(0.55 * ATLAS_H)
    fg, inv, alpha = bind_nets(trainer.nets)
    tracks = propagate_point_sequence(
        {'p0': [cy, cx]}, {'p0': [cy + 10, cx + 20]}, 0,
        np.zeros((ATLAS_FRAMES, 1, 2), np.float32), {'p0': 0}, fg, inv,
        alpha, max(ATLAS_W, ATLAS_H), ATLAS_FRAMES, trainer.norm_s,
        trainer.norm_t)
    log(f'# atlas reconstruction PSNR over 4 frames {psnr:.4f} dB '
        f'({t_psnr:.2f} s); propagated drag: {int((tracks[:, 0, 0] >= 0).sum())}'
        f' of {ATLAS_FRAMES} frames visible, track finite '
        f'{bool(np.isfinite(tracks).all())}')
    log(f'# atlas kernel launches ({ATLAS_STEPS} main steps): '
        f'{json.dumps(counts)}; hash_table_grad '
        f'{counts["hash_table_grad"] / ATLAS_STEPS:g} a main step')
    report['launches']['atlas'] = counts
    report['atlas'] = dict(main_ms=main_ms, inverse_ms=inv_ms,
                           iters_50k_s=per_50k, peak_gib=peak, psnr_4=psnr,
                           hash_launches_a_main_step=counts['hash_table_grad']
                           / ATLAS_STEPS,
                           loss_first20=first, loss_last20=last,
                           pretrain=pre)
    if not (np.isfinite(totals).all() and np.isfinite(inv_losses).all()):
        raise PhaseError('atlas losses not finite')
    if not last < first:
        raise PhaseError(f'atlas loss did not fall: {first} -> {last}')
    if counts['hash_table_grad'] != ATLAS_STEPS:
        raise PhaseError(f'hash_table_grad launched '
                         f'{counts["hash_table_grad"]} times in '
                         f'{ATLAS_STEPS} main steps, not once a step')
    if not (math.isfinite(psnr) and np.isfinite(tracks).all()):
        raise PhaseError(f'atlas PSNR {psnr} or propagated track not finite')


# ----------------------------------------------------------- atlas recipe
# the shipped atlas recipe through the port's three CLIs, frames to an
# edited TAP file: extract_flow, train_atlas, propagate_point_displacement
ATLAS_RECIPE = {
    'path': 'options/train_atlas/atlas_swan.yml',
    # pretraining as shipped: cut to a tenth (720 iterations a mapping), the
    # trained atlas put the dragged keyframe points where alpha <= 0.5, and
    # hidden tracks cannot show a fault of the drag
    'values': {'train.total_iter': 200, 'logger.save_checkpoint_freq': 100,
               'val.val_freq': 200, 'logger.print_freq': 50},
    'cuts': ['the clip: synthetic frames and masks at 854x480 (DAVIS 480p; '
             'resized to res_x x res_y on loading), flows from '
             'videoswap_torch.extract_flow --method matching'],
}
# the clip as written: frames, height, width (DAVIS 480p)
ATLAS_RECIPE_CLIP = (72, 480, 854)
# frames of the full evaluation run after training (of ATLAS_RECIPE_CLIP's
# 72: all 72 took 160.5 s on the H100's host, most of it writing gifs)
ATLAS_FULL_EVAL_FRAMES = 8
# the drag of the keyframe's points, pixels (x, y), at res_x x res_y
ATLAS_DRAG = (20, 10)
# named points on the disk at frame 0, offsets from its centre (x, y);
# all but the last are dragged (duck.json)
ATLAS_POINTS = {'head': (-30, -20), 'body': (0, 0), 'tail': (25, 15)}
# the median flow on the disk and on the background (forward; backward with
# the sign reversed) within this many pixels of the clip's known motion
ATLAS_FLOW_SHIFT_TOL = 0.25
# the card's compute_bidirectional_flow against the CPU's on two pairs: the
# share of pixels whose flows differ by more than ATLAS_FLOW_OFF_PX, and
# the median difference. Sound readings on the H100: no
# pixel off by 0.5 px, median 3.8e-7 px, max 0.088 px
ATLAS_FLOW_OFF_PX = 0.5
ATLAS_FLOW_OFF_SHARE = 1e-3
ATLAS_FLOW_MEDIAN_TOL = 1e-5
# the matching flow's 7x7 box filter on the card against the CPU, on the
# first pair's gray difference: max |difference| over max |CPU|. Both sum
# fp32; inputs read at TF32 precision (10 mantissa bits) would be off by up
# to 2^-11 relative, a few 1e-4; the candidate choice it feeds moved only
# 2.4e-4 of the pixels by more than 0.01 px then (fault control)
ATLAS_BOX_FILTER_TOL = 1e-5
# the propagated TAP file against a propagation through the trained nets
# moved to the CPU (a witness independent of how good the atlas is): the
# same hidden frames, except where the CPU's scaled alpha is within
# ATLAS_TAP_ALPHA_MARGIN of the 0.5 threshold (fp32 rounding of card and
# CPU may flip such a frame), and the visible positions within
# ATLAS_TAP_CPU_PX pixels (both are rounded to whole pixels)
ATLAS_TAP_CPU_PX = 1.0
ATLAS_TAP_ALPHA_MARGIN = 1e-4
# the validation files evaluate_model writes (videos: .mp4, or .gif where
# imageio is missing), with full=False and the ones full=True adds
ATLAS_VAL_FILES = ('reconstruction.mp4', 'alpha.mp4', 'foreground.mp4',
                   'background.mp4', 'atlas_fg.png', 'atlas_bg.png',
                   'checkerboard.mp4')
ATLAS_FULL_FILES = ATLAS_VAL_FILES + (
    'edit.mp4', 'edited_fg.mp4', 'edited_bg.mp4', 'texture_orig1.png',
    'texture_edit1.png', 'texture_orig2.png', 'texture_edit2.png',
    'checkerboard_fg.mp4', 'checkerboard_bg.mp4', 'uv_fg.mp4',
    'uv_fg_masked.mp4', 'uv_bg.mp4', 'residuals.mp4', 'alpha_vs_gtmask.mp4',
    'global_info.mp4')


def missing_files(folder: Path, names) -> list:
    """The names with no file in `folder` (an .mp4 may be a .gif)."""
    return [n for n in names if not (folder / n).exists()
            and not (n.endswith('.mp4')
                     and (folder / n.replace('.mp4', '.gif')).exists())]


def atlas_recipe_points(height: int, width: int, res_x: int, res_y: int):
    """(source points {name: [y, x]} at frame 0, target points, the tracks
    (F, P, 2) of every point along the disk's known motion), in res_x x
    res_y pixels (the atlas's), the disk of atlas_clip at height x width."""
    import numpy as np
    frames = ATLAS_RECIPE_CLIP[0]
    sx, sy = res_x / width, res_y / height
    cx, cy = 0.3 * width * sx, 0.55 * height * sy
    (dvx, dvy) = ATLAS_DISK_SHIFT
    src, dst = {}, {}
    tracks = np.zeros((frames, len(ATLAS_POINTS), 2), np.float32)
    for p, (name, (ox, oy)) in enumerate(ATLAS_POINTS.items()):
        x, y = round(cx + ox), round(cy + oy)
        src[name] = [y, x]
        if p < len(ATLAS_POINTS) - 1:
            dst[name] = [y + ATLAS_DRAG[1], x + ATLAS_DRAG[0]]
        t = np.arange(frames)
        tracks[:, p, 0] = x + dvx * sx * t
        tracks[:, p, 1] = y + dvy * sy * t
    return src, dst, tracks


def write_atlas_recipe_tree(tree: Path, frames: int, height: int,
                            width: int, res_x: int, res_y: int) -> None:
    """atlas_clip's frames and masks as PNG files under tree/frames and
    tree/masks; the keyframe's points (annotation/00000.json), their drag
    (annotation/duck.json) and a TAP.pth of tracks along the disk's motion
    with 1280-wide embeddings."""
    import numpy as np
    import torch
    from videoswap_torch.utils.png import write_png
    clip = atlas_clip(frames, height, width, 'cuda')
    video = (clip['video'] * 255).round().clamp(0, 255).to(torch.uint8)
    mask = (clip['mask'] * 255).to(torch.uint8)
    video, mask = video.cpu().numpy(), mask.cpu().numpy()
    for sub in ('frames', 'masks', 'annotation'):
        (tree / sub).mkdir(parents=True, exist_ok=True)
    for i in range(frames):
        write_png(str(tree / 'frames' / f'{i:05d}.png'), video[i])
        write_png(str(tree / 'masks' / f'{i:05d}.png'), mask[i])
    src, dst, tracks = atlas_recipe_points(height, width, res_x, res_y)
    (tree / 'annotation' / '00000.json').write_text(json.dumps(src))
    (tree / 'annotation' / 'duck.json').write_text(json.dumps(dst))
    rs = np.random.RandomState(SEED + 11)
    torch.save({'pred_tracks': torch.from_numpy(tracks[:frames]),
                'point_embedding': torch.from_numpy(
                    rs.randn(len(src), 1280).astype(np.float32)),
                'point_name2id': {n: i for i, n in enumerate(src)}},
               tree / 'annotation' / 'TAP.pth')


def flow_shift_errors(flow_dir: Path, mask_dir: Path, frames: int) -> dict:
    """The median forward and backward flow over the disk and over the
    background, pooled over every pair, less the known motion (the
    backward's sign reversed): the largest |difference| of x and y for
    each, pixels; and the worst single pair's."""
    import numpy as np
    from PIL import Image
    known = {'disk': ATLAS_DISK_SHIFT, 'background': ATLAS_BG_SHIFT}
    pooled = {f'{d} {r}': [] for d in ('forward', 'backward')
              for r in known}
    worst = 0.0
    masks = [np.asarray(Image.open(mask_dir / f'{i:05d}.png')) > 127
             for i in range(frames)]
    for i in range(frames - 1):
        fl = np.load(flow_dir / f'{i:05d}.npy')
        for d, f, m, sign in (('forward', fl[0], masks[i], 1),
                              ('backward', fl[1], masks[i + 1], -1)):
            for r, sel in (('disk', m), ('background', ~m)):
                v = f[sel]
                pooled[f'{d} {r}'].append(v)
                worst = max(worst, float(np.abs(
                    np.median(v, axis=0) - sign * np.asarray(known[r])).max()))
    out = {}
    for k, vs in pooled.items():
        d, r = k.split()
        sign = 1 if d == 'forward' else -1
        out[k] = float(np.abs(np.median(np.concatenate(vs), axis=0)
                              - sign * np.asarray(known[r])).max())
    out['worst pair'] = worst
    return out


def flow_device_errors(frame_dir: Path, pairs) -> dict:
    """compute_bidirectional_flow on the card against the CPU on `pairs`:
    the share of pixels (both directions) whose flows differ by more than
    ATLAS_FLOW_OFF_PX, the median and the largest difference, pixels; and
    the seconds of each side."""
    import numpy as np
    from videoswap_torch.extract_flow import read_frame
    from videoswap_torch.preprocess.flow import compute_bidirectional_flow
    diffs, t = [], [0.0, 0.0]
    for i in pairs:
        f0, f1 = (read_frame(frame_dir / f'{j:05d}.png') for j in (i, i + 1))
        out = []
        for j, dev in enumerate(('cuda', 'cpu')):
            t0 = time.perf_counter()
            out.append(compute_bidirectional_flow(f0, f1, 'matching',
                                                  device=dev))
            t[j] += time.perf_counter() - t0
        diffs.append(np.linalg.norm(out[0] - out[1], axis=-1).ravel())
    d = np.concatenate(diffs)
    import torch
    from videoswap_torch.preprocess.flow import _gray
    from videoswap_torch.preprocess.matching_flow import box_filter
    f0, f1 = (torch.from_numpy(read_frame(frame_dir / f'{j:05d}.png'))
              for j in (pairs[0], pairs[0] + 1))
    e = (_gray(f1) - _gray(f0)).abs()
    ref = box_filter(e, 7)
    box = float((box_filter(e.cuda(), 7).cpu() - ref).abs().max()
                / ref.abs().max())
    return {'off_share': float((d > ATLAS_FLOW_OFF_PX).mean()),
            'share_over_0.01px': float((d > 0.01).mean()),
            'median': float(np.median(d)), 'max': float(d.max()),
            'box_filter_rel': box, 'card_s': t[0], 'cpu_s': t[1]}


def direct_atlas_run(cli: dict) -> dict:
    """An AtlasTrainer driven directly from the CLI run's seed on the data
    it loaded: fresh nets from the seed, both mappings pretrained, a fresh
    main Adam, then `step` and `inverse_step` to total_iter. Returns the
    loss terms at the CLI's print steps."""
    import torch
    from videoswap_torch.atlas import trainer as at
    from videoswap_torch.builders import build_atlas_nets
    opt, tr = cli['opt'], cli['trainer']
    fused = tr.fused
    data = {'video': fused[..., at.RGB], 'mask': fused[..., at.MASK],
            'dx': fused[..., at.DX], 'dy': fused[..., at.DY],
            'flows': fused[..., at.FLOW_F], 'flows_rev': fused[..., at.FLOW_B],
            'flow_masks': fused[..., at.VALID_F],
            'flow_masks_rev': fused[..., at.VALID_B]}
    nets = build_atlas_nets(opt['models'], device='cuda', seed=cli['seed'])
    direct = at.AtlasTrainer(nets, data, tr.train_opt, tr.larger_dim,
                             tr.num_frames, device='cuda')
    gen = torch.Generator(device='cuda').manual_seed(cli['seed'])
    pre = int(tr.train_opt.get('pretrain_UV_mapping_iter', 0))
    if pre > 0:
        for name in ('FG_UV_Mapping', 'BG_UV_Mapping'):
            direct.pretrain_mapping(name, gen, pre)
        direct.init_opt_state()
    logged = {}
    for it in range(1, int(tr.train_opt['total_iter']) + 1):
        ld = direct.step(it, gen)
        ld['fg_inv_loss'] = direct.inverse_step(gen)
        if it in cli['logged']:
            logged[it] = {k: float(v) for k, v in ld.items()}
    return logged


def tap_cpu_witness(nets, src, dst, source, card_tracks, larger: int,
                    num_frames: int, norm_s, norm_t) -> dict:
    """The dragged points' tracks propagated through copies of the trained
    nets on the CPU, against the card's: the largest distance over frames
    visible on both, pixels; the frames hidden on one side only, those of
    them where the CPU's scaled alpha lies within ATLAS_TAP_ALPHA_MARGIN of
    0.5, and each point's least |alpha - 0.5| over the frames."""
    import copy

    import numpy as np
    import torch
    from videoswap_torch.atlas import losses
    from videoswap_torch.atlas.propagate import (_frames_uvt, bind_nets,
                                                 propagate_point_sequence)
    cpu = {n: copy.deepcopy(net).cpu() for n, net in nets.items()}
    fg_map, fg_inv, f_alpha = bind_nets(cpu)
    tracks = propagate_point_sequence(
        src, dst, 0, source['pred_tracks'], source['point_name2id'], fg_map,
        fg_inv, f_alpha, larger, num_frames, norm_s, norm_t)
    out = {'max_px': 0.0, 'hidden_differs': 0, 'hidden_differs_at_margin': 0,
           'alpha_margin': {}}
    for n in dst:
        i = source['point_name2id'][n]
        sy, sx = src[n]
        xyt = torch.tensor([[norm_s(sx), norm_s(sy), norm_t(0)]],
                           dtype=torch.float32)
        base = fg_inv(_frames_uvt(fg_map(xyt), num_frames, norm_t))
        margin = (losses.scaled_alpha(f_alpha(base))[:, 0] - 0.5).abs()
        margin = margin.numpy()
        out['alpha_margin'][n] = float(margin.min())
        card_vis = (card_tracks[:, i] >= 0).all(-1)
        cpu_vis = (tracks[:, i] >= 0).all(-1)
        both = card_vis & cpu_vis
        if both.any():
            out['max_px'] = max(out['max_px'], float(np.abs(
                card_tracks[both, i] - tracks[both, i]).max()))
        flip = card_vis != cpu_vis
        out['hidden_differs'] += int(flip.sum())
        out['hidden_differs_at_margin'] += int(
            (flip & (margin < ATLAS_TAP_ALPHA_MARGIN)).sum())
    del cpu
    return out


def atlas_recipe_config(tree: Path, values: dict) -> Path:
    """ATLAS_RECIPE's shipped file rewritten into `tree`: the dataset paths
    pointing at the tree, the cuts and `values` made, each cut on a '#'
    line at its top."""
    from videoswap_torch.utils.config import cfg_get, parse_yaml
    text = (ROOT / ATLAS_RECIPE['path']).read_text()
    shipped = parse_yaml(text)
    vals = {'datasets.frame_path': tree / 'frames',
            'datasets.mask_path': tree / 'masks',
            'datasets.flow_path': tree / 'flows',
            'datasets.annotation_path': tree / 'annotation' / '00000.json',
            **values}
    text = rewrite_yaml(text, {k: str(v) for k, v in vals.items()}, {})
    cuts = [f'cut: {k} {cfg_get(shipped, k)} -> {v}'
            for k, v in values.items()] + ATLAS_RECIPE['cuts']
    out = tree / Path(ATLAS_RECIPE['path']).name
    out.write_text(''.join(f'# {c}\n' for c in cuts) + text)
    return out


def atlas_recipe_run(tree: Path) -> dict:
    """The atlas recipe in `tree`: the clip written; the three CLIs run,
    frames -> flows -> atlas -> TAP_duck.pth, with the launch counts set to
    0 before and read after; then the readings of the phase's checks: the
    flows against the known motion and against the CPU, the CLI's losses
    against a direct AtlasTrainer, the checkpoint reloaded, the PSNR
    again, the files, a full evaluation of ATLAS_FULL_EVAL_FRAMES frames,
    the TAP file against a direct propagation and against one through the
    nets moved to the CPU."""
    import numpy as np
    import torch
    from videoswap_torch import extract_flow
    from videoswap_torch import propagate_point_displacement as ppd
    from videoswap_torch import train_atlas
    from videoswap_torch.atlas.evaluate import evaluate_model
    from videoswap_torch.atlas.propagate import (bind_nets,
                                                 propagate_point_sequence)
    from videoswap_torch.builders import (build_atlas_nets,
                                          load_atlas_checkpoint)
    from videoswap_torch.data.frame_point_dataset import load_tap_file
    from videoswap_torch.preprocess.flow import compute_bidirectional_flow
    from videoswap_torch.utils.config import load_config
    frames, height, width = ATLAS_RECIPE_CLIP
    yml = atlas_recipe_config(tree, ATLAS_RECIPE['values'])
    ds = load_config(str(yml))['datasets']
    res_x, res_y = ds['res_x'], ds['res_y']
    times = {}
    t0 = time.perf_counter()
    write_atlas_recipe_tree(tree, frames, height, width, res_x, res_y)
    times['write clip'] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    extract_flow.cli(['--frame_dir', str(tree / 'frames'), '--out_dir',
                      str(tree / 'flows'), '--method', 'matching'])
    torch.cuda.synchronize()
    times['flow'] = time.perf_counter() - t0
    cli = train_atlas.train(str(tree), types.SimpleNamespace(
        opt=str(yml), device=None, shard=None))
    for k, v in cli['times'].items():
        times[f'train {k}'] = v
    last = max(cli['checkpoints'])
    ann = tree / 'annotation'
    t0 = time.perf_counter()
    tap_path = ppd.main([
        '--atlas_config_path', str(yml), '--atlas_model_path',
        cli['checkpoints'][last], '--source_tap_path', str(ann / 'TAP.pth'),
        '--source_point_path', str(ann / '00000.json'),
        '--target_point_path', str(ann / 'duck.json')])
    torch.cuda.synchronize()
    times['propagation'] = time.perf_counter() - t0
    launches = read_launches()
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    r = {'launches': launches, 'iters': last, 'peak_gib': peak,
         'logged': cli['logged'], 'validation': cli['validation'],
         'pretrain': cli['pretrain']}

    # the flows: known motion, the CLI's files against a direct call, the
    # card against the CPU
    r['flow_shift'] = flow_shift_errors(tree / 'flows', tree / 'masks',
                                        frames)
    from videoswap_torch.extract_flow import read_frame
    f0, f1 = (read_frame(tree / 'frames' / f'{j:05d}.png') for j in (0, 1))
    r['flow_file_differs'] = not np.array_equal(
        np.load(tree / 'flows' / '00000.npy'),
        compute_bidirectional_flow(f0, f1, 'matching'))
    t0 = time.perf_counter()
    r['flow_device'] = flow_device_errors(tree / 'frames',
                                          (0, (frames - 1) // 2))
    times['flow card vs CPU'] = time.perf_counter() - t0

    # the CLI's losses against a direct trainer
    t0 = time.perf_counter()
    direct = direct_atlas_run(cli)
    times['direct trainer'] = time.perf_counter() - t0
    r['cli_vs_direct'] = max(
        abs(v - direct[s][k]) if k in direct[s] else math.inf
        for s, ld in cli['logged'].items() for k, v in ld.items())

    # the checkpoint into fresh nets (another seed), and the PSNR again
    tr = cli['trainer']
    fresh = build_atlas_nets(cli['opt']['models'], device='cuda',
                             seed=cli['seed'] + 1)
    load_atlas_checkpoint(cli['checkpoints'][last], fresh)
    r['checkpoint_differs'] = [
        f'{n}.{k}' for n, net in tr.nets.items()
        for k, v in net.state_dict().items()
        if not torch.equal(v, fresh[n].state_dict()[k])]
    r['checkpoints'] = sorted(cli['checkpoints'])
    views = train_atlas.clip_views(tr)
    r['psnr_reloaded'] = evaluate_model(
        fresh, views['video'], tr.res_x, tr.res_y, tr.num_frames, tr.norm_s,
        tr.norm_t)
    del fresh
    exp = Path(cli['opt']['path']['exp_root'])
    r['val_missing'] = missing_files(exp / 'visualization' / f'Iter_{last}',
                                     ATLAS_VAL_FILES)

    # the full evaluation
    t0 = time.perf_counter()
    r['psnr_full'] = evaluate_model(
        tr.nets, views['video'], tr.res_x, tr.res_y, ATLAS_FULL_EVAL_FRAMES,
        tr.norm_s, tr.norm_t, save_dir=str(tree / 'full_eval'), data=views,
        full=True, uv_mapping_scale=tr.uv_scale, derivative_amount=tr.d_amt)
    torch.cuda.synchronize()
    times['full evaluation'] = time.perf_counter() - t0
    r['full_missing'] = missing_files(tree / 'full_eval', ATLAS_FULL_FILES)
    r['video_files'] = sorted({p.suffix for p in (tree / 'full_eval')
                               .iterdir()})

    # the propagated TAP file against a direct propagation
    src = json.loads((ann / '00000.json').read_text())
    dst = json.loads((ann / 'duck.json').read_text())
    source, edited = load_tap_file(str(ann / 'TAP.pth')), \
        load_tap_file(tap_path)
    larger = max(res_x, res_y)
    tracks = propagate_point_sequence(
        src, dst, 0, source['pred_tracks'], source['point_name2id'],
        *bind_nets(tr.nets), larger, tr.num_frames, tr.norm_s, tr.norm_t)
    et = np.asarray(edited['pred_tracks'])
    r['tap'] = {
        'file': Path(tap_path).name,
        'differs_from_direct': not np.array_equal(et, tracks),
        'keys': sorted(edited) == sorted(source),
        'names': edited['point_name2id'] == source['point_name2id'],
        'shapes': all(np.shape(edited[k]) == np.shape(source[k])
                      for k in source),
        'finite_or_hidden': bool(np.isfinite(et).all() and np.all(
            (et >= 0).all(-1) | (et == -1).all(-1))),
        'undragged_kept': all(np.array_equal(
            et[:, i], source['pred_tracks'][:, i])
            for n, i in source['point_name2id'].items() if n not in dst),
        'visible_frames': {n: int((et[:, source['point_name2id'][n], 0]
                                   >= 0).sum()) for n in dst}}
    t0 = time.perf_counter()
    r['tap']['cpu'] = tap_cpu_witness(tr.nets, src, dst, source, et, larger,
                                      tr.num_frames, tr.norm_s, tr.norm_t)
    times['propagation on the CPU'] = time.perf_counter() - t0
    # a reading, not a check (it turns on the atlas's quality): each
    # dragged point's keyframe row, its distance to the source and to the
    # target (-1: hidden)
    r['tap']['keyframe_to_source_and_target_px'] = {
        n: [float(np.hypot(x - src[n][1], y - src[n][0])),
            float(np.hypot(x - dst[n][1], y - dst[n][0]))] if x >= 0
        else -1 for n in dst
        for x, y in [et[0, source['point_name2id'][n]]]}
    r['times'] = times
    return r


def tap_fails(t) -> list:
    """The checks of the propagated TAP file that fail, from its readings
    (atlas_recipe_run's r['tap'])."""
    fails = []
    if t['differs_from_direct']:
        fails.append('TAP vs direct')
    if not (t['keys'] and t['names'] and t['shapes']):
        fails.append('TAP layout')
    if not (t['finite_or_hidden'] and t['undragged_kept']):
        fails.append('TAP tracks')
    c = t['cpu']
    if c['max_px'] > ATLAS_TAP_CPU_PX or \
            c['hidden_differs'] != c['hidden_differs_at_margin']:
        fails.append('TAP vs CPU')
    return fails


def atlas_recipe_fails(r) -> list:
    fails = []
    if max(v for k, v in r['flow_shift'].items()
           if k != 'worst pair') > ATLAS_FLOW_SHIFT_TOL:
        fails.append('flow vs known motion')
    if r['flow_file_differs']:
        fails.append('flow file vs direct call')
    d = r['flow_device']
    if d['off_share'] > ATLAS_FLOW_OFF_SHARE or \
            d['median'] > ATLAS_FLOW_MEDIAN_TOL or \
            d['box_filter_rel'] > ATLAS_BOX_FILTER_TOL:
        fails.append('flow card vs CPU')
    if r['cli_vs_direct'] != 0:
        fails.append('CLI vs direct')
    if r['launches']['hash_table_grad'] != r['iters']:
        fails.append('hash launches')
    if r['checkpoint_differs']:
        fails.append('checkpoint')
    if r['psnr_reloaded'] != r['validation'][r['iters']]['psnr']:
        fails.append('PSNR of the reloaded nets')
    if r['val_missing'] or r['full_missing']:
        fails.append('validation files')
    fails += tap_fails(r['tap'])
    losses = [v for ld in r['logged'].values() for v in ld.values()]
    if not all(math.isfinite(v) for v in losses) or \
            not math.isfinite(r['psnr_full']):
        fails.append('not finite')
    return fails


def phase_atlas_recipe(report, state):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        r = atlas_recipe_run(Path(d))
    report['atlas_recipe'] = {k: v for k, v in r.items()
                              if k not in ('logged',)}
    report['launches']['atlas_recipe'] = r['launches']
    fails = atlas_recipe_fails(r)
    t = r['times']
    log(f'# atlas_recipe ({ATLAS_RECIPE["path"]}; '
        f'{"; ".join(ATLAS_RECIPE["cuts"])}): stage s '
        f'{json.dumps({k: round(v, 3) for k, v in t.items()})}; peak '
        f'{r["peak_gib"]:.2f} GiB (the three CLIs)')
    log(f'# atlas_recipe flows: median - known motion (px) '
        f'{json.dumps(r["flow_shift"])} (tol {ATLAS_FLOW_SHIFT_TOL}); CLI '
        f'file vs direct call differs {r["flow_file_differs"]}; card vs CPU '
        f'{json.dumps(r["flow_device"])} (tol share > {ATLAS_FLOW_OFF_PX} px '
        f'{ATLAS_FLOW_OFF_SHARE:g}, median {ATLAS_FLOW_MEDIAN_TOL:g}, box '
        f'filter {ATLAS_BOX_FILTER_TOL:g})')
    log(f'# atlas_recipe training: pretraining final losses '
        f'{json.dumps(r["pretrain"])}; logged total loss '
        f'{json.dumps({s: ld["total_loss"] for s, ld in r["logged"].items()})}'
        f'; CLI vs direct AtlasTrainer max |diff| {r["cli_vs_direct"]:.3e} '
        f'(bit-equal required); validation {json.dumps(r["validation"])}; '
        f'PSNR of the reloaded checkpoint {r["psnr_reloaded"]:.6f}; '
        f'checkpoint tensors differing {r["checkpoint_differs"][:5]}; '
        f'checkpoints at {r["checkpoints"]}; hash_table_grad launches '
        f'{r["launches"]["hash_table_grad"]} in {r["iters"]} main steps')
    log(f'# atlas_recipe full evaluation ({ATLAS_FULL_EVAL_FRAMES} frames): '
        f'PSNR {r["psnr_full"]:.4f}; files missing {r["val_missing"]} / '
        f'{r["full_missing"]}; suffixes {r["video_files"]}; TAP '
        f'{json.dumps(r["tap"])} {"FAIL " + str(fails) if fails else "ok"}')
    if fails:
        raise PhaseError(f'atlas_recipe: {fails}')


# --------------------------------------------------------- semantic points
# the trackers' and the pose model's checkpoints are seeded synthetic files
# under the published key sets (no weights are in the repository):
# - CoTracker at its default initialisation is an expanding map in fp32:
#   after one 6-iteration window its tracks in fp32 and in float64 differ
#   by 4.4 px (and the port's and the JAX package's fp32 by about as much),
#   since each iteration moves a point by ~5 px through a random 12-block
#   transformer. Its residual branches (attn.proj, mlp.fc2) x0.1 and its
#   flow head x0.03 make it a contraction, as trained weights are near
#   convergence: fp32 against float64 2.0e-4 px, moves of ~0.6 px a window;
# - OpenPose at its default initialisation outputs its last biases alone
#   (activations shrink ~0.6x a layer over 30-odd layers), flat maps on
#   which the map resize's filter cannot be seen: He-normal weights keep
#   the maps structured (PAF std ~3), and the heat heads' biases of -10
#   keep every heat value below the decode's 0.1 (a random model's peaks
#   would be thousands a part, and the PAF assembly is quadratic in them);
#   calibrated_openpose_state then lifts each part's final bias so that
#   SP_POSE_PEAKS peaks of the clip's first frame pass 0.1, and the decode
#   assembles a few people a frame from them;
# - UniMatch at its default initialisation, wrapped as {'model': ...}.


def _seeded(build, seed: int):
    import torch
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        return build()


def synthetic_cotracker_state(seed: int = SEED) -> dict:
    """cotracker_stride_4_wind_8.pth's state dict, seeded and conditioned
    (see above)."""
    from videoswap_torch.preprocess.cotracker_native import CoTrackerCore
    model = _seeded(CoTrackerCore, seed)
    sd = {k: v.detach().clone() for k, v in model.state_dict().items()}
    for k in sd:
        if k.startswith('updateformer.flow_head.'):
            sd[k] *= 0.03
        elif '.attn.proj.' in k or '.mlp.fc2.' in k:
            sd[k] *= 0.1
    return sd


def synthetic_openpose_state(seed: int = SEED) -> dict:
    """body_pose_model.pth's state dict under its prefix-less published
    keys: He-normal weights, zero biases, the heat heads' -10 (see
    above)."""
    import torch
    from videoswap_torch.preprocess.pose import OpenPoseBody
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in OpenPoseBody().state_dict().items():
        scope, name, kind = k.split('.')
        if kind == 'weight':
            val = torch.randn(v.shape, generator=gen) * math.sqrt(
                2.0 / v[0].numel())
        elif scope.endswith('_2') and name.startswith(('conv5_5', 'Mconv7')):
            val = torch.full_like(v, -10.0)
        else:
            val = torch.zeros_like(v)
        sd[f'{name}.{kind}'] = val
    return sd


def calibrated_openpose_state(frame, device, seed: int = SEED) -> dict:
    """synthetic_openpose_state with the last stage's heat biases lifted:
    each part's by what puts the decode's threshold (pose.THRE1) halfway
    between the SP_POSE_PEAKS-th and the next highest local maximum of its
    blurred map on `frame`, so that that many pass there. The map is that
    convolution plus its bias, and the resizes and the blur keep a
    constant, so a bias moves the blurred map by itself; a pixel above the
    threshold is a peak of the decode where it is no lower than its
    neighbours in the frame (the decode's zeros outside are below it)."""
    import numpy as np
    from videoswap_torch.preprocess import pose
    sd = synthetic_openpose_state(seed)
    model = pose.OpenPoseBody()
    pose.load_openpose_state(model, sd)
    _, heat = pose.NativePoseDetector(model.to(device))._maps(frame)
    bias = sd['Mconv7_stage6_L2.bias']
    for part in range(pose.N_KEYPOINTS):
        sm = pose._gaussian_blur(heat[..., part].astype(np.float64), 3.0)
        p = np.pad(sm, 1, constant_values=-np.inf)
        top = np.sort(sm[(sm >= p[:-2, 1:-1]) & (sm >= p[2:, 1:-1])
                         & (sm >= p[1:-1, :-2]) & (sm >= p[1:-1, 2:])])[::-1]
        bias[part] += pose.THRE1 - (top[SP_POSE_PEAKS - 1]
                                    + top[SP_POSE_PEAKS]) / 2
    return sd


def synthetic_unimatch_state(seed: int = SEED) -> dict:
    """A gmflow-scale2-regrefine6 checkpoint: {'model': the seeded default
    initialisation's state dict}."""
    from videoswap_torch.preprocess.unimatch import UniMatchFlow
    return {'model': _seeded(UniMatchFlow, seed).state_dict()}


# the semantic_points phase: the shipped 2003 swan config's models (its
# `models` and `path` blocks, rewritten into the recipe phase's synthetic
# tree) through `videoswap_torch.extract_semantic_point` on a synthetic clip
# of the config's total_frames at DAVIS 480p (atlas_clip: a textured disk
# moving by ATLAS_DISK_SHIFT over a background moving by ATLAS_BG_SHIFT), a
# keyframe annotation at SP_KEYFRAME (five named points, one empty entry)
SP_CONFIG = ('options/test_videoswap/animal/2003_swan_T05_local_Iter100/'
             '2003_swan_T05_local_Iter100.yml')
SP_CLIP = (64, 480, 854)           # frames, height, width
SP_KEYFRAME = 8
# (on the disk: offset from its centre at the keyframe, or on the
# background: the keyframe's pixel); 'neck' is the annotation's empty entry
SP_POINTS = {'head': ('disk', (30, -20)), 'body': ('disk', (0, 0)),
             'tail': ('disk', (-40, 20)),
             'left_front_leg': ('bg', (650, 120)),
             'right_front_leg': ('bg', (720, 400))}
SP_HUMAN_FRAMES = 8
SP_POSE_PEAKS = 3                   # peaks a part on the first frame
SP_FLOW_FRAMES = 3                  # extract_flow --method unimatch: 2 pairs
# the CPU's side of the checks, cut for the CPU's time (on the H100's
# host the featurizer took 74 s on a whole frame, UniMatch 61 s on a whole
# pair, 16 s and 20 s on a 240x432 crop; the DIFT tracker 31 s on 5 frames,
# most of it the matching flows): the tracker and CoTracker on frames 7-9
# (the keyframe the middle one), the featurizer and UniMatch on the centre
# 160x288 of frames 0 and 1
SP_SUB = (7, 10)
SP_CROP = (160, 288)
SP_CUTS = [
    'the paths point at a synthetic tree: random weights from a seed under '
    'the published file and key names (the recipe phase\'s)',
    'the clip: 64 synthetic PNG frames at 854x480 (a textured disk over a '
    'textured background, known motion), not DAVIS blackswan',
    'the trackers\' and the pose model\'s checkpoints: seeded synthetic '
    'files under the published key sets']
# one frame's DIFT features, the card (bf16) against the CPU (fp32): the
# U-Net's limit (MODEL_REL_TOL). The DIFT tracker on the card against the
# CPU, both fed the same features: the sub-pixel fit reads cosines that
# differ by fp32 rounding, the flows' steps only centre the prior
SP_TRACK_PX = 0.01
# the patch-descriptor stand-in featurizer's tracks against the known motion
# (tests/test_preprocess.py's limit)
SP_STANDIN_PX = 1.5
# CoTracker, OpenPose and UniMatch on the card (fp32, TF32 off) against the
# CPU: CoTracker's tracks in pixels and its encoder's maps of the first
# window (relative L2): on the H100 the tracks read 4.7e-3 px sound and
# 1.4e-2 px with TF32 on (scripts/fault_control.py), too close for a limit
# between them, so the tracks' limit sits at 4x the sound reading and the
# encoder's maps, which TF32 moves by its 10-bit rounding, carry the check
# for TF32; OpenPose's maps relative to the largest deviation of the CPU's
# map from its mean (the heat maps sit near their -10 bias); UniMatch's
# flows relative to the largest |flow| of the CPU's
SP_COTRACKER_PX = 2e-2
SP_COTRACKER_FMAPS_TOL = 1e-4
SP_POSE_TOL = 1e-4
SP_UNIMATCH_TOL = 1e-3
# the human TAP's embedding against the CPU's on the same tracks and
# features, relative to its largest entry: fp32 sums of the same bilinear
# weights on both devices, in another order
SP_EMBED_TOL = 1e-4


def dift_levels(h8: int, w8: int) -> list:
    """(height, width, C) of the U-Net's four levels on an h8 x w8 latent
    (a stride-2 3x3 convolution with padding 1 between levels)."""
    out = []
    for c in (320, 640, 1280, 1280):
        out.append((h8, w8, c))
        h8, w8 = (h8 - 1) // 2 + 1, (w8 - 1) // 2 + 1
    return out


def dift_shape_kernels(report, gen, h8: int, w8: int) -> None:
    """The featurizer's kernels against their plain versions at its shapes
    (batch 1, the 8-draw ensemble on the frame axis, the ragged levels of an
    h8 x w8 latent), at the limits of TOL: GEGLU at every level, the fused
    temporal transformer at levels 0-1, temporal attention at 2-3, the
    flash forward self and cross (Sk = 77) at every level."""
    tag = ' (dift)'
    same = True
    for lvl, (h, w, c) in enumerate(dift_levels(h8, w8)):
        hw = h * w
        _geglu_case(report, gen, 8 * hw, c, tag)
        if lvl < 2:
            _fused_temporal(report, gen, h, w, c, 1, tag, f=8)
        else:
            same = _temporal_case(report, gen, hw, 8, c, tag) and same
        for sk in (hw, 77):
            _flash_case(report, gen, 8, 8, hw, sk, c // 8, tag)
    if not same:
        raise PhaseError('temporal_attention (dift shapes): two calls on '
                         'the same inputs differ')


def sp_known_tracks(frames: int, height: int, width: int) -> tuple:
    """The annotated points' names, keyframe positions (x, y) and their
    positions in every frame under atlas_clip's known motion: (names,
    (P, 2), (F, P, 2))."""
    import numpy as np
    names = list(SP_POINTS)
    cx = 0.3 * width + ATLAS_DISK_SHIFT[0] * SP_KEYFRAME
    cy = 0.55 * height + ATLAS_DISK_SHIFT[1] * SP_KEYFRAME
    key, motion = [], []
    for name in names:
        where, (a, b) = SP_POINTS[name]
        key.append((cx + a, cy + b) if where == 'disk' else (a, b))
        motion.append(ATLAS_DISK_SHIFT if where == 'disk'
                      else ATLAS_BG_SHIFT)
    key = np.asarray(key, np.float64)
    t = np.arange(frames)[:, None, None] - SP_KEYFRAME
    return names, key, key[None] + t * np.asarray(motion)[None]


def write_sp_clip(root: Path) -> dict:
    """The clip's PNG frames under root/frames and the annotation
    root/00008.json; three run directories whose `frames` link to the clip
    (dift, native_cotracker; human: its first SP_HUMAN_FRAMES frames), and
    the flow CLI's frames (the first SP_FLOW_FRAMES). Returns the paths and
    the known tracks."""
    import torch
    from videoswap_torch.utils.png import write_png
    frames, height, width = SP_CLIP
    data = atlas_clip(frames, height, width, 'cuda')
    u8 = (data['video'].clamp(0, 1) * 255).round().to(
        torch.uint8).cpu().numpy()
    clip = root / 'frames'
    clip.mkdir(parents=True)
    for i, f in enumerate(u8):
        write_png(str(clip / f'{i:05d}.png'), f)
    names, key, known = sp_known_tracks(frames, height, width)
    anno = {n: [float(y), float(x)] for n, (x, y) in zip(names, key)}
    anno = {'neck': [], **anno}
    (root / f'{SP_KEYFRAME:05d}.json').write_text(json.dumps(anno))
    dirs = {}
    for name, n in (('dift', frames), ('native_cotracker', frames),
                    ('human', SP_HUMAN_FRAMES), ('flow', SP_FLOW_FRAMES)):
        d = root / name / 'frames'
        d.mkdir(parents=True)
        for i in range(n):
            (d / f'{i:05d}.png').symlink_to(clip / f'{i:05d}.png')
        dirs[name] = d
    return {'clip': clip, 'annotation': root / f'{SP_KEYFRAME:05d}.json',
            'dirs': dirs, 'names': names, 'known': known,
            'video': u8}


def sp_model_opt(tree: Path, root: Path, dataset: dict) -> Path:
    """SP_CONFIG rewritten into `tree` (its models' and adapter's files) and
    `dataset` (datasets.path, datasets.tap_path), each cut on a '#' line."""
    values = {
        'models.unet.inference_config_path':
            ROOT / 'options/model_cfg/inference.yml',
        'models.unet.motion_module_path': tree / 'mm_sd_v14.ckpt',
        'models.adapter.model_config_path':
            ROOT / 'options/model_cfg/point_adapter.yml',
        'path.pretrained_model_path': tree / 'pretrained',
        'path.pretrained_adapter_path': tree / 'adapter.pth',
        **{f'datasets.{k}': v for k, v in dataset.items()}}
    text = rewrite_yaml((ROOT / SP_CONFIG).read_text(),
                        {k: str(v) for k, v in values.items()}, {})
    out = root / Path(SP_CONFIG).name
    out.write_text(''.join(f'# {c}\n' for c in SP_CUTS) + text)
    return out


def cpu_featurizer(feat):
    """The featurizer's models copied to the CPU in fp32 (the plain
    versions of every kernel)."""
    import torch
    from videoswap_torch.preprocess.dift import SDFeaturizer
    mods = {name: copy.deepcopy(getattr(feat, name)).to('cpu', torch.float32)
            for name in ('unet', 'vae', 'text_encoder')}
    return SDFeaturizer(tokenizer=feat.tokenizer, sched=feat.sched, **mods)


def sp_features(card, frames, ref) -> dict:
    """The card featurizer's map of frames[1], its second call (after
    frames[0]: a draw that went on from call to call would differ): its
    shape beside the up_block_1 tap's (the latent's level 1, 1280
    channels), and its relative L2 against `ref`, the CPU's map of
    frames[1] (inf if the shapes differ)."""
    card.forward(frames[0], 'photo of a object')
    out = card.forward(frames[1], 'photo of a object')
    h8, w8 = card.noise_shape(tuple(frames[1].shape[:2]))[2:4]
    return {'features_rel': (rel_err(out, ref)
                             if tuple(out.shape) == tuple(ref.shape)
                             else math.inf),
            'features_shape': list(out.shape),
            'features_tap_shape': [*dift_levels(h8, w8)[1][:2], 1280]}


class PatchFeaturizer:
    """tests/test_preprocess.py's stand-in featurizer: mean-centred 5x5
    patch descriptors of the grey frame, on the card."""

    def forward(self, image, prompt):
        import torch
        g = torch.as_tensor(image, device='cuda').float().mean(-1)
        h, w = g.shape
        pad = torch.nn.functional.pad(g[None, None], (2, 2, 2, 2),
                                      mode='replicate')[0, 0]
        feats = torch.stack([pad[dy:dy + h, dx:dx + w] for dy in range(5)
                             for dx in range(5)], dim=-1)
        return feats - feats.mean(-1, keepdim=True)


def sp_cotracker(ckpt, device, video, queries):
    """The predictor's tracks and visibility, and its encoder's maps of
    the first window (under the predictor's own precision context)."""
    import torch
    from videoswap_torch.preprocess import cotracker_native as cn
    pred = cn.NativeCoTrackerPredictor.from_checkpoint(ckpt, device)
    tracks, vis = pred(video, queries, backward_tracking=True)
    with torch.no_grad(), cn.fp32_math():
        x = cn.resize_ac(torch.from_numpy(video[:cn.WINDOW]).to(device),
                         *cn.INTERP_SHAPE)
        fmaps = pred.model.encode(2 * (x / 255.0) - 1.0).cpu()
    return tracks, vis, fmaps


def sp_pose(ckpt, device, frame):
    """The detector's maps and its people's keypoint lists on one frame."""
    from videoswap_torch.preprocess.pose import NativePoseDetector
    det = NativePoseDetector.from_checkpoint(ckpt, device)
    paf, heat = det._maps(frame)
    people = [[None if k is None else (k.x, k.y) for k in p.body.keypoints]
              for p in det.detect_poses(frame)]
    return paf, heat, people


def sp_unimatch(ckpt, device, f0, f1):
    from videoswap_torch.preprocess.unimatch import UniMatchWrapper
    return UniMatchWrapper.from_checkpoint(ckpt, device).compute_flow(f0, f1)


def sp_map_error(out, ref) -> float:
    import numpy as np
    return float(np.abs(out - ref).max() / np.abs(ref - ref.mean()).max())


def sp_card_checks(inputs: dict, refs: dict) -> dict:
    """The card's side of the phase's checks, against the CPU's `refs`
    (sp_cpu_refs) and on its own: the featurizer's second call, CoTracker's
    tracks (the frames before each query filled by the backward run),
    OpenPose's maps and people, UniMatch's flow. scripts/fault_control.py
    runs it under each planted fault."""
    import numpy as np
    out = sp_features(inputs['featurizer'], inputs['frames'],
                      refs['features'])
    tr, vis, fmaps = sp_cotracker(inputs['cot'], 'cuda',
                                  inputs['sub_video'], inputs['queries'])
    out['cotracker_unfilled'] = int(sum(
        (tr[0, :int(t), n] == 0).all(-1).sum()
        for n, t in enumerate(inputs['queries'][0, :, 0])))
    out['cotracker_px'] = float(np.abs(tr - refs['cotracker'][0]).max())
    out['cotracker_vis'] = float(np.abs(vis - refs['cotracker'][1]).max())
    out['cotracker_fmaps_rel'] = rel_err(fmaps, refs['cotracker'][2])
    paf, heat, people = sp_pose(inputs['pose'], 'cuda', inputs['frame'])
    out['pose_paf'] = sp_map_error(paf, refs['pose'][0])
    out['pose_heat'] = sp_map_error(heat, refs['pose'][1])
    out['pose_people_equal'] = people == refs['pose'][2]
    out['pose_people'] = len(people)
    flow = sp_unimatch(inputs['unimatch'], 'cuda', *inputs['pair'])
    out['unimatch_rel'] = float(np.abs(flow - refs['unimatch']).max()
                                / np.abs(refs['unimatch']).max())
    return out


def sp_cpu_refs(inputs: dict) -> dict:
    """The CPU's side (fp32): the featurizer's map of frames[1], CoTracker,
    OpenPose and UniMatch on the same inputs; and their seconds."""
    t = {}
    refs = {}
    t0 = time.perf_counter()
    cpu = cpu_featurizer(inputs['featurizer'])
    refs['features'] = cpu.forward(inputs['frames'][1], 'photo of a object')
    del cpu
    t['features'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs['cotracker'] = sp_cotracker(inputs['cot'], 'cpu',
                                     inputs['sub_video'], inputs['queries'])
    t['cotracker'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs['pose'] = sp_pose(inputs['pose'], 'cpu', inputs['frame'])
    t['pose'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    refs['unimatch'] = sp_unimatch(inputs['unimatch'], 'cpu',
                                   *inputs['pair'])
    t['unimatch'] = time.perf_counter() - t0
    refs['seconds'] = t
    return refs


def sp_card_fails(c: dict) -> list:
    fails = []
    if c['features_shape'] != c['features_tap_shape']:
        fails.append('features shape')
    if not c['features_rel'] <= MODEL_REL_TOL:
        fails.append('features card vs CPU')
    if c['cotracker_unfilled']:
        fails.append('cotracker backward run')
    if not (c['cotracker_px'] <= SP_COTRACKER_PX
            and c['cotracker_fmaps_rel'] <= SP_COTRACKER_FMAPS_TOL):
        fails.append('cotracker card vs CPU')
    if not c['pose_people']:
        fails.append('pose finds people')
    if not (max(c['pose_paf'], c['pose_heat']) <= SP_POSE_TOL
            and c['pose_people_equal']):
        fails.append('pose card vs CPU')
    if not c['unimatch_rel'] <= SP_UNIMATCH_TOL:
        fails.append('unimatch card vs CPU')
    return fails


def _env(**values):
    """Set environment variables (None: unset); returns a function that
    restores them."""
    old = {k: os.environ.get(k) for k in values}
    for k, v in values.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v

    def restore():
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return restore


def semantic_points_run(tree: Path, root: Path, pipe) -> dict:
    """The phase's path and checks in `root` (the trees' models from
    `tree`); `pipe`'s adapter takes the TAP's embeddings once. Returns the
    readings."""
    import numpy as np
    import torch
    from videoswap_torch import extract_flow
    from videoswap_torch import extract_semantic_point as esp
    from videoswap_torch.data.frame_point_dataset import \
        SingleVideoPointDataset
    from videoswap_torch.preprocess.tracker import DIFTTracker
    from videoswap_torch.utils.config import load_config
    r = {'seconds': {}}
    sec = r['seconds']
    t0 = time.perf_counter()
    clip = write_sp_clip(root)
    ck = {'cot': root / 'cotracker_stride_4_wind_8.pth',
          'pose': root / 'body_pose_model.pth',
          'unimatch': root / 'gmflow-scale2-regrefine6-mixdata.pth'}
    torch.save(synthetic_cotracker_state(), ck['cot'])
    torch.save(calibrated_openpose_state(clip['video'][0], 'cuda'),
               ck['pose'])
    torch.save(synthetic_unimatch_state(), ck['unimatch'])
    yml = sp_model_opt(tree, root, {'path': clip['dirs']['dift'],
                                    'tap_path': root / 'dift' / 'TAP.pth'})
    sec['write clip and checkpoints'] = time.perf_counter() - t0

    cwd = os.getcwd()
    restore = _env(VS_COTRACKER_CKPT=None, VS_UNIMATCH_CKPT=None,
                   VS_OPENPOSE_CKPT=None)
    os.chdir(root)               # no pretrained_models/ for the lookups
    runs = {}
    try:
        reset_launches()
        for name in ('dift', 'native_cotracker', 'human'):
            os.environ['VS_COTRACKER_CKPT'] = (
                str(ck['cot']) if name == 'native_cotracker' else '')
            argv = ['--frame_dir', str(clip['dirs'][name]),
                    '--keyframe_annotation', str(clip['annotation']),
                    '--subject_category', 'object', '--model_opt', str(yml)]
            if name == 'human':
                argv += ['--is_human', 'true', '--pose_ckpt', str(ck['pose'])]
            t0 = time.perf_counter()
            runs[name] = esp.main(argv)
            sec[f'cli {name}'] = time.perf_counter() - t0
        r['launches'] = read_launches()
        os.environ['VS_UNIMATCH_CKPT'] = str(ck['unimatch'])
        t0 = time.perf_counter()
        written = extract_flow.cli([
            '--frame_dir', str(clip['dirs']['flow']), '--out_dir',
            str(root / 'flow' / 'flows'), '--method', 'unimatch'])
        sec['extract_flow unimatch (2 pairs)'] = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
        restore()
    r['sources'] = {k: v['source'] for k, v in runs.items()}
    r['cli_seconds'] = {k: v['seconds'] for k, v in runs.items()}
    r['peak_gib'] = max(v['peak_gib'] for v in runs.values())
    flows = [np.load(p) for p in written]
    r['flows'] = {'files': len(written), 'shape': list(flows[0].shape),
                  'finite': bool(all(np.isfinite(f).all() for f in flows))}

    # the TAP files: the reference's keys, as the 2003 config's dataset
    # reads them, the embeddings once through the adapter
    taps = {}
    for name, run in runs.items():
        tap = torch.load(run['path'], weights_only=False)
        taps[name] = {'keys': sorted(tap),
                      'tracks': list(tap['pred_tracks'].shape),
                      'embedding': list(tap['point_embedding'].shape),
                      'finite': bool(torch.isfinite(
                          tap['point_embedding']).all()),
                      'visible_share': float(
                          (tap['pred_tracks'] >= 0).all(-1).float().mean())}
    r['taps'] = taps
    opt = load_config(str(yml))
    ds = SingleVideoPointDataset(opt['datasets'])
    cond = ds.get_conditions()
    states = pipe._adapter_states(cond, tuple(ds.get_frames().shape[-3:-1]),
                                  1.0, False)
    r['dataset'] = {'frames': list(ds.get_frames().shape),
                    'tracks': list(np.asarray(cond['pred_tracks']).shape),
                    'embedding': list(np.asarray(
                        cond['point_embedding']).shape),
                    'adapter_states': [list(s.shape) for s in states],
                    'adapter_finite': bool(all(torch.isfinite(s).all()
                                               for s in states))}

    # the DIFT tracker on the card against the CPU, fed the same features
    # (the CLI's, on the CPU), on SP_SUB
    a, b = SP_SUB
    video = clip['video']
    frames = [f.astype(np.float32) / 127.5 - 1.0 for f in video]
    ch, cw = SP_CROP
    y0, x0 = (SP_CLIP[1] - ch) // 2, (SP_CLIP[2] - cw) // 2
    crop = [f[y0:y0 + ch, x0:x0 + cw] for f in video[:2]]
    feats = [f.cpu() for f in runs['dift']['features'][a:b]]
    _, key, known = sp_known_tracks(*SP_CLIP)
    tracks = {}
    for dev in ('cuda', 'cpu'):
        t0 = time.perf_counter()
        tracks[dev] = DIFTTracker(None, device=dev).track(
            frames[a:b], SP_KEYFRAME - a, key, 'object', feats=feats)
        sec[f'dift tracker {dev} (sub-clip)'] = time.perf_counter() - t0
    r['tracker_px'] = float(np.abs(tracks['cuda'] - tracks['cpu']).max())
    # the stand-in featurizer's tracks on the card against the known motion
    t0 = time.perf_counter()
    stand = DIFTTracker(PatchFeaturizer(), device='cuda').track(
        frames, SP_KEYFRAME, key, 'object')
    sec['stand-in tracker card'] = time.perf_counter() - t0
    r['standin_px'] = float(np.abs(stand - known).max())
    r['standin_median_px'] = float(np.median(np.abs(stand - known)))

    feat = runs['dift']['featurizer']
    r['latent'] = list(feat.noise_shape(SP_CLIP[1:])[2:4])

    # CoTracker, OpenPose, UniMatch and the featurizer, card against CPU
    q = np.asarray([[SP_KEYFRAME - a, x, y] for x, y in key],
                   np.float32)[None]
    inputs = {'featurizer': feat,
              'frames': [f.astype(np.float32) / 127.5 - 1.0 for f in crop],
              'cot': str(ck['cot']),
              'sub_video': video[a:b].astype(np.float32),
              'queries': q, 'pose': str(ck['pose']), 'frame': video[0],
              'unimatch': str(ck['unimatch']),
              'pair': tuple(f.astype(np.float32) / 255.0 for f in crop)}
    t0 = time.perf_counter()
    refs = sp_cpu_refs(inputs)
    sec['cpu references'] = time.perf_counter() - t0
    t0 = time.perf_counter()
    r['card'] = sp_card_checks(inputs, refs)
    sec['card checks'] = time.perf_counter() - t0
    r['cpu_seconds'] = refs['seconds']
    r['inputs'], r['refs'] = inputs, refs

    # the human TAP against the CPU: frame 0's keypoints the CPU detector's
    # first person's (as propagate_human_keypoint writes them), the
    # embedding the CPU's on the TAP's tracks and the CLI's features
    t0 = time.perf_counter()
    tap = torch.load(runs['human']['path'], weights_only=False)
    tracks = tap['pred_tracks'].numpy()
    h, w = SP_CLIP[1:]
    first = np.full((18, 2), -1.0, np.float32)
    for ki, kp in enumerate(refs['pose'][2][0] if refs['pose'][2] else []):
        if kp is not None:
            first[ki] = (kp[0] * w, kp[1] * h)
    emb = esp.extract_point_embedding(
        {'pred_tracks': tracks.copy()}, str(clip['dirs']['human']), None,
        True, [f.cpu() for f in runs['human']['features']])
    ref = emb['point_embedding']
    r['human'] = {
        'frame0_keypoints': int((first >= 0).all(-1).sum()),
        'frame0_equal': bool(np.array_equal(tracks[0], first)),
        'embedding_rel': float(
            np.abs(tap['point_embedding'].numpy() - ref).max()
            / max(float(np.abs(ref).max()), 1e-30))}
    sec['human TAP on the CPU'] = time.perf_counter() - t0
    return r


def semantic_points_fails(r) -> list:
    fails = [f'source {k}' for k, v in r['sources'].items()
             if v != {'dift': 'dift', 'native_cotracker': 'native_cotracker',
                      'human': 'NativePoseDetector'}[k]]
    fails += [f'launches {k}' for k in FORWARD_KERNELS
              if r['launches'][k] <= 0]
    want = ['point_embedding', 'point_name2id', 'pred_tracks']
    for name, t in r['taps'].items():
        p = 18 if name == 'human' else len(SP_POINTS)
        f = SP_HUMAN_FRAMES if name == 'human' else SP_CLIP[0]
        if t['keys'] != want or t['tracks'] != [f, p, 2] \
                or t['embedding'] != [p, 1280] or not t['finite'] \
                or not t['visible_share'] > 0:
            fails.append(f'tap {name}')
    hu = r['human']
    if not (hu['frame0_keypoints'] and hu['frame0_equal']
            and hu['embedding_rel'] <= SP_EMBED_TOL):
        fails.append('human TAP vs CPU')
    d = r['dataset']
    if d['embedding'] != [len(SP_POINTS), 1280] or not d['adapter_finite']:
        fails.append('dataset')
    if r['flows'] != {'files': SP_FLOW_FRAMES - 1,
                      'shape': [2, SP_CLIP[1], SP_CLIP[2], 2],
                      'finite': True}:
        fails.append('flow files')
    if not r['tracker_px'] <= SP_TRACK_PX:
        fails.append('tracker card vs CPU')
    if not r['standin_px'] <= SP_STANDIN_PX:
        fails.append('stand-in vs known motion')
    return fails + sp_card_fails(r['card'])


def phase_semantic_points(report, state):
    import tempfile

    import torch
    tree, _ = recipe_tree(state)
    with tempfile.TemporaryDirectory() as d:
        r = semantic_points_run(tree, Path(d), state['pipe'])
    # the featurizer's kernels at its shapes, at the kernels phase's limits
    t0 = time.perf_counter()
    dift_shape_kernels(report, torch.Generator(device='cuda').manual_seed(
        SEED), *r['latent'])
    r['seconds']['kernels at the dift shapes'] = time.perf_counter() - t0
    report['launches']['semantic_points'] = r['launches']
    r.pop('inputs')
    r.pop('refs')
    report['semantic_points'] = r
    torch.cuda.empty_cache()
    fails = semantic_points_fails(r)
    log(f'# semantic_points ({SP_CONFIG}; {"; ".join(SP_CUTS)}): stage s '
        f'{json.dumps({k: round(v, 3) for k, v in r["seconds"].items()})}; '
        f'CLI stages s {json.dumps(r["cli_seconds"])}; peak '
        f'{r["peak_gib"]:.2f} GiB (a CLI run); latent {r["latent"]}; '
        f'sources {json.dumps(r["sources"])}; launches '
        f'{json.dumps(r["launches"])}')
    log(f'# semantic_points checks: TAP files {json.dumps(r["taps"])}; '
        f'dataset {json.dumps(r["dataset"])}; flows {json.dumps(r["flows"])}'
        f'; human TAP vs CPU {json.dumps(r["human"])} (embedding tol '
        f'{SP_EMBED_TOL}); tracker card vs CPU {r["tracker_px"]:.3e} px (tol '
        f'{SP_TRACK_PX}); stand-in vs known motion max {r["standin_px"]:.3f}'
        f' median {r["standin_median_px"]:.3f} px (tol {SP_STANDIN_PX}); '
        f'card vs CPU {json.dumps(r["card"])} (tols features '
        f'{MODEL_REL_TOL}, cotracker {SP_COTRACKER_PX} px and maps '
        f'{SP_COTRACKER_FMAPS_TOL}, pose '
        f'{SP_POSE_TOL}, unimatch {SP_UNIMATCH_TOL}); CPU s '
        f'{json.dumps(r["cpu_seconds"])} '
        f'{"FAIL " + str(fails) if fails else "ok"}')
    if fails:
        raise PhaseError(f'semantic_points: {fails}')


def env_line() -> str:
    """The optional packages the port's writers and readers import where
    they are used (PIL: gif and non-PNG frames; imageio: mp4), and those it
    does without (yaml, transformers, regex): present with their version,
    or missing."""
    import importlib.metadata
    import importlib.util
    out = []
    for module, dist in (('PIL', 'pillow'), ('imageio', 'imageio'),
                         ('yaml', 'pyyaml'), ('transformers', 'transformers'),
                         ('regex', 'regex')):
        if importlib.util.find_spec(module) is None:
            out.append(f'{module} missing')
            continue
        try:
            out.append(f'{module} {importlib.metadata.version(dist)}')
        except importlib.metadata.PackageNotFoundError:
            out.append(f'{module} present')
    return ', '.join(out)


def card() -> str:
    out = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--phases', default=','.join(PHASES))
    args = ap.parse_args()
    phases = [p for p in args.phases.split(',') if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        die(f'unknown phases {sorted(unknown)}')

    if not (ROOT / 'videoswap_torch' / '__init__.py').exists():
        die('videoswap_torch/ not found next to chip_smoke.py: run it from a '
            'checkout of the repository')
    import torch
    if not torch.cuda.is_available():
        die('no CUDA device: this script runs only on a GPU')
    sys.path.insert(0, str(ROOT))
    full_fp32()
    power = card()
    kind = torch.cuda.get_device_name(0)
    log(f'# device: {kind}; torch {torch.__version__} CUDA '
        f'{torch.version.cuda}; nvidia-smi: {power}')
    log(f'# env: {env_line()}')

    report = {'kernels': {}, 'launches': {}}
    state = {}
    t_start = time.perf_counter()
    try:
        for phase in phases:
            t0 = time.perf_counter()
            if phase == 'build':
                phase_build(report)
            elif phase == 'kernels':
                phase_kernels(report)
            elif phase in ('atlas_small', 'atlas', 'atlas_recipe'):
                # the atlas runs alone on the card
                state.clear()
                torch.cuda.empty_cache()
                {'atlas_small': phase_atlas_small, 'atlas': phase_atlas,
                 'atlas_recipe': phase_atlas_recipe}[phase](report, state)
            else:
                if 'pipe' not in state:
                    state['pipe'] = build_pipeline('cuda', torch.bfloat16)
                if phase in ('unet', 'small', 'dpm_small', 'train_small',
                             'blend_small', 'clip_attn') \
                        and 'cpu' not in state:
                    state['cpu'] = cpu_copy(state['pipe'])
                {'unrouted': phase_unrouted, 'unet': phase_unet,
                 'small': phase_small, 'dpm_small': phase_dpm_small,
                 'sample': phase_sample, 'train_small': phase_train_small,
                 'train': phase_train, 'edlora_small': phase_edlora_small,
                 'edlora': phase_edlora, 'blend_small': phase_blend_small,
                 'blend': phase_blend, 'recipe': phase_recipe,
                 'clip_attn': phase_clip_attn,
                 'train_recipe': phase_train_recipe,
                 'semantic_points': phase_semantic_points}[phase](
                    report, state)
            log(f'# phase {phase}: {time.perf_counter() - t0:.1f} s')
    except PhaseError as e:
        die(str(e))
    log(f'# total {time.perf_counter() - t_start:.1f} s')

    paths = report['launches']
    kernels = []
    for name, (_, _, source, replaces) in KERNELS.items():
        k = report['kernels'].get(name, {})
        kernels.append({
            'name': name, 'route': 'cuda', 'source': source,
            'replaces': replaces,
            'launches': paths.get(KERNEL_PATH.get(name, 'train'), {}).get(
                name, 0),
            'launches_by_path': {p: c.get(name, 0) for p, c in paths.items()},
            **{key: k.get(key) for key in (
                'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                'library_ms', 'shape')},
            **{key: k[key] for key in ('max_err_over_max_plain',
                                       'max_bf16_ulps', 'step_ms',
                                       'step_bound_ms', 'step_library_ms',
                                       'step_one_level_calls_ms',
                                       'step_launches', 'library_is',
                                       'flash_ms', 'chain_ms', 'wrapper_ms',
                                       'bitwise_repeatable', 'shapes')
               if key in k}})
    log(json.dumps({'kernels': kernels}))
    log(power)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
