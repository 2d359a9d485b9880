#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videoswap_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,kernels,unrouted,unet,small,sample,train_small,train,blend_small,blend,atlas_small,atlas]

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
               autograd Function's gradients;
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
- atlas_small: the atlas_swan nets at full width (2^19 hash table) on an
               8-frame 128x96 synthetic clip, batch 10000: one main step and
               one inverse step on the same params and draws, GPU against
               CPU, both fp32: each loss term, each net's gradient (the hash
               table's apart) and each net's change under Adam's first step;
- atlas:       the third slice's path, layered-neural-atlas training at
               the published size: a synthetic 72-frame 768x448 clip built
               on the card, UV pretraining of both mappings, ATLAS_STEPS
               iterations of main step + inverse step at batch 10000 (the
               losses must be finite and fall, the hash kernel must launch
               once a main step: all 16 levels in one launch), the
               reconstruction PSNR of 4 frames
               and one propagated point drag.

Launch counts are set to 0 just before the unrouted, sample, train, blend
and atlas paths and read just after each. scripts/fault_control.py shows
that the unet, small, train_small, blend_small, atlas_small and unrouted
limits fail a kernel with a planted fault;
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
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ('build', 'kernels', 'unrouted', 'unet', 'small', 'sample',
          'train_small', 'train', 'blend_small', 'blend', 'atlas_small',
          'atlas')
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
# dataset prompt and val block (the card's machine has no YAML reader): the
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

# options/train_atlas/atlas_swan.yml, its `models` and `train` blocks (the
# card's machine has no YAML reader) and its clip size (`datasets`: res_x,
# res_y, max_frames)
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


def phase_kernels(report):
    import torch
    import torch.nn.functional as F
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import geglu_ffn as gf
    from videoswap_torch.ops import temporal_attention as ta
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    f32 = (lambda ts: [t.float() for t in ts])

    # GEGLU FFN: rows = CFG batch 2 x 16 frames x H*W, per U-Net level; the
    # fused kernel at C <= 640, above it the split route (two cuBLAS
    # products around the gate pass, which is checked and timed alone too).
    # No single PyTorch call computes the FFN: the two cuBLAS products
    # alone on inputs of the same shapes stand in the library column
    for n, c in ((131072, 320), (32768, 640), (8192, 1280), (2048, 1280)):
        args = [_rand(gen, (n, c)), _rand(gen, (8 * c, c), c ** -0.5),
                _rand(gen, (8 * c,), 0.1), _rand(gen, (c, 4 * c),
                                                 (4 * c) ** -0.5),
                _rand(gen, (c,), 0.1)]
        g_in = _rand(gen, (n, 4 * c))
        route = 'fused' if gf.takes_fused_route(c) else 'split'
        _compare('geglu_ffn', f'N={n} C={c} ({route})',
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
            log(f'# kernel geglu_ffn N={n} C={c}: the split route here '
                f'{ms:.4f} ms')
        if route == 'split':
            h = F.linear(args[0], args[1], args[2])
            # ~31 fp32 operations an output (gelu_fast's Horner erf)
            _compare('geglu_gate', f'N={n} 8C={8 * c}',
                     lambda: gf.geglu_gate(h),
                     lambda: gf.geglu_gate_plain(h),
                     lambda: gf.geglu_gate_plain(h.float()), report,
                     (31 * 4 * n * c, 2 * 12 * n * c, PEAK_FP32_FLOPS),
                     ulps=True)
            del h
        del args, g_in
    report['kernels']['geglu_ffn']['library_is'] = (
        'the two cuBLAS products alone (F.linear(x, w1, b1), '
        'F.linear(g, w2, b2))')

    # temporal attention: L locations x F=16 frames, 8 heads, at the U-Net
    # levels' shapes (the swap launches it at C = 1280: 2 x 16 x 16 and
    # 2 x 8 x 8 locations), then at tiling edges: location counts that are
    # not a multiple of a work item's (ta.plan's lg, which the log line
    # prints), F around the 16-row tiles. Two calls on the same inputs must
    # give the same bits. The kernel and SDPA are timed on the device alone
    # (queued ahead): at the small shapes a call launched after another is
    # paced by the host
    same = True
    for el, f, c in ((8192, FRAMES, 320), (2048, FRAMES, 640),
                     (512, FRAMES, 1280), (128, FRAMES, 1280),
                     (333, 1, 1280), (101, 7, 640), (77, 17, 320),
                     (45, 32, 1280)):
        q, k, v = (_rand(gen, (el * f, c)) for _ in range(3))
        view = (lambda t: t.view(el, f, 8, c // 8))
        hc, lg = ta.plan(f, c, 8)
        _compare('temporal_attention', f'L={el} F={f} C={c}',
                 lambda: ta.temporal_attention(q, k, v, 8, f),
                 lambda: ta.temporal_attention_plain(q, k, v, 8, f),
                 lambda: ta.temporal_attention_plain(*f32((q, k, v)), 8, f),
                 report, (4 * el * f * f * c, 2 * 4 * el * f * c),
                 lambda: cuda_time_ms(
                     lambda: _sdpa(view(q), view(k), view(v)), 10,
                     ahead=True),
                 ahead=True)
        twice = [ta.temporal_attention(q, k, v, 8, f) for _ in range(2)]
        same = same and torch.equal(*twice)
        log(f'# kernel temporal_attention L={el} F={f} C={c}: items of '
            f'{lg} locations x {hc} heads, two calls bitwise equal '
            f'{torch.equal(*twice)}')
    report['kernels']['temporal_attention']['bitwise_repeatable'] = same
    if not same:
        raise PhaseError('temporal_attention: two calls on the same inputs '
                         'differ')

    # fused temporal transformer: the CFG batch of 2 x 16 frames at level 0
    # (C = 320, with the FFN) and level 1 (C = 640, the attention half)
    for side, c in ((64, 320), (32, 640)):
        _fused_temporal(report, gen, side, c)

    # flash forward: B = 2 CFG x 16 frames, 8 heads; self and cross (Sk=77)
    b, h = 2 * FRAMES, 8
    for s, d in ((4096, 40), (1024, 80), (256, 160), (64, 160)):
        for sk in (s, 77):
            q = _rand(gen, (b, s, h, d))
            k, v = (_rand(gen, (b, sk, h, d)) for _ in range(2))
            chunk = max(1, (1 << 28) // (h * s * sk))   # <= 1 GiB of logits
            _compare('flash_attention_fwd', f'B={b} H={h} Sq={s} Sk={sk} '
                     f'd={d}',
                     lambda: fa.flash_attention_fwd(q, k, v)[0],
                     lambda: fa.flash_attention_plain(q, k, v, chunk)[0],
                     lambda: fa.flash_attention_plain(
                         *f32((q, k, v)), max(1, chunk // 2))[0], report,
                     (4 * b * h * s * sk * d,
                      2 * (2 * b * s * h * d + 2 * b * sk * h * d)
                      + 4 * b * h * s),
                     lambda: cuda_time_ms(lambda: _sdpa(q, k, v), 5),
                     iters=5, exps=b * h * s * sk)
            # the logsumexp the backward needs
            _, lse = fa.flash_attention_fwd(q[:1], k[:1], v[:1])
            _, lse_ref = fa.flash_attention_plain(*f32((q[:1], k[:1],
                                                        v[:1])))
            lerr = float((lse - lse_ref).abs().max())
            if lerr > 1e-2:
                raise PhaseError(f'flash lse max_abs_err {lerr:.3e}')

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


def _fused_inputs(gen, b, hw, c, include_ffn):
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
    g, x = (_rand(gen, (b, FRAMES, hw, c)) for _ in range(2))
    pe = mod.transformer_blocks[0].pe[:FRAMES].to(torch.bfloat16)
    return g, x, pe, ft.flat_params(mod, include_ffn), mod


def _fused_temporal(report, gen, side, c):
    """The fused kernel against its plain version in both layouts at one
    U-Net level (C <= 320 with the FFN, else the attention half), timed
    beside the layer-wise module it replaces (no single PyTorch call
    computes this function: the layer-wise time stands in the library
    column, marked so). At C = 640 the layer-wise time is of the attention
    half, and the fused route's time with `ffn_tail` is printed beside the
    whole layer-wise module's."""
    import torch
    from videoswap_torch.ops import fused_temporal as ft
    b, f, heads = 2, FRAMES, 8
    hw = side * side
    inc = c <= 320
    g4, x4, pe, flat, mod = _fused_inputs(gen, b, hw, c, inc)
    g2, x2 = ft.rows_of(g4).contiguous(), ft.rows_of(x4).contiguous()
    rows = b * hw * f
    n_mat = 22 if inc else 9             # C x C matrices
    flops = rows * ((44 if inc else 18) * c * c + 8 * f * c)
    nbytes = (2 * rows * c * (3 if inc else 2) + 2 * n_mat * c * c
              + 4 * c * (14 if inc else 8))
    x5, g5 = (t.reshape(b, f, side, side, c) for t in (x4, g4))
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
            log(f'# fused_temporal C={c}: kernel + ffn_tail {route:.3f} ms, '
                f'the whole layer-wise module {full:.3f} ms')
    # a model of the kernel's L2 traffic, not a measurement: each block
    # (64-row sets of 64 // F whole locations, two a block at C <= 320)
    # reads all the weights it uses
    per_block = 2 if c <= 320 else 1
    sets = -(-b * hw // (64 // f))       # over the B x HW locations
    blocks = -(-sets // per_block)
    l2_gb = blocks * 2 * n_mat * c * c / 1e9
    log(f'# fused_temporal C={c}: model: {blocks} blocks of '
        f'{64 * per_block} rows would read {l2_gb:.2f} GB of weights from L2')
    with torch.no_grad():
        one = ft.fused_temporal_transformer(g2, x2, pe, flat, heads, f,
                                            include_ffn=inc)
        two = ft.fused_temporal_transformer(g2, x2, pe, flat, heads, f,
                                            include_ffn=inc)
        fm = ft.fused_temporal_transformer_bfhw(g4, x4, pe, flat, heads, f,
                                                include_ffn=inc)
    same = torch.equal(one, two) and torch.equal(ft.unrows(one, b, f, hw),
                                                 fm)
    log(f'# fused_temporal C={c}: two calls and the two layouts give the '
        f'same bits: {same}')
    if not same:
        raise PhaseError(f'fused_temporal C={c}: calls or layouts differ')
    del one, two, fm
    f32 = [p.float() for p in flat]
    desc = f'rows={rows} F={f} C={c}' + ('' if inc else ' attention half')
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
    _compare('fused_temporal_bfhw', f'B={b} F={f} HW={hw} C={c}',
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
    built = build_models(device=device, dtype=dtype, seed=SEED)
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


def small_sample(pipe):
    """The small phase's `sample`: 256x256, 2 frames, 2 DDIM steps, CFG and
    adapter; initial latents from SEED + 2 rounded to bf16."""
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
            height=size, width=size, num_inference_steps=2,
            guidance_scale=7.5, negative_prompt='low quality',
            conditions=conditions(frames, size), t2i_guidance_scale=0.5,
            t2i_end=0.5, output_type='latent')


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


def edlora_file(pipe, path, seed=SEED):
    """A synthetic ED-LoRA checkpoint for the pipeline's models: the two
    concepts' 16 layer embeddings, and a rank-LORA_RANK LoRA (down ~
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
        for c in BLEND_CONCEPTS},
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
    pre_iters = ATLAS_TRAIN['pretrain_UV_mapping_iter']
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
            elif phase in ('atlas_small', 'atlas'):
                # the atlas runs alone on the card
                state.clear()
                torch.cuda.empty_cache()
                {'atlas_small': phase_atlas_small,
                 'atlas': phase_atlas}[phase](report, state)
            else:
                if 'pipe' not in state:
                    state['pipe'] = build_pipeline('cuda', torch.bfloat16)
                if phase in ('unet', 'small', 'train_small', 'blend_small') \
                        and 'cpu' not in state:
                    state['cpu'] = cpu_copy(state['pipe'])
                {'unrouted': phase_unrouted, 'unet': phase_unet,
                 'small': phase_small,
                 'sample': phase_sample, 'train_small': phase_train_small,
                 'train': phase_train, 'blend_small': phase_blend_small,
                 'blend': phase_blend}[phase](report, state)
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
