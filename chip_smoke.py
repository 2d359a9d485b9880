#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videoswap_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,kernels,unet,small,sample,train_small,train]

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
               only, never on the port's path); one gradient check each of
               the GEGLU and temporal-attention autograd Functions;
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
               launches the forward kernels again, and is counted).

Launch counts are set to 0 just before the sample and train paths and read
just after each. scripts/fault_control.py shows that the unet, small and
train_small limits fail a kernel with a planted fault; scripts/profile_step.py
breaks one full-width U-Net step down by device time.

Weights are random, drawn from a seeded torch.Generator. The script fails
(exit code 1, no result line) without a CUDA device, outside a checkout of
the repository, or when any phase fails. Its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ('build', 'kernels', 'unet', 'small', 'sample', 'train_small',
          'train')
SEED = 0
FRAMES, SIZE, POINTS = 16, 512, 10
STEPS = 4          # DDIM steps of the full-width sample (a smoke run's time)
TRAIN_STEPS = 3    # AdamW steps of the full-width training run
# the slice's tuning (scripts/bench_train.py of the JAX package)
TRAIN_TUNE = {'drop_rate': 0.2, 'min_timestep': 0.5, 'loss_type': 'global'}
TRAIN_LR = 1e-5

# kernel -> (module, launch counter, source, TPU kernel it replaces)
KERNELS = {
    'geglu_ffn': ('geglu_ffn', 'launches', 'videoswap_torch/csrc/geglu_ffn.cu',
                  'videoswap_tpu/ops/geglu_ffn.py:110'),
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
}
FORWARD_KERNELS = ('geglu_ffn', 'temporal_attention', 'flash_attention_fwd')
# max |kernel - plain| allowed, bf16 kernel vs fp32 plain on the same bf16
# inputs: outputs are O(1) and rounded once to bf16 (2^-8 relative), plus
# the bf16 rounding of the intermediate (gated product, probabilities). The
# backward's gradients are far from O(1) (dq ~ 1e-2 at S = 4096), so their
# error is taken relative to the largest |plain| entry: bf16 rounding of
# P, dS and the output, summed over many keys or queries
TOL = {'geglu_ffn': 3e-2, 'temporal_attention': 1e-2,
       'flash_attention_fwd': 1e-2, 'flash_attention_bwd_dq': 1e-2,
       'flash_attention_bwd_dkv': 1e-2}
# the autograd Functions' gradients on the card (kernel forward, plain
# backward in bf16) against autograd through the fp32 plain version,
# relative to the largest entry
GRAD_TOL = 2e-2
# relative L2 error allowed for whole-model comparisons (GPU bf16 vs CPU
# fp32): bf16 activations through ~100 layers with random weights
MODEL_REL_TOL = 5e-2
# the same for sampled latents: guidance 7.5 multiplies the U-Net's bf16
# error in (eps_cond - eps_uncond) by up to 7.5 at every step
SAMPLE_REL_TOL = 5e-2
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
# NVIDIA H100 SXM published dense peaks: bf16 tensor-core FLOP/s and HBM3
# bytes/s (at the full 700 W power limit)
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


def die(msg: str) -> None:
    print(f'chip_smoke: FAIL: {msg}', file=sys.stderr, flush=True)
    sys.exit(1)


def cuda_time_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
        if re.search(r'Compiling entry|registers|spill', line):
            log(f'# ptxas: {line.strip()}')
    report['build_s'] = seconds


# ---------------------------------------------------------------- kernels
def _rand(gen, shape, scale=1.0):
    import torch
    return (torch.randn(shape, generator=gen, device='cuda') * scale).to(
        torch.bfloat16)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes (each input read once, each output
    written once) over the memory rate; and which of the two it is."""
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def _record(report, name, shape_desc, err, ms, plain_ms, work, library):
    """Print the shape's bound and library time; keep the largest error
    over shapes, and the times, bound and library time of the first
    (level-0, largest) shape."""
    b_ms, b_by = bound_ms(*work)
    lib_ms = library() if library else None
    log(f'# kernel {name} {shape_desc}: bound {b_ms:.3f} ms ({b_by}), '
        'library call ' + (f'{lib_ms:.3f} ms' if library else 'none'))
    entry = report['kernels'].setdefault(name, {'max_abs_err': 0.0,
                                                'ms': None})
    entry['max_abs_err'] = max(entry['max_abs_err'], err)
    if entry['ms'] is None:
        entry.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                     library_ms=lib_ms, shape=shape_desc)


def _compare(name, shape_desc, kernel, plain_bf16, plain_fp32, report,
             work, library=None, iters=10):
    import torch
    out = kernel()
    torch.cuda.synchronize()
    ref = plain_fp32()
    err = float((out.float() - ref.float()).abs().max())
    ms = cuda_time_ms(kernel, iters)
    plain_ms = cuda_time_ms(plain_bf16, max(2, iters // 3), warmup=1)
    ok = err <= TOL[name] and bool(torch.isfinite(out).all())
    log(f'# kernel {name} {shape_desc}: max_abs_err {err:.3e} '
        f'(tol {TOL[name]:.0e}) kernel {ms:.3f} ms plain(bf16) '
        f'{plain_ms:.3f} ms {"ok" if ok else "FAIL"}')
    _record(report, name, shape_desc, err, ms, plain_ms, work, library)
    if not ok:
        raise PhaseError(f'{name} {shape_desc}: max_abs_err {err:.3e}')


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
            + f' (tol {TOL[name]:.0e}) kernel {ms:.3f} ms plain backward '
            f'(bf16 inputs, dq+dk+dv) {plain_ms:.3f} ms '
            f'{"ok" if ok else "FAIL"}')
        _record(report, name, desc, max(abs_errs), ms, plain_ms, work,
                lambda: lib_ms)
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
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import geglu_ffn as gf
    from videoswap_torch.ops import temporal_attention as ta
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision('highest')
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    f32 = (lambda ts: [t.float() for t in ts])

    # GEGLU FFN: rows = CFG batch 2 x 16 frames x H*W, per U-Net level
    for n, c in ((131072, 320), (32768, 640), (8192, 1280), (2048, 1280)):
        args = [_rand(gen, (n, c)), _rand(gen, (8 * c, c), c ** -0.5),
                _rand(gen, (8 * c,), 0.1), _rand(gen, (c, 4 * c),
                                                 (4 * c) ** -0.5),
                _rand(gen, (c,), 0.1)]
        _compare('geglu_ffn', f'N={n} C={c}',
                 lambda: gf.geglu_ffn(*args),
                 lambda: gf.geglu_ffn_plain(*args),
                 lambda: gf.geglu_ffn_plain(*f32(args)), report,
                 (24 * n * c * c, 2 * (2 * n * c + 12 * c * c + 9 * c)))

    # temporal attention: L locations x F=16 frames, 8 heads
    for el, c in ((8192, 320), (2048, 640), (512, 1280), (128, 1280)):
        q, k, v = (_rand(gen, (el * FRAMES, c)) for _ in range(3))
        view = (lambda t: t.view(el, FRAMES, 8, c // 8))
        _compare('temporal_attention', f'L={el} F={FRAMES} C={c}',
                 lambda: ta.temporal_attention(q, k, v, 8, FRAMES),
                 lambda: ta.temporal_attention_plain(q, k, v, 8, FRAMES),
                 lambda: ta.temporal_attention_plain(*f32((q, k, v)), 8,
                                                     FRAMES), report,
                 (4 * el * FRAMES * FRAMES * c, 2 * 4 * el * FRAMES * c),
                 lambda: cuda_time_ms(
                     lambda: _sdpa(view(q), view(k), view(v)), 10))

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
                     iters=5)
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


def unet_forward(unet):
    """The unet phase's forward: 512x512, 2 frames, CFG-prefix dedup,
    adapter residuals. Inputs come from SEED + 1 rounded to bf16, so the
    GPU bf16 model and the CPU fp32 model see the same values."""
    import torch
    gen = torch.Generator().manual_seed(SEED + 1)
    h8 = SIZE // 8
    x = torch.randn((1, 2, h8, h8, 4), generator=gen)
    text = torch.randn((2, 77, 768), generator=gen)
    res = [torch.randn((2, 2, h8 // r, h8 // r, c), generator=gen) * 0.1
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
    marks = []

    def on_step(i, t, latents):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

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
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        raise PhaseError(f'kernels not launched on the train path: '
                         f'{missing}')


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
            else:
                if 'pipe' not in state:
                    state['pipe'] = build_pipeline('cuda', torch.bfloat16)
                if phase in ('unet', 'small', 'train_small') \
                        and 'cpu' not in state:
                    state['cpu'] = cpu_copy(state['pipe'])
                {'unet': phase_unet, 'small': phase_small,
                 'sample': phase_sample, 'train_small': phase_train_small,
                 'train': phase_train}[phase](report, state)
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
            'launches': paths.get('train', {}).get(name, 0),
            'launches_by_path': {p: c.get(name, 0) for p, c in paths.items()},
            **{key: k.get(key) for key in (
                'max_abs_err', 'ms', 'plain_ms', 'bound_ms', 'bound_by',
                'library_ms', 'shape')},
            **({'max_err_over_max_plain': k['max_err_over_max_plain']}
               if 'max_err_over_max_plain' in k else {})})
    log(json.dumps({'kernels': kernels}))
    log(power)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
