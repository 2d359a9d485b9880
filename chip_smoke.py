#!/usr/bin/env python3
"""Smoke run of the PyTorch port (videoswap_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--phases build,kernels,unet,small,sample]

Phases (all by default):

- build:   compile the CUDA kernels from videoswap_torch/csrc/ (nvcc, sm_90a)
           and print the build time and each kernel's registers/spills;
- kernels: each kernel against its plain PyTorch version at the shapes of
           the 16-frame 512x512 CFG swap, bf16, with the tolerance stated;
           times of both with CUDA events;
- unet:    one full-width U-Net forward (512x512, 2 frames, CFG, adapter
           residuals): the kernel path on the GPU in bf16 against the plain
           path on the CPU in fp32, same weights and inputs;
- small:   `sample` at 256x256, 2 frames, 2 DDIM steps: GPU bf16 latents
           against the CPU fp32 pipeline;
- sample:  the main path, `VideoSwapPipeline.sample` at full width: 16
           frames, 512x512, CFG 7.5, point adapter with 10 points, 4 DDIM
           steps, VAE decode; every kernel's launch count must be > 0.

scripts/fault_control.py shows that the unet and small limits fail a
kernel with a planted fault; scripts/profile_step.py breaks one full-width
U-Net step down by device time.

Weights are random, drawn from a seeded torch.Generator. The script fails
(exit code 1, no result line) without a CUDA device, outside a checkout of
the repository, or when any phase fails. Its last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PHASES = ('build', 'kernels', 'unet', 'small', 'sample')
SEED = 0
FRAMES, SIZE, POINTS = 16, 512, 10
STEPS = 4          # DDIM steps of the full-width sample (a smoke run's time)

# kernel -> (module, source, TPU kernel it replaces)
KERNELS = {
    'geglu_ffn': ('geglu_ffn', 'videoswap_torch/csrc/geglu_ffn.cu',
                  'videoswap_tpu/ops/geglu_ffn.py:110'),
    'temporal_attention': (
        'temporal_attention', 'videoswap_torch/csrc/temporal_attention.cu',
        'videoswap_tpu/ops/temporal_attention.py:96'),
    'flash_attention_fwd': (
        'flash_attention', 'videoswap_torch/csrc/flash_attention.cu',
        'videoswap_tpu/ops/flash_attention.py:91'),
}
# max |kernel - plain| allowed, bf16 kernel vs fp32 plain on the same bf16
# inputs: outputs are O(1) and rounded once to bf16 (2^-8 relative), plus
# the bf16 rounding of the intermediate (gated product, probabilities)
TOL = {'geglu_ffn': 3e-2, 'temporal_attention': 1e-2,
       'flash_attention_fwd': 1e-2}
# relative L2 error allowed for whole-model comparisons (GPU bf16 vs CPU
# fp32): bf16 activations through ~100 layers with random weights
MODEL_REL_TOL = 5e-2
# the same for sampled latents: guidance 7.5 multiplies the U-Net's bf16
# error in (eps_cond - eps_uncond) by up to 7.5 at every step
SAMPLE_REL_TOL = 5e-2


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


def _compare(name, shape_desc, kernel, plain_bf16, plain_fp32, report,
             iters=10):
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
    entry = report['kernels'].setdefault(
        name, {'max_abs_err': 0.0, 'ms': None, 'plain_ms': None})
    entry['max_abs_err'] = max(entry['max_abs_err'], err)
    if entry['ms'] is None:       # the first (level-0, largest) shape
        entry.update(ms=ms, plain_ms=plain_ms, shape=shape_desc)
    if not ok:
        raise PhaseError(f'{name} {shape_desc}: max_abs_err {err:.3e}')


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
                 lambda: gf.geglu_ffn_plain(*f32(args)), report)

    # temporal attention: L locations x F=16 frames, 8 heads
    for el, c in ((8192, 320), (2048, 640), (512, 1280), (128, 1280)):
        q, k, v = (_rand(gen, (el * FRAMES, c)) for _ in range(3))
        _compare('temporal_attention', f'L={el} F={FRAMES} C={c}',
                 lambda: ta.temporal_attention(q, k, v, 8, FRAMES),
                 lambda: ta.temporal_attention_plain(q, k, v, 8, FRAMES),
                 lambda: ta.temporal_attention_plain(*f32((q, k, v)), 8,
                                                     FRAMES), report)

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
                     iters=5)
            # the logsumexp the backward will need
            _, lse = fa.flash_attention_fwd(q[:1], k[:1], v[:1])
            _, lse_ref = fa.flash_attention_plain(*f32((q[:1], k[:1],
                                                        v[:1])))
            lerr = float((lse - lse_ref).abs().max())
            if lerr > 1e-2:
                raise PhaseError(f'flash lse max_abs_err {lerr:.3e}')


# --------------------------------------------------------------- models
def build_pipeline(device, dtype):
    import torch
    from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                        SparsePointAdapter, UNet3DConfig)
    from videoswap_torch.models.clip_text import CLIPTextModel
    from videoswap_torch.models.vae import AutoencoderKL
    from videoswap_torch.pipelines import VideoSwapPipeline
    from videoswap_torch.schedulers import make_schedule
    from videoswap_torch.utils.init import init_weights
    from videoswap_torch.utils.tokenizer import HashTokenizer

    gen = torch.Generator(device=device).manual_seed(SEED)
    with torch.device(device):
        unet = AnimateDiffUNet3DModel(cfg=UNet3DConfig())
        vae = AutoencoderKL()
        text_encoder = CLIPTextModel()
        adapter = SparsePointAdapter(cfg=AdapterConfig())
    for m in (unet, vae, text_encoder, adapter):
        init_weights(m, gen)
        m.to(device=device, dtype=dtype).eval().requires_grad_(False)
    return VideoSwapPipeline(unet=unet, vae=vae, text_encoder=text_encoder,
                             tokenizer=HashTokenizer(), sched=make_schedule(),
                             adapter=adapter)


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


def phase_sample(report, state):
    import importlib

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

    mods = {name: importlib.import_module(f'videoswap_torch.ops.{m}')
            for name, (m, _, _) in KERNELS.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in mods.values():
        m.launches = 0
    t0 = time.perf_counter()
    with torch.no_grad():
        video = pipe.sample(callback=on_step, **kw)
    t_total = time.perf_counter() - t0
    counts = {name: m.launches for name, m in mods.items()}
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    steps_s = np.diff([t0] + marks)
    log(f'# sample {FRAMES}x{SIZE}x{SIZE} CFG+adapter {STEPS} DDIM steps: '
        f'total {t_total:.2f} s (text, adapter, steps, VAE decode); per '
        f'U-Net step (s): {" ".join(f"{s:.3f}" for s in steps_s)}; '
        f'peak memory {peak:.2f} GiB')
    log(f'# sample kernel launches: {json.dumps(counts)}')
    report['launches'] = counts
    report['step_s'] = [float(s) for s in steps_s]
    report['peak_gib'] = peak
    ok = (video.shape == (1, FRAMES, SIZE, SIZE, 3)
          and bool(np.isfinite(video).all()))
    if not ok:
        raise PhaseError(f'sample output {video.shape}, finite '
                         f'{np.isfinite(video).all()}')
    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        raise PhaseError(f'kernels not launched on the main path: {missing}')


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

    report = {'kernels': {}}
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
                if phase in ('unet', 'small') and 'cpu' not in state:
                    state['cpu'] = cpu_copy(state['pipe'])
                if phase == 'unet':
                    phase_unet(report, state)
                elif phase == 'small':
                    phase_small(report, state)
                else:
                    phase_sample(report, state)
            log(f'# phase {phase}: {time.perf_counter() - t0:.1f} s')
    except PhaseError as e:
        die(str(e))
    log(f'# total {time.perf_counter() - t_start:.1f} s')

    launches = report.get('launches', {})
    kernels = []
    for name, (_, source, replaces) in KERNELS.items():
        k = report['kernels'].get(name, {})
        kernels.append({'name': name, 'route': 'cuda', 'source': source,
                        'replaces': replaces,
                        'launches': launches.get(name, 0),
                        'max_abs_err': k.get('max_abs_err'),
                        'ms': k.get('ms'), 'plain_ms': k.get('plain_ms'),
                        'shape': k.get('shape')})
    log(json.dumps({'kernels': kernels}))
    log(power)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': kind,
        'count': torch.cuda.device_count()}}), flush=True)


if __name__ == '__main__':
    main()
