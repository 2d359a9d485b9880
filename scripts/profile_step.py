#!/usr/bin/env python3
"""Device-time breakdown and idle share of one full-width step.

    python3 scripts/profile_step.py [--train | --atlas] [TRACE_PATH]

The step is the sample path's U-Net step: 16 frames at 512x512, CFG-prefix
dedup, adapter residuals, bf16, random weights from chip_smoke.py's seed.
With --train it is the training path's `VideoSwapTrainer.step` instead
(chip_smoke.py's train phase: 16 frames at 512x512, cached VAE moments,
'edges' gradient checkpointing, AdamW on the adapter). With --atlas it is
one atlas iteration, a main step then an inverse step, fp32 (chip_smoke.py's
atlas phase: the atlas_swan nets on the synthetic 72-frame 768x448 clip,
batch 10000, after ATLAS_PROFILE_PRETRAIN x 72 pretraining iterations of
each mapping, which spread the UVs over their quadrants). After 3 warm-up
steps it times 10 steps on the host clock (each ended by a
`torch.cuda.synchronize()`), then traces one more under `torch.profiler`
and writes the Chrome trace to TRACE_PATH (default build/step_trace.json,
inside the build directory that version control ignores).

Device busy time is the union of the traced step's kernel, memcpy and
memset spans. Two idle shares are printed:

- of the traced step's own host-clock time (launch to synchronize; the
  profiler's host-side cost is inside it, so this share reads high);
- of the median untraced step (busy time of the traced step set against
  steps timed without the profiler).

Then the device time by kernel group and the 25 largest kernels. With
--atlas it last times the iteration in turns with the hash encoding's small
constants copied to the card blocking (a plain `torch.tensor(...,
device=...)`, which waits for the card's queue to drain) and as the port
copies them (pinned, non-blocking): the median of each over
ATLAS_AB_ROUNDS rounds of ATLAS_AB_ITERS iterations.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

# pretraining iterations a frame before the atlas profile (the published
# 100 would take the mappings to the same spread of UVs, more slowly)
ATLAS_PROFILE_PRETRAIN = 10
ATLAS_AB_ROUNDS, ATLAS_AB_ITERS = 4, 30

# the first key a kernel's name contains names its group. 'geglu' takes
# both GEGLU kernels (the fused geglu_ffn_kernel<C> and the split route's
# geglu_gate_kernel); the split route's two products show under cuBLAS
GROUPS = (('fused_temporal', 'fused temporal transformer kernel'),
          ('geglu', 'geglu_ffn kernel'),
          ('hash_grad', 'hash_table_grad kernel'),
          ('flash_fwd', 'flash forward kernel'),
          ('onlinesoftmax', 'flash forward kernel'),      # attention_sm90.cuh
          ('flash_bwd', 'flash backward kernels'),
          ('temporal_attention', 'temporal attention kernel'),
          ('fprop', 'convolution (cuDNN)'), ('conv', 'convolution (cuDNN)'),
          ('gemm', 'matmul (cuBLAS)'), ('sm90_', 'matmul (cuBLAS)'),
          ('cutlass', 'matmul (cuBLAS)'), ('nvjet', 'matmul (cuBLAS)'),
          ('layer_norm', 'layer norm'),
          ('multi_tensor', 'optimizer (foreach)'),
          ('index', 'gather / scatter (indexing)'),
          ('scatter_gather', 'gather / scatter (indexing)'),
          ('welford', 'reductions (norm statistics, sums)'),
          ('reduce', 'reductions (norm statistics, sums)'),
          ('cat', 'cat / copies'), ('copy', 'cat / copies'),
          ('elementwise', 'elementwise'))


def group(name: str) -> str:
    n = name.lower()
    return next((label for key, label in GROUPS if key in n), 'other')


def union_us(spans) -> float:
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    return busy + (cur_e - cur_s if cur_e is not None else 0.0)


def unet_step(unet):
    import torch
    g = torch.Generator(device='cuda').manual_seed(cs.SEED)
    h8 = cs.SIZE // 8
    x = torch.randn((1, cs.FRAMES, h8, h8, 4), generator=g,
                    device='cuda').bfloat16()
    text = torch.randn((2, 77, 768), generator=g, device='cuda').bfloat16()
    res = [torch.randn((2, cs.FRAMES, h8 // r, h8 // r, c), generator=g,
                       device='cuda').bfloat16() * 0.1
           for r, c in ((1, 320), (2, 640), (4, 1280), (8, 1280))]
    t = torch.tensor(501, device='cuda')

    @torch.no_grad()
    def step():
        unet(x, t, text, res, cfg_prefix_dedup=True)
        torch.cuda.synchronize()
    return step


def train_step(pipe):
    import torch
    trainer = cs.make_trainer(pipe)
    batch = {k: v.cuda() for k, v in
             cs.train_batch(cs.FRAMES, cs.SIZE, cs.SEED + 5).items()}
    with torch.no_grad():
        mean, logvar = trainer.vae.encode_video_moments(
            batch.pop('pixels').bfloat16())
    batch.update(latent_mean=mean, latent_logvar=logvar)
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)

    def step():
        trainer.step(batch, gen)
        torch.cuda.synchronize()
    return step


def atlas_step():
    import torch
    from videoswap_torch.builders import build_atlas_nets
    nets = build_atlas_nets(cs.ATLAS_MODELS, device='cuda', seed=cs.SEED)
    trainer = cs.atlas_trainer(nets, cs.atlas_clip(
        cs.ATLAS_FRAMES, cs.ATLAS_H, cs.ATLAS_W, 'cuda'), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    for name in ('FG_UV_Mapping', 'BG_UV_Mapping'):
        trainer.pretrain_mapping(name, gen, ATLAS_PROFILE_PRETRAIN)
    trainer.init_opt_state()
    it = [0]

    def step():
        it[0] += 1
        trainer.step(it[0], gen)
        trainer.inverse_step(gen)
        torch.cuda.synchronize()
    return step


def atlas_constant_copies_ab(step) -> None:
    """Median host-clock iteration, blocking constant copies against the
    port's non-blocking ones, in turns (blocking first in even rounds)."""
    import statistics

    import torch
    from videoswap_torch.atlas import imlp
    port_const = imlp._const

    def blocking(values, device, dtype=None):
        return torch.tensor(values, dtype=dtype, device=device)
    times = {'blocking': [], 'non-blocking': []}
    try:
        for r in range(ATLAS_AB_ROUNDS):
            order = (('blocking', blocking), ('non-blocking', port_const))
            for name, const in order if r % 2 == 0 else order[::-1]:
                imlp._const = const
                step()
                for _ in range(ATLAS_AB_ITERS):
                    t0 = time.perf_counter()
                    step()
                    times[name].append(time.perf_counter() - t0)
    finally:
        imlp._const = port_const
    cs.log('# atlas iteration with the hash encoding\'s constants copied '
           'blocking vs non-blocking, median ms over '
           f'{ATLAS_AB_ROUNDS} x {ATLAS_AB_ITERS} iterations in turns: '
           + ', '.join(f'{k} {statistics.median(v) * 1e3:.2f} (quartiles '
                       f'{statistics.quantiles(v, n=4)[0] * 1e3:.2f}-'
                       f'{statistics.quantiles(v, n=4)[2] * 1e3:.2f})'
                       for k, v in times.items()))


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        cs.die('no CUDA device: this script runs only on a GPU')
    cs.full_fp32()
    flags = {'--train', '--atlas'}
    args = [a for a in sys.argv[1:] if a not in flags]
    mode = next((a for a in sys.argv[1:] if a in flags), None)
    trace_path = Path(args[0] if args else 'build/step_trace.json')
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    cs.log(f'# nvidia-smi: {cs.card()}')
    if mode == '--atlas':
        step = atlas_step()
    elif mode == '--train':
        step = train_step(cs.build_pipeline('cuda', torch.bfloat16))
    else:
        step = unet_step(cs.build_pipeline('cuda', torch.bfloat16).unet)
    for _ in range(3):
        step()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        step()
        times.append(time.perf_counter() - t0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step()
        traced_s = time.perf_counter() - t0
    prof.export_chrome_trace(str(trace_path))
    events = json.loads(trace_path.read_text())['traceEvents']
    kern = [e for e in events
            if e.get('cat') in ('kernel', 'gpu_memcpy', 'gpu_memset')]
    busy = union_us((e['ts'], e['ts'] + e['dur']) for e in kern) / 1e6
    median = sorted(times)[len(times) // 2]
    cs.log('# untraced steps, host clock (s): '
           + ' '.join(f'{s:.4f}' for s in times))
    cs.log(f'# traced step: {len(kern)} kernels; device busy '
           f'{busy * 1e3:.2f} ms; host clock {traced_s * 1e3:.2f} ms, idle '
           f'share {1 - busy / traced_s:.4f}; median untraced step '
           f'{median * 1e3:.2f} ms, idle share {1 - busy / median:.4f}')
    by = collections.defaultdict(lambda: [0.0, 0])
    names = collections.defaultdict(lambda: [0.0, 0])
    for e in kern:
        for table, key in ((by, group(e['name'])), (names, e['name'])):
            table[key][0] += e['dur'] / 1e3
            table[key][1] += 1
    for label, (ms, n) in sorted(by.items(), key=lambda kv: -kv[1][0]):
        cs.log(f'{ms:9.2f} ms {100 * ms / (busy * 1e3):5.1f}% x{n:5d} {label}')
    cs.log('top kernels:')
    for name, (ms, n) in sorted(names.items(), key=lambda kv: -kv[1][0])[:25]:
        cs.log(f'{ms:9.2f} ms x{n:5d} {name[:120]}')
    # launches of each flash instantiation (its head dim) in the step
    cs.log('flash kernels by instantiation:')
    for name, (ms, n) in sorted(names.items()):
        if 'flash' in name:
            cs.log(f'{ms:9.2f} ms x{n:5d} {name[:90]}')
    if mode == '--atlas':
        atlas_constant_copies_ab(step)


if __name__ == '__main__':
    main()
