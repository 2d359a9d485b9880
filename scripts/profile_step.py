#!/usr/bin/env python3
"""Device-time breakdown and idle share of one full-width step.

    python3 scripts/profile_step.py [--train] [TRACE_PATH]

The step is the sample path's U-Net step: 16 frames at 512x512, CFG-prefix
dedup, adapter residuals, bf16, random weights from chip_smoke.py's seed.
With --train it is the training path's `VideoSwapTrainer.step` instead
(chip_smoke.py's train phase: 16 frames at 512x512, cached VAE moments,
'edges' gradient checkpointing, AdamW on the adapter). After 3 warm-up
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

Then the device time by kernel group and the 25 largest kernels.
"""

from __future__ import annotations

import collections
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402

GROUPS = (('geglu', 'geglu_ffn kernel'),
          ('flash_fwd', 'flash forward kernel'),
          ('flash_bwd', 'flash backward kernels'),
          ('temporal_attention', 'temporal attention kernel'),
          ('fprop', 'convolution (cuDNN)'), ('conv', 'convolution (cuDNN)'),
          ('gemm', 'matmul (cuBLAS)'), ('sm90_', 'matmul (cuBLAS)'),
          ('cutlass', 'matmul (cuBLAS)'), ('nvjet', 'matmul (cuBLAS)'),
          ('layer_norm', 'layer norm'),
          ('welford', 'reductions (group norm stats)'),
          ('reduce', 'reductions (group norm stats)'),
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


def main() -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        cs.die('no CUDA device: this script runs only on a GPU')
    args = [a for a in sys.argv[1:] if a != '--train']
    train = len(args) < len(sys.argv) - 1
    trace_path = Path(args[0] if args else 'build/step_trace.json')
    trace_path.parent.mkdir(parents=True, exist_ok=True)
    cs.log(f'# nvidia-smi: {cs.card()}')
    pipe = cs.build_pipeline('cuda', torch.bfloat16)
    if train:
        step = train_step(pipe)
    else:
        step = unet_step(pipe.unet)
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


if __name__ == '__main__':
    main()
