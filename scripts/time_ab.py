#!/usr/bin/env python3
"""Temporal attention, the hash backward, the atlas iteration and the fused
GroupNorm-SiLU-conv3x3 of one checkout, timed for comparing checkouts.

    python3 scripts/time_ab.py [--root DIR] [--iters N] [--parent DIR]
                               [--parts temporal,hash,atlas,conv]

Imports `videoswap_torch` from the checkout at DIR (default: this one),
e.g. a parent commit unpacked with `git archive`, so that one script times
both versions; run them in turns (parent, change, change, parent, ...),
each in its own process. The first run of a checkout builds its kernels.
On one card:

- temporal attention at the swap's two shapes (C = 1280, 8 heads, 16
  frames, L = 512 and 128 locations, bf16): the time a call on the device
  alone (the calls queued behind a device-side sleep, so the host's pace
  does not show) and launched one after another, CUDA events over 50
  calls;
- one backward of `hash_encode` at the atlas's geometry (atlas_swan: 16
  levels, base resolution 16, scale 1.38, T = 2^19, F = 2) for 60000 UVs
  uniform in [-0.7, 0.7] (the six batches of 10000 of an atlas main
  step), with both gradients, the table's and the UVs', as the main step
  takes them. The forward runs once; each of N iterations (default 200,
  after 10 warm-up ones) times on the host clock the `torch.autograd.grad`
  call alone (what the host spends launching the backward: what a
  host-paced step pays) and the call to the end of its work (a synchronize
  after it). Prints the median and quartiles of each, and the hash
  kernel's launches a backward;
- the atlas iteration as chip_smoke.py's atlas phase runs it (its helpers,
  from this checkout's chip_smoke.py: the atlas_swan nets from its seed on
  the synthetic 72-frame 768x448 clip, batch 10000), after ATLAS_PRETRAIN
  pretraining iterations a frame of each mapping and 10 warm-up
  iterations: the median main and inverse step over ATLAS_ITERS
  iterations, CUDA events (chip_smoke.py's metric).

- the fused GroupNorm-SiLU-conv3x3 kernel (`gn_silu_conv_kernel`, its
  weight packing included) at the JAX benchmark's two shapes, 32 images
  of 64x64, 320 -> 320 and 32x32, 640 -> 640, and at the U-Net's level-1
  resnet input, 32x32, 320 -> 640 (bf16, random inputs from a seed):
  CUDA events over 20 calls, beside cuDNN's conv2d alone on the activated
  input and the group_norm + silu + conv2d chain, timed in the same
  process (the stand-ins chip_smoke.py times).

`--parts` picks which of the four run (all by default).

With --parent DIR it times, in this one process and after the above, the
atlas iteration in turns with the hash encoding's backward scattering as
this checkout does and as 16 one-level calls of the `hash_table_grad` of
the checkout at DIR (its own kernel library; the form of a parent whose
backward made one call a level): ATLAS_AB_ROUNDS rounds of ATLAS_AB_ITERS
iterations a side, the side that goes first alternating; the median main
step of each round (CUDA events), so that rounds pair up without the
spread between processes.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

SEED = 0
ATLAS_PRETRAIN, ATLAS_ITERS = 10, 100
ATLAS_AB_ROUNDS, ATLAS_AB_ITERS = 10, 30


def device_ms(fn, iters: int, ahead: bool) -> float:
    """Time a call of fn over `iters` calls after two, by CUDA events; with
    `ahead` the card first sleeps about 1 ms a call, so that every call is
    queued before the first starts."""
    import torch
    for _ in range(2):
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


def temporal(label: str) -> None:
    import torch
    from videoswap_torch.ops import temporal_attention as ta
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    for el in (512, 128):
        q, k, v = (torch.randn((el * 16, 1280), generator=gen,
                               device='cuda').bfloat16() for _ in range(3))

        def call():
            return ta.temporal_attention(q, k, v, 8, 16)
        alone = device_ms(call, 50, ahead=True)
        paced = device_ms(call, 50, ahead=False)
        print(f'{label} temporal_attention L={el} F=16 C=1280: '
              f'{alone:.4f} ms a call on the device alone, {paced:.4f} ms '
              'launched one after another', flush=True)


def hash_backward(label: str, iters: int) -> None:
    import torch
    from videoswap_torch.atlas.imlp import hash_encode
    from videoswap_torch.ops import hash_table_grad as hg
    rs = np.random.RandomState(SEED)
    dev = torch.device('cuda')
    x = torch.from_numpy(rs.uniform(-0.7, 0.7, (60000, 2)).astype(
        np.float32)).to(dev).requires_grad_()
    table = torch.from_numpy((rs.standard_normal((16, 2 ** 19, 2)) * 1e-4)
                             .astype(np.float32)).to(dev).requires_grad_()
    out = hash_encode(x, table)
    g = torch.from_numpy(rs.standard_normal(tuple(out.shape)).astype(
        np.float32)).to(dev)

    def backward():
        return torch.autograd.grad(out, (x, table), g, retain_graph=True)
    for _ in range(10):
        backward()
    torch.cuda.synchronize()
    before = hg.launches
    host, wall = [], []
    for _ in range(iters):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grads = backward()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        wall.append((t2 - t0) * 1e3)
        del grads
    per_call = (hg.launches - before) / iters

    def stats(v):
        q = statistics.quantiles(v, n=4)
        return f'median {statistics.median(v):.4f} ms (quartiles ' \
               f'{q[0]:.4f}-{q[2]:.4f})'
    print(f'{label} hash_encode backward, 16 levels, 60000 UVs: host call '
          f'{stats(host)}; to the end of its work {stats(wall)}; hash kernel '
          f'launches a backward {per_call:g} ({iters} iterations)',
          flush=True)


def conv(label: str) -> None:
    import torch
    import torch.nn.functional as F
    from videoswap_torch.ops import gn_silu_conv as gc
    gen = torch.Generator(device='cuda').manual_seed(SEED)
    n = 32
    for side, cin, cout in ((64, 320, 320), (32, 640, 640), (32, 320, 640)):
        x = torch.randn((n, side, side, cin), generator=gen,
                        device='cuda').bfloat16()
        gamma = torch.rand(cin, generator=gen, device='cuda') + 0.5
        beta = torch.randn(cin, generator=gen, device='cuda') * 0.1
        weight = (torch.randn((cout, cin, 3, 3), generator=gen, device='cuda')
                  * (9 * cin) ** -0.5).bfloat16()
        bias = torch.randn(cout, generator=gen, device='cuda') * 0.01
        scale, shift = gc.gn_scale_shift(*gc.gn_stats(x, 32), gamma, beta)
        a = F.silu(x.float() * scale[:, None, None] + shift[:, None, None]) \
            .bfloat16().permute(0, 3, 1, 2)
        x_cl = x.permute(0, 3, 1, 2)
        w_cl = weight.contiguous(memory_format=torch.channels_last)
        g16, b16, bias16 = (t.bfloat16() for t in (gamma, beta, bias))
        with torch.no_grad():
            kernel = device_ms(lambda: gc.gn_silu_conv_kernel(
                x, scale, shift, weight, bias), 20, ahead=False)
            cudnn = device_ms(lambda: F.conv2d(a, w_cl, bias16, padding=1),
                              20, ahead=False)
            chain = device_ms(lambda: F.conv2d(F.silu(F.group_norm(
                x_cl, 32, g16, b16)), w_cl, bias16, padding=1), 20,
                ahead=False)
        print(f'{label} gn_silu_conv N={n} H=W={side} {cin}->{cout}: kernel '
              f'{kernel:.4f} ms; cuDNN conv2d alone {cudnn:.4f} ms; '
              f'group_norm + silu + conv2d {chain:.4f} ms', flush=True)


def main_step_ms(trainer, gen, it0: int, iters: int) -> float:
    """The median main step (CUDA events) of `iters` atlas iterations."""
    import torch
    marks = []
    for it in range(it0, it0 + iters):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        trainer.step(it, gen)
        ev[1].record()
        trainer.inverse_step(gen)
        marks.append(ev)
    torch.cuda.synchronize()
    return statistics.median(e[0].elapsed_time(e[1]) for e in marks)


def parent_levels(parent_root: str):
    """A stand-in for hash_table_grad_levels that makes the 16 one-level
    calls of the parent checkout's `hash_table_grad`, loaded as the package
    `parent_ops` without the rest of the parent's package."""
    import types
    pkg = types.ModuleType('parent_ops')
    pkg.__path__ = [str(Path(parent_root).resolve() / 'videoswap_torch'
                        / 'ops')]
    sys.modules['parent_ops'] = pkg
    hg = importlib.import_module('parent_ops.hash_table_grad')
    importlib.import_module('parent_ops._build').library()

    def levels(idx, val, used, out):
        for lv, n in enumerate(used):
            hg.hash_table_grad(idx[lv], val[lv], n, out=out[lv, :n])
        return out
    return levels


def atlas_trainer(cs):
    import torch
    from videoswap_torch.builders import build_atlas_nets
    nets = build_atlas_nets(cs.ATLAS_MODELS, device='cuda', seed=cs.SEED)
    trainer = cs.atlas_trainer(nets, cs.atlas_clip(
        cs.ATLAS_FRAMES, cs.ATLAS_H, cs.ATLAS_W, 'cuda'), 'cuda')
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    for name in ('FG_UV_Mapping', 'BG_UV_Mapping'):
        trainer.pretrain_mapping(name, gen, ATLAS_PRETRAIN)
    trainer.init_opt_state()
    return trainer, gen


def atlas_in_turns(label: str, cs, parent_root: str) -> None:
    from videoswap_torch.atlas import imlp
    sides = {'this': imlp.hash_table_grad_levels,
             'parent': parent_levels(parent_root)}
    trainer, gen = atlas_trainer(cs)
    it = 1
    rounds = {k: [] for k in sides}
    try:
        for r in range(ATLAS_AB_ROUNDS):
            order = list(sides) if r % 2 == 0 else list(sides)[::-1]
            for name in order:
                imlp.hash_table_grad_levels = sides[name]
                main_step_ms(trainer, gen, it, 3)
                rounds[name].append(main_step_ms(trainer, gen, it + 3,
                                                 ATLAS_AB_ITERS))
                it += 3 + ATLAS_AB_ITERS
    finally:
        imlp.hash_table_grad_levels = sides['this']
    wins = sum(a < b for a, b in zip(rounds['this'], rounds['parent']))
    for name, v in rounds.items():
        q = statistics.quantiles(v, n=4)
        print(f'{label} atlas main step in turns, hash scatter of {name}: '
              f'median of round medians {statistics.median(v):.3f} ms '
              f'(quartiles {q[0]:.3f}-{q[2]:.3f}); rounds '
              + ' '.join(f'{x:.3f}' for x in v), flush=True)
    print(f'{label} atlas main step in turns: this checkout faster in {wins} '
          f'of {ATLAS_AB_ROUNDS} rounds', flush=True)


def atlas_steps(label: str, cs) -> None:
    import torch
    trainer, gen = atlas_trainer(cs)
    marks = []
    for it in range(1, 11 + ATLAS_ITERS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        trainer.step(it, gen)
        ev[1].record()
        trainer.inverse_step(gen)
        ev[2].record()
        if it > 10:
            marks.append(ev)
    torch.cuda.synchronize()
    main_ms = statistics.median(e[0].elapsed_time(e[1]) for e in marks)
    inv_ms = statistics.median(e[1].elapsed_time(e[2]) for e in marks)
    print(f'{label} atlas main step median {main_ms:.3f} ms, inverse step '
          f'{inv_ms:.3f} ms ({ATLAS_ITERS} iterations, CUDA events)',
          flush=True)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument('--root', default=str(Path(__file__).resolve()
                                              .parents[1]))
    parser.add_argument('--iters', type=int, default=200)
    parser.add_argument('--parent')
    parser.add_argument('--parts', default='temporal,hash,atlas,conv')
    args = parser.parse_args()
    parts = set(args.parts.split(','))
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this script runs only on a GPU')
    from videoswap_torch.ops import _build
    _build.library()
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(f'# nvidia-smi: {smi}; root {args.root}', flush=True)
    label = f'# [{args.root}]'
    if 'temporal' in parts:
        temporal(label)
    if 'hash' in parts:
        hash_backward(label, args.iters)
    if 'conv' in parts:
        conv(label)
    if 'atlas' not in parts:
        return
    spec = importlib.util.spec_from_file_location(
        'chip_smoke', Path(__file__).resolve().parents[1] / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    cs.full_fp32()
    atlas_steps(label, cs)
    if args.parent:
        atlas_in_turns(label, cs, args.parent)


if __name__ == '__main__':
    main()
