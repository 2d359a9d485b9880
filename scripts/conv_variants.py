#!/usr/bin/env python3
"""Time variants of the fused GroupNorm-SiLU-conv3x3 kernel side by side.

    python3 scripts/conv_variants.py [--variants base,no_act,no_mma,...]

Each variant is `videoswap_torch/csrc/gn_silu_conv.cu` with a few textual
replacements (VARIANTS below), compiled alone with nvcc (sm_90a, the flags
of ops/_build.py) into its own library under build/conv_variants/, all in
parallel, and called through its `vs_gn_silu_conv` entry point with the
weight packed once. On one card, at the JAX benchmark's two shapes (32
images of 64x64, 320 -> 320, and of 32x32, 640 -> 640) and the U-Net's
level-1 resnet input (32x32, 320 -> 640), bf16, random inputs from a seed:
CUDA events over 20 calls a variant, the variants in turns (two rounds),
and each variant's max |out - plain| over max |plain| (the diagnostic
variants skip work, so only `base` is meant to agree). Prints each
variant's ptxas register and spill lines.

Diagnostic variants: `no_act` stages nothing (no input boxes, no
activation: the products and the weight stream alone, on whatever the
halo buffers hold, mostly zeros: at the card's power limit products on
zeros run faster than on data, so `no_x`, which loads the input but
activates nothing, is the products' time on real data); `no_mma` drops
the products (the input boxes, the activation, the weight stream and the
barriers alone); `no_wload` streams each weight stage once (later tiles
reuse stale stages: the products without the weights' L2 traffic);
`mma_only` both of `no_act` and `no_wload`; `no_store` computes the
epilogue's values and stores none. Design variants: `stages3`, a weight
ring of 3 stages, not 4; `act3`, the next chunk's activation from tap 3
on, not 2; `cluster1`, `cluster4`, clusters of one block (each activates
its whole halo) or of up to four channel blocks, not two.

With --clocks, each variant also runs alone for about 3 s at the first
shape while nvidia-smi samples the SM clock and the power draw every 100
ms; the medians are printed.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

CSRC = ROOT / 'videoswap_torch' / 'csrc'
OUT = ROOT / 'build' / 'conv_variants'
SHAPES = ((64, 320, 320), (32, 640, 640), (32, 320, 640))

NO_X = [('    if (!((inside >> k) & 1) || kc', '    if (true || kc')]
NO_ACT = NO_X + [('    mbar_expect_tx(xfull + buf, xbytes);\n'
                  '    for (int q = rank; q < 8; q += csize)\n',
                  '    mbar_arrive(xfull + buf);\n'
                  '    for (int q = 8; q < 8; q += csize)\n')]
NO_WLOAD = [('      load_w(j + kStages);', '      mbar_arrive(full + s);')]
VARIANTS = {
    'base': [],
    'no_act': NO_ACT,
    'no_mma': [('      tap_step<0>(acc, a, b);\n'
                '      tap_step<1>(acc, a, b);\n'
                '      tap_step<2>(acc, a, b);\n'
                '      tap_step<3>(acc, a, b);\n', '')],
    'no_x': NO_X,
    'no_wload': NO_WLOAD,
    'mma_only': NO_ACT + NO_WLOAD,
    'no_store': [('        if (off >= 0)\n', '        if (off == -7)\n')],
    'stages3': [('constexpr int kStages = 4;', 'constexpr int kStages = 3;')],
    'act3': [('constexpr int kActFirst = 2;', 'constexpr int kActFirst = 3;')],
    'cluster1': [('  const int csize = nb % 2 == 0 ? 2 : 1;',
                  '  const int csize = 1;')],
    'cluster4': [('  const int csize = nb % 2 == 0 ? 2 : 1;',
                  '  const int csize = nb % 4 == 0 ? 4 : nb % 2 == 0 ? 2 : 1;')],
}


def build(names):
    from videoswap_torch.ops import _build
    nvcc = _build._nvcc()
    procs = {}
    for name in names:
        d = OUT / name
        d.mkdir(parents=True, exist_ok=True)
        for h in CSRC.glob('*.cuh'):
            shutil.copy(h, d / h.name)
        src = (CSRC / 'gn_silu_conv.cu').read_text()
        for old, new in VARIANTS[name]:
            if old not in src:
                raise SystemExit(f'variant {name}: {old!r} not in the source')
            src = src.replace(old, new)
        (d / 'gn_silu_conv.cu').write_text(src)
        procs[name] = subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, '-shared', '-o', str(d / 'lib.so'),
             str(d / 'gn_silu_conv.cu')], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        log = p.communicate()[0]
        if p.returncode:
            raise SystemExit(f'variant {name}: nvcc failed\n{log[-4000:]}')
        for line in log.splitlines():
            if any(k in line for k in ('registers', 'spill', 'Loss')):
                print(f'# {name} ptxas: {line.strip()}', flush=True)
        lib = ctypes.CDLL(str(OUT / name / 'lib.so'))
        lib.vs_gn_silu_conv.argtypes = \
            _build._SIGNATURES['vs_gn_silu_conv']
        libs[name] = lib
    return libs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument('--variants', default=','.join(VARIANTS))
    ap.add_argument('--clocks', action='store_true')
    args = ap.parse_args()
    names = args.variants.split(',')
    import torch
    if not torch.cuda.is_available():
        sys.exit('no CUDA device: this script runs only on a GPU')
    from videoswap_torch.ops import gn_silu_conv as gc
    libs = build(names)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip()
    print(f'# nvidia-smi: {smi}', flush=True)
    gen = torch.Generator(device='cuda').manual_seed(0)
    n = 32
    for side, cin, cout in SHAPES:
        x = torch.randn((n, side, side, cin), generator=gen,
                        device='cuda').bfloat16()
        gamma = torch.rand(cin, generator=gen, device='cuda') + 0.5
        beta = torch.randn(cin, generator=gen, device='cuda') * 0.1
        weight = (torch.randn((cout, cin, 3, 3), generator=gen, device='cuda')
                  * (9 * cin) ** -0.5).bfloat16()
        bias = torch.randn(cout, generator=gen, device='cuda') * 0.01
        scale, shift = gc.gn_scale_shift(*gc.gn_stats(x, 32), gamma, beta)
        wp = gc.pack_weight(weight)
        out = torch.empty((n, side, side, cout), dtype=torch.bfloat16,
                          device='cuda')
        stream = torch.cuda.current_stream().cuda_stream

        def call(lib):
            status = lib.vs_gn_silu_conv(
                x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                wp.data_ptr(), bias.data_ptr(), out.data_ptr(), n, side,
                side, cin, cout, stream)
            if status:
                raise SystemExit(f'launch failed: cudaError_t {status}')

        ref = gc.gn_silu_conv_plain(x.float(), scale, shift, weight.float(),
                                    bias)
        errs = {}
        for name, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            errs[name] = float((out.float() - ref).abs().max()
                               / ref.abs().max())
        times = {name: [] for name in libs}
        for rnd in range(2):
            order = list(libs) if rnd == 0 else list(libs)[::-1]
            for name in order:
                lib = libs[name]
                for _ in range(3):
                    call(lib)
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(20):
                    call(lib)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
        for name in libs:
            print(f'# N={n} H=W={side} {cin}->{cout} {name}: '
                  + ' / '.join(f'{t:.4f}' for t in times[name])
                  + f' ms; err/max|plain| {errs[name]:.3e}', flush=True)
        if args.clocks and side == SHAPES[0][0]:
            for name, lib in libs.items():
                clk, watts = clocks_while(lambda: call(lib))
                print(f'# N={n} H=W={side} {cin}->{cout} {name}: SM clock '
                      f'{clk:g} MHz, power {watts:g} W (medians while it '
                      'runs)', flush=True)


def clocks_while(fn, seconds=3.0):
    """Median SM clock (MHz) and power draw (W) nvidia-smi reads while fn
    runs back to back for about `seconds`."""
    import statistics
    import time

    import torch
    smi = subprocess.Popen(
        ['nvidia-smi', '--query-gpu=clocks.sm,power.draw',
         '--format=csv,noheader,nounits', '-lms', '100'],
        stdout=subprocess.PIPE, text=True)
    try:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            for _ in range(50):
                fn()
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        text = smi.communicate()[0]
    rows = [line.split(',') for line in text.strip().splitlines()]
    rows = [(float(a), float(b)) for a, b in rows[len(rows) // 3:]]
    return (statistics.median(r[0] for r in rows),
            statistics.median(r[1] for r in rows))


if __name__ == '__main__':
    main()
