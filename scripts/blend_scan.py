#!/usr/bin/env python3
"""How much the latent blend does in chip_smoke.py's blend_small swap.

    python3 scripts/blend_scan.py [BLEND_TH ...]     (default 0.3)

For each blend threshold (`blend_cfg['blend_th']`), runs blend_small's swap
(recompute tier) on the card and on the CPU, and prints one JSON line: the
share of latent values each blend step changes on either side, the GPU bf16
against CPU fp32 relative L2 error, and that error with the latent blend
skipped on the card. Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> None:
    import torch

    from videoswap_torch.pipelines import videoswap_pipeline as vp
    if not torch.cuda.is_available():
        cs.die('no CUDA device: this script runs only on a GPU')
    cs.full_fp32()
    cs.log(f'# nvidia-smi: {cs.card()}')
    pipe = cs.build_pipeline('cuda', torch.bfloat16)
    cpu = cs.cpu_copy(pipe)
    blend_step = vp.latent_blend_step
    changed = []

    def recording(cfg, static_state, lat, *args):
        out, sums = blend_step(cfg, static_state, lat, *args)
        if out is not lat:
            changed.append(float((out != lat).float().mean()))
        return out, sums

    def skipping(cfg, static_state, lat, *args):
        out, sums = blend_step(cfg, static_state, lat, *args)
        return (lat if lat.is_cuda else out), sums

    def run(p, lora, th):
        cfg = cs.blend_config(lora, True)
        swap = cfg['editing_prompts']['man_to_hermione']
        swap['blend_cfg'] = dict(swap['blend_cfg'], blend_th=th)
        return p.validation(cs.blend_video(2, 256, cs.SEED + 6),
                            cs.conditions(2, 256), cs.BLEND_PROMPT, cfg,
                            output_type='latent')['man_to_hermione']

    with tempfile.TemporaryDirectory() as d:
        lora = os.path.join(d, 'edlora_hermione.pth')
        cs.edlora_file(pipe, lora)
        for th in map(float, sys.argv[1:] or ['0.3']):
            with mock.patch.object(vp, 'latent_blend_step', recording):
                gpu = run(pipe, lora, th)
                changed_gpu = changed[:]
                changed.clear()
                t0 = time.perf_counter()
                ref = run(cpu, lora, th)
                t_cpu = time.perf_counter() - t0
                changed_cpu = changed[:]
                changed.clear()
            with mock.patch.object(vp, 'latent_blend_step', skipping):
                skipped = run(pipe, lora, th)
            print(json.dumps({
                'blend_th': th, 'changed_gpu': changed_gpu,
                'changed_cpu': changed_cpu,
                'sound_rel_err': cs.rel_err(gpu, ref),
                'blend_skipped_rel_err': cs.rel_err(skipped, ref),
                'cpu_s': t_cpu}), flush=True)


if __name__ == '__main__':
    main()
