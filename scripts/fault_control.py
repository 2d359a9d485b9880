#!/usr/bin/env python3
"""Control run for the model-level limits of chip_smoke.py.

    python3 scripts/fault_control.py

Plants one fault at a time, in a kernel's wrapper (a chunk of the kernel's
work skipped) or in the trainer, and runs chip_smoke.py's unet, small and
train_small comparisons (GPU bf16 kernels against the CPU fp32 plain path)
with it. A sound run comes first. For each kernel fault it also prints the
kernel-level error against the plain version at one level-0 shape, the
check of chip_smoke.py's kernels phase. The faults:

- geglu_last_chunk:   the last 128 of the 4C intermediate columns (one or
                      two steps of the kernel's chunk loop) add nothing;
- geglu_last_eighth:  the last 4C/8 intermediate columns add nothing;
- temporal_last_head: the last of the 8 heads writes zeros;
- flash_last_key_tile: the last 64-key tile is skipped wherever Sk > 64;
- flash_bwd_dkv_last_q_tile: the dK/dV kernel skips its last 64-query tile
                      wherever Sq > 64;
- flash_bwd_dq_last_k_tile: the dQ kernel skips its last 64-key tile
                      wherever Sk > 64;
- adapter_bf16_weights: the trainer keeps the adapter's weights and AdamW
                      state in bf16, as the models are, instead of fp32.

The faulted wrappers call the real kernels on the GPU; CPU tensors go to
the plain versions untouched, so the CPU reference stays sound. Prints one
JSON object last; exits 0 only if the sound run passes every limit, every
forward fault fails at least one of them, every backward fault fails the
train_small gradient limit (its loss, a forward quantity, is untouched),
every kernel fault fails the kernels-phase limit, and the adapter fault
fails train_small's update limits (the AdamW step's change of the weights
against the CPU's, and the share of weights it moves).
"""

from __future__ import annotations

import contextlib
import json
import sys
from pathlib import Path
from unittest import mock

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def _geglu_skip(cols):
    from videoswap_torch.ops.geglu_ffn import geglu_ffn

    def faulted(x, w1, b1, w2, b2):
        if not x.is_cuda:
            return geglu_ffn(x, w1, b1, w2, b2)
        inner = w2.shape[1]
        skip = cols(inner)
        # zero rows of the value half `a`: those intermediate columns add 0
        w1, b1 = w1.clone(), b1.clone()
        w1[inner - skip:inner] = 0
        b1[inner - skip:inner] = 0
        return geglu_ffn(x, w1, b1, w2, b2)
    return mock.patch('videoswap_torch.models.layers.geglu_ffn', faulted)


def _temporal_last_head():
    from videoswap_torch.ops.temporal_attention import temporal_attention

    def faulted(q, k, v, heads, frames):
        out = temporal_attention(q, k, v, heads, frames)
        if out.is_cuda:
            out[:, -(out.shape[1] // heads):] = 0
        return out
    return mock.patch('videoswap_torch.ops.attention.temporal_attention',
                      faulted)


def _flash_last_key_tile():
    from videoswap_torch.ops.flash_attention import flash_attention

    def faulted(q, k, v):
        sk = k.shape[1]
        if q.is_cuda and sk > 64:
            keep = (sk - 1) // 64 * 64
            k, v = k[:, :keep], v[:, :keep]
        return flash_attention(q, k, v)
    return mock.patch('videoswap_torch.ops.attention.flash_attention',
                      faulted)


def _flash_bwd_dkv_last_q_tile():
    from videoswap_torch.ops import flash_attention as fa
    launch = fa._launch_bwd_dkv

    def faulted(q, k, v, dout, lse, delta, dk, dv):
        sq = q.shape[1]
        if sq > 64:
            keep = (sq - 1) // 64 * 64
            q, dout = q[:, :keep], dout[:, :keep]
            lse, delta = (t[:, :keep].contiguous() for t in (lse, delta))
        return launch(q, k, v, dout, lse, delta, dk, dv)
    return mock.patch.object(fa, '_launch_bwd_dkv', faulted)


def _flash_bwd_dq_last_k_tile():
    from videoswap_torch.ops import flash_attention as fa
    launch = fa._launch_bwd_dq

    def faulted(q, k, v, dout, lse, delta, dq):
        sk = k.shape[1]
        if sk > 64:
            keep = (sk - 1) // 64 * 64
            k, v = k[:, :keep], v[:, :keep]
        return launch(q, k, v, dout, lse, delta, dq)
    return mock.patch.object(fa, '_launch_bwd_dq', faulted)


@contextlib.contextmanager
def _adapter_bf16_weights(trainer):
    trainer.adapter.bfloat16()
    try:
        yield
    finally:
        trainer.adapter.float()


# fault -> context manager planting it, given the GPU trainer
FAULTS = {
    'sound': lambda tr: contextlib.nullcontext(),
    'geglu_last_chunk': lambda tr: _geglu_skip(lambda inner: 128),
    'geglu_last_eighth': lambda tr: _geglu_skip(lambda inner: inner // 8),
    'temporal_last_head': lambda tr: _temporal_last_head(),
    'flash_last_key_tile': lambda tr: _flash_last_key_tile(),
    'flash_bwd_dkv_last_q_tile': lambda tr: _flash_bwd_dkv_last_q_tile(),
    'flash_bwd_dq_last_k_tile': lambda tr: _flash_bwd_dq_last_k_tile(),
    'adapter_bf16_weights': _adapter_bf16_weights,
}
BACKWARD_FAULTS = ('flash_bwd_dkv_last_q_tile', 'flash_bwd_dq_last_k_tile')
TRAINER_FAULTS = ('adapter_bf16_weights',)


def kernel_error(fault: str) -> float:
    """max |faulted wrapper - fp32 plain| at one level-0 shape of the
    faulted kernel, as chip_smoke.py's kernels phase measures it (for the
    backward kernels, relative to the largest |plain| entry, at the
    training step's self-attention shape)."""
    import torch

    from videoswap_torch.models import layers
    from videoswap_torch.ops import attention
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import geglu_ffn as gf
    from videoswap_torch.ops import temporal_attention as ta
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    f32 = (lambda ts: [t.float() for t in ts])
    if fault.startswith('geglu'):
        c = 320
        args = [cs._rand(gen, (8192, c)), cs._rand(gen, (8 * c, c), c ** -0.5),
                cs._rand(gen, (8 * c,), 0.1),
                cs._rand(gen, (c, 4 * c), (4 * c) ** -0.5),
                cs._rand(gen, (c,), 0.1)]
        out, ref = layers.geglu_ffn(*args), gf.geglu_ffn_plain(*f32(args))
    elif fault.startswith('flash_bwd'):
        q, k, v, dout = (cs._rand(gen, (cs.FRAMES, 4096, 8, 40))
                         for _ in range(4))
        out, lse = fa.flash_attention_fwd(q, k, v)
        grads = fa.flash_attention_bwd(q, k, v, out, lse, dout)
        ref = fa.flash_attention_bwd_plain(*f32((q, k, v, out)), lse,
                                           dout.float(), 2)
        return max(float((g.float() - r).abs().max() / r.abs().max())
                   for g, r in zip(grads, ref))
    elif fault.startswith('temporal'):
        q, k, v = (cs._rand(gen, (512 * cs.FRAMES, 320)) for _ in range(3))
        out = attention.temporal_attention(q, k, v, 8, cs.FRAMES)
        ref = ta.temporal_attention_plain(*f32((q, k, v)), 8, cs.FRAMES)
    else:
        q = cs._rand(gen, (2, 4096, 8, 40))
        k, v = (cs._rand(gen, (2, 77, 8, 40)) for _ in range(2))
        out = attention.flash_attention(q, k, v)
        ref = fa.flash_attention_plain(*f32((q, k, v)))[0]
    return float((out.float() - ref).abs().max())


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.die('no CUDA device: this script runs only on a GPU')
    cs.log(f'# nvidia-smi: {cs.card()}')
    pipe = cs.build_pipeline('cuda', torch.bfloat16)
    cpu = cs.cpu_copy(pipe)
    ref_unet, ref_small = cs.unet_forward(cpu.unet), cs.small_sample(cpu)
    cpu_trainer = cs.make_trainer(cpu, remat=False)
    batch, draws = cs.small_train_inputs(cpu_trainer)
    ref_loss, ref_grad, ref_update = cs.small_train_step(cpu_trainer, batch,
                                                         draws)
    trainer = cs.make_trainer(pipe)
    rows = {}
    for name, plant in FAULTS.items():
        with plant(trainer):
            loss, grad, update = cs.small_train_step(trainer, batch, draws)
            row = {'unet_rel_err': cs.rel_err(cs.unet_forward(pipe.unet),
                                              ref_unet),
                   'small_rel_err': cs.rel_err(cs.small_sample(pipe),
                                               ref_small),
                   'train_loss_rel_err': abs(loss - ref_loss) / abs(ref_loss),
                   'train_grad_rel_err': cs.rel_err(grad, ref_grad),
                   'train_update_rel_err': cs.rel_err(update, ref_update),
                   'train_moved': cs.moved_share(update)}
            if name not in ('sound',) + TRAINER_FAULTS:
                row['kernel_err'] = kernel_error(name)
        row['unet_fails'] = row['unet_rel_err'] > cs.MODEL_REL_TOL
        row['small_fails'] = row['small_rel_err'] > cs.SAMPLE_REL_TOL
        row['train_loss_fails'] = (row['train_loss_rel_err']
                                   > cs.TRAIN_LOSS_TOL)
        row['train_grad_fails'] = (row['train_grad_rel_err']
                                   > cs.TRAIN_GRAD_TOL)
        row['train_update_fails'] = (
            row['train_update_rel_err'] > cs.TRAIN_UPDATE_TOL
            or row['train_moved'] < cs.TRAIN_MOVED_MIN)
        rows[name] = row
        cs.log(f'# {name}: {json.dumps(row)}')
    sound = rows.pop('sound')
    kernel_tol = {'geglu': cs.TOL['geglu_ffn'],
                  'temporal': cs.TOL['temporal_attention'],
                  'flash_bwd_dkv': cs.TOL['flash_attention_bwd_dkv'],
                  'flash_bwd_dq': cs.TOL['flash_attention_bwd_dq'],
                  'flash_last': cs.TOL['flash_attention_fwd']}
    caught = {}
    for name, r in rows.items():
        if name in TRAINER_FAULTS:
            caught[name] = bool(r['train_update_fails'])
            continue
        tol = next(t for key, t in kernel_tol.items()
                   if name.startswith(key))
        model = (r['train_grad_fails'] if name in BACKWARD_FAULTS else
                 r['unet_fails'] or r['small_fails'] or r['train_loss_fails']
                 or r['train_grad_fails'])
        caught[name] = bool(model and r['kernel_err'] > tol)
    ok = not any(v for k, v in sound.items() if k.endswith('_fails')) \
        and all(caught.values())
    print(json.dumps({'ok': ok, 'unet_tol': cs.MODEL_REL_TOL,
                      'small_tol': cs.SAMPLE_REL_TOL,
                      'train_loss_tol': cs.TRAIN_LOSS_TOL,
                      'train_grad_tol': cs.TRAIN_GRAD_TOL,
                      'train_update_tol': cs.TRAIN_UPDATE_TOL,
                      'train_moved_min': cs.TRAIN_MOVED_MIN, 'sound': sound,
                      'faults': rows, 'caught': caught}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
