#!/usr/bin/env python3
"""Control run for the model-level limits of chip_smoke.py.

    python3 scripts/fault_control.py

Plants one fault at a time, in a kernel's wrapper (a chunk of the kernel's
work skipped), in the trainer or in the blended swap, and runs
chip_smoke.py's unet, small, train_small and blend_small comparisons (GPU
bf16 kernels against the CPU fp32 plain path; blend_small in its recompute
tier) and its atlas_small comparison (GPU fp32 against CPU fp32) with it. A
sound run comes first. For each kernel fault it also prints the
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
                      state in bf16, as the models are, instead of fp32;
- hash_last_corner:   the hash-grid table-gradient kernel skips the rows
                      of the fourth cell corner (the last quarter of each
                      level's corner-major 4 x points rows);
- hash_last_block:    the same kernel skips only its last 256-row block
                      (the fourth corner of the last 64 points): a fault
                      below what atlas_small can see, which the kernel
                      limit must catch alone;
- fused_last_head:    the fused temporal-transformer kernel's last of 8
                      heads adds nothing (its out-projection columns
                      zeroed), in both attention blocks, at C = 320 and 640;
- fused_skip_ffn:     the fused kernel's FFN half adds nothing at C = 320
                      (its second GEGLU product and bias zeroed);
- edit_cross_skipped: the prompt-to-prompt controller leaves the
                      cross-attention maps unedited (no refinement from the
                      source prompt's maps);
- blend_latents_skipped: the blended swap's latent blending is skipped (the
                      edited latents kept where the mask would put back the
                      inversion's).

The last two are faults of the blended path with no kernel: blend_small
alone can catch them. The skipped blend is reported but not required: with
random weights the 5-step swap's edited latents stay next to the
inversion's at the two blend steps, so skipping the blend moves
blend_small's error by about 1e-4 of itself (a blind spot of the card
check; the CPU tests hold the blend mask and `latent_blend_step` to the JAX
package's on inputs where the mask matters).

The faulted wrappers call the real kernels on the GPU; CPU tensors go to
the plain versions untouched, so the CPU reference stays sound. Prints one
JSON object last; exits 0 only if the sound run passes every limit, every
forward fault fails at least one of them, every backward fault fails the
train_small gradient limit (its loss, a forward quantity, is untouched),
every kernel fault fails the kernels-phase limit, the adapter fault fails
train_small's update limits (the AdamW step's change of the weights against
the CPU's, and the share of weights it moves), the hash-corner fault
fails atlas_small's hash-table gradient limit (the atlas's forward and its
other gradients are untouched), and the cross-edit fault fails
blend_small's limit.
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
def _fused_fault(kind):
    """Plant a fault in the parameters the motion modules hand the fused
    kernel (CUDA tensors only)."""
    import torch

    from videoswap_torch.models import motion_module as mm

    def plant(flat, heads, include_ffn):
        flat = list(flat)
        c = flat[0].shape[0]
        if kind == 'last_head':
            for j in (7, 14):         # the two attention blocks' to_out
                flat[j] = flat[j].clone()
                flat[j][:, c - c // heads:] = 0
        elif include_ffn:
            for j in (20, 21):        # the FFN's second product and bias
                flat[j] = torch.zeros_like(flat[j])
        return flat

    def wrap(fn):
        def faulted(g, x, pe, flat, heads, f, n_blocks=1, include_ffn=True):
            if x.is_cuda:
                flat = plant(flat, heads, include_ffn)
            return fn(g, x, pe, flat, heads, f, n_blocks, include_ffn)
        return faulted

    with mock.patch.object(mm, 'fused_temporal_transformer',
                           wrap(mm.fused_temporal_transformer)), \
            mock.patch.object(mm, 'fused_temporal_transformer_bfhw',
                              wrap(mm.fused_temporal_transformer_bfhw)):
        yield


def _hash_skip(kept):
    from videoswap_torch.ops import hash_table_grad as hg
    launch = hg._launch

    def faulted(idx, val, out, mode='auto'):
        keep = kept(idx.shape[0])
        return launch(idx[:keep], val[:keep], out, mode)
    return mock.patch.object(hg, '_launch', faulted)


def _edit_cross_skipped():
    from videoswap_torch.p2p import edit
    make_edit_fn = edit.make_edit_fn

    def faulted(cfg, static_state):
        edit_fn = make_edit_fn(cfg, static_state)

        def fn(site, q_tokens, state):
            rewrite = edit_fn(site, q_tokens, state)
            if rewrite is None or site.kind != 'cross':
                return rewrite
            return lambda probs: probs if probs.is_cuda else rewrite(probs)
        return fn
    return mock.patch.object(edit, 'make_edit_fn', faulted)


def _blend_latents_skipped():
    from videoswap_torch.pipelines import videoswap_pipeline as vp
    blend_step = vp.latent_blend_step

    def faulted(cfg, static_state, lat, *args):
        out, sums = blend_step(cfg, static_state, lat, *args)
        return (lat if lat.is_cuda else out), sums
    return mock.patch.object(vp, 'latent_blend_step', faulted)


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
    'hash_last_corner': lambda tr: _hash_skip(lambda r: r * 3 // 4),
    'hash_last_block': lambda tr: _hash_skip(
        lambda r: max(0, (r - 1) // 256 * 256)),
    'fused_last_head': lambda tr: _fused_fault('last_head'),
    'fused_skip_ffn': lambda tr: _fused_fault('skip_ffn'),
    'edit_cross_skipped': lambda tr: _edit_cross_skipped(),
    'blend_latents_skipped': lambda tr: _blend_latents_skipped(),
}
BACKWARD_FAULTS = ('flash_bwd_dkv_last_q_tile', 'flash_bwd_dq_last_k_tile')
ATLAS_FAULTS = ('hash_last_corner',)
KERNEL_ONLY_FAULTS = ('hash_last_block',)
TRAINER_FAULTS = ('adapter_bf16_weights',)
BLEND_FAULTS = ('edit_cross_skipped', 'blend_latents_skipped')
BLIND_FAULTS = ('blend_latents_skipped',)     # reported, not required


def kernel_error(fault: str) -> float:
    """max |faulted wrapper - fp32 plain| at one level-0 shape of the
    faulted kernel, as chip_smoke.py's kernels phase measures it (for the
    backward kernels and the fused temporal transformer, relative to the
    largest |plain| entry; the backward at the training step's
    self-attention shape)."""
    import torch

    from videoswap_torch.models import layers
    from videoswap_torch.ops import attention
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import geglu_ffn as gf
    from videoswap_torch.ops import hash_table_grad as hg
    from videoswap_torch.ops import temporal_attention as ta
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    f32 = (lambda ts: [t.float() for t in ts])
    if fault.startswith('hash'):
        # level 0 of a main step, relative to the largest |plain| entry
        idx, val = cs._hash_rows(gen, 240000, 289)
        ref = hg.hash_table_grad_plain(idx, val, 289)
        out = hg.hash_table_grad(idx, val, 289)
        return float((out - ref).abs().max() / ref.abs().max())
    if fault.startswith('fused'):
        from videoswap_torch.models import motion_module as mm
        from videoswap_torch.ops import fused_temporal as ft
        g, x, pe, flat, _ = cs._fused_inputs(gen, 2, 256, 320, True)
        g2, x2 = (ft.rows_of(t).contiguous() for t in (g, x))
        out = mm.fused_temporal_transformer(g2, x2, pe, flat, 8, cs.FRAMES)
        ref = ft.fused_temporal_plain(g2.float(), x2.float(), pe.float(),
                                      f32(flat), 8, cs.FRAMES)
        return float((out.float() - ref).abs().max() / ref.abs().max())
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
    import tempfile

    import torch
    if not torch.cuda.is_available():
        cs.die('no CUDA device: this script runs only on a GPU')
    cs.full_fp32()
    cs.log(f'# nvidia-smi: {cs.card()}')
    pipe = cs.build_pipeline('cuda', torch.bfloat16)
    cpu = cs.cpu_copy(pipe)
    ref_unet, ref_small = cs.unet_forward(cpu.unet), cs.small_sample(cpu)
    cpu_trainer = cs.make_trainer(cpu, remat=False)
    batch, draws = cs.small_train_inputs(cpu_trainer)
    ref_loss, ref_grad, ref_update = cs.small_train_step(cpu_trainer, batch,
                                                         draws)
    trainer = cs.make_trainer(pipe)
    atlas_gpu, atlas_cpu, atlas_draws = cs.atlas_small_inputs('cuda')
    ref_atlas = cs.atlas_small_step(atlas_cpu, atlas_draws)
    lora_dir = tempfile.TemporaryDirectory()
    lora = str(Path(lora_dir.name) / 'edlora_hermione.pth')
    cs.edlora_file(pipe, lora)
    ref_blend = cs.blend_small_run(cpu, lora, True)
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
                   'train_moved': cs.moved_share(update),
                   'blend_small_rel_err': cs.rel_err(
                       cs.blend_small_run(pipe, lora, True), ref_blend)}
            atlas = cs.atlas_small_errors(
                cs.atlas_small_step(atlas_gpu, atlas_draws), ref_atlas)
            row.update({f'atlas_{k}_rel_err': v for k, v in atlas.items()
                        if k != 'per_net'})
            row['atlas_fails'] = sorted(
                k for k, v in cs.atlas_small_fails(atlas).items() if v)
            if name not in ('sound',) + TRAINER_FAULTS + BLEND_FAULTS:
                row['kernel_err'] = kernel_error(name)
        row['unet_fails'] = row['unet_rel_err'] > cs.MODEL_REL_TOL
        row['small_fails'] = row['small_rel_err'] > cs.SAMPLE_REL_TOL
        row['blend_small_fails'] = (row['blend_small_rel_err']
                                    > cs.BLEND_REL_TOL)
        row['train_loss_fails'] = (row['train_loss_rel_err']
                                   > cs.TRAIN_LOSS_TOL)
        row['train_grad_fails'] = (row['train_grad_rel_err']
                                   > cs.TRAIN_GRAD_TOL)
        row['train_update_fails'] = (
            row['train_update_rel_err'] > cs.TRAIN_UPDATE_TOL
            or row['train_moved'] < cs.TRAIN_MOVED_MIN)
        rows[name] = row
        cs.log(f'# {name}: {json.dumps(row)}')
    lora_dir.cleanup()
    sound = rows.pop('sound')
    kernel_tol = {'hash': cs.HASH_TOL,
                  'geglu': cs.TOL['geglu_ffn'],
                  'temporal': cs.TOL['temporal_attention'],
                  'flash_bwd_dkv': cs.TOL['flash_attention_bwd_dkv'],
                  'flash_bwd_dq': cs.TOL['flash_attention_bwd_dq'],
                  'flash_last': cs.TOL['flash_attention_fwd'],
                  'fused': cs.TOL['fused_temporal']}
    caught = {}
    for name, r in rows.items():
        if name in TRAINER_FAULTS:
            caught[name] = bool(r['train_update_fails'])
            continue
        if name in BLEND_FAULTS:
            caught[name] = bool(r['blend_small_fails'])
            continue
        tol = next(t for key, t in kernel_tol.items()
                   if name.startswith(key))
        if name in KERNEL_ONLY_FAULTS:
            model = True
        elif name in ATLAS_FAULTS:
            model = 'hash_grad' in r['atlas_fails']
        elif name in BACKWARD_FAULTS:
            model = r['train_grad_fails']
        else:
            model = (r['unet_fails'] or r['small_fails']
                     or r['blend_small_fails'] or r['train_loss_fails']
                     or r['train_grad_fails'])
        caught[name] = bool(model and r['kernel_err'] > tol)
    ok = not any(v for k, v in sound.items() if k.endswith('_fails')) \
        and all(v for k, v in caught.items() if k not in BLIND_FAULTS)
    print(json.dumps({'ok': ok, 'unet_tol': cs.MODEL_REL_TOL,
                      'small_tol': cs.SAMPLE_REL_TOL,
                      'blend_small_tol': cs.BLEND_REL_TOL,
                      'train_loss_tol': cs.TRAIN_LOSS_TOL,
                      'train_grad_tol': cs.TRAIN_GRAD_TOL,
                      'train_update_tol': cs.TRAIN_UPDATE_TOL,
                      'train_moved_min': cs.TRAIN_MOVED_MIN,
                      'atlas_tols': {'loss': cs.ATLAS_LOSS_TOL,
                                     'grad': cs.ATLAS_GRAD_TOL,
                                     'hash_grad': cs.ATLAS_HASH_GRAD_TOL,
                                     'update': cs.ATLAS_UPDATE_TOL},
                      'sound': sound,
                      'faults': rows, 'caught': caught}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
