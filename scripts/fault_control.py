#!/usr/bin/env python3
"""Control run for the model-level limits of chip_smoke.py.

    python3 scripts/fault_control.py

Plants one fault at a time, in a kernel's wrapper (a chunk of the kernel's
work skipped), in the trainer or in the blended swap, and runs
chip_smoke.py's unet, small, train_small and blend_small comparisons (GPU
bf16 kernels against the CPU fp32 plain path; blend_small in its recompute
tier), its atlas_small comparison (GPU fp32 against CPU fp32) and its
unrouted comparisons (the two unrouted kernels on the full-width U-Net's own
level-0 and level-1 inputs against the routed computation, both on the
card; the inputs are captured once, from the sound model) with it. A sound
run comes first. For each kernel fault it also prints the
kernel-level error against the plain version at one level-0 shape, the
check of chip_smoke.py's kernels phase. The faults:

- geglu_last_chunk:   the last 128 of the 4C intermediate columns (one or
                      two steps of the kernel's chunk loop) add nothing;
- geglu_last_eighth:  the last 4C/8 intermediate columns add nothing;
- geglu_gate_small_flushed: the split route's gate pass (C > 640) writes 0
                      for every entry below 2^-4 in magnitude: a fault on
                      the small entries alone, below a limit taken relative
                      to the largest entry (1e-2 of it exceeds 2^-4 here),
                      which the gate pass's limit in bf16 ulps of each entry
                      must catch;
- temporal_last_head: the last of the 8 heads writes zeros;
- temporal_last_location: the temporal-attention kernel's output rows of
                      the last location of each of its work items' location
                      groups (`plan`'s lg whole locations, from location 0)
                      are zero: the likeliest slip of the kernel's location
                      tiling (a location dropped at the end of an item);
- flash_last_key_tile: the last 64-key tile is skipped wherever Sk > 64;
- flash_bwd_dkv_last_q_tile: the dK/dV kernel skips its last 64-query tile
                      wherever Sq > 64;
- flash_bwd_dq_last_k_tile: the dQ kernel skips its last 64-key tile
                      wherever Sk > 64;
- adapter_bf16_weights: the trainer keeps the adapter's weights and AdamW
                      state in bf16, as the models are, instead of fp32;
- hash_last_corner:   the hash-grid table-gradient kernel drops the rows
                      of the fourth cell corner (the last quarter of each
                      level's corner-major 4 x points rows);
- hash_last_block:    the same kernel drops only the rows of each level's
                      last 256-row block (the fourth corner of the last 64
                      points): a fault below what atlas_small can see,
                      which the kernel limit must catch alone;
- hash_last_level:    the same kernel drops every row of the last level of
                      a call with several levels (the all-levels call of
                      the hash encoding's backward): a slip of its
                      per-level work units;
- fused_last_head:    the fused temporal-transformer kernel's last of 8
                      heads adds nothing (its out-projection columns
                      zeroed), in both attention blocks, at C = 320 and 640;
- fused_skip_ffn:     the fused kernel's FFN half adds nothing at C = 320
                      (its second GEGLU product and bias zeroed);
- fused_last_location: the fused kernel's output rows of the last location
                      of each 64-row set (the kernel's row sets hold 64 // F
                      whole locations, in (batch, location) order in both
                      layouts) are zero, at both widths: the likeliest slip
                      of the kernel's row tiling (a location dropped at the
                      end of a tile);
- edit_cross_skipped: the prompt-to-prompt controller leaves the
                      cross-attention maps unedited (no refinement from the
                      source prompt's maps);
- blend_latents_skipped: the blended swap's latent blending is skipped (the
                      edited latents kept where the mask would put back the
                      inversion's): blend_small's exact-match check fails;
- spatial_last_key_tile: the spatial self-attention kernel skips its last
                      64-key tile wherever S > 64;
- conv_last_tap:      the fused GroupNorm-SiLU-conv kernel skips its last
                      tap, (ky, kx) = (2, 2) (its packed weights zeroed);
- conv_last_pixel_tile: the same kernel's output pixels of the last tile
                      of each image's column segments (`plan`: blocks of
                      256 virtual rows, the last one partly full) are
                      zero: the likeliest slip of the kernel's tiling (the
                      rows past the last whole tile dropped).

The last three are faults of the unrouted kernels, which no model path runs:
the unrouted limits catch them, beside the kernel limit.

The two p2p faults are faults of the blended path with no kernel:
blend_small alone can catch them, by its error against the CPU or by its
exact-match check of the latent blend (chip_smoke.BlendCheck, on a swap
run at blend threshold BLEND_CHECK_TH: where the blend mask is 0 the
blended latents equal the inversion's bit for bit). With random weights
the mask at the swap's own threshold is 1 everywhere, so skipping the
blend moves blend_small's error by only about 1e-4 of itself; the
exact-match check sees it.

The faulted wrappers call the real kernels on the GPU; CPU tensors go to
the plain versions untouched, so the CPU reference stays sound. Prints one
JSON object last; exits 0 only if the sound run passes every limit, every
forward fault fails at least one of them, every backward fault fails the
train_small gradient limit (its loss, a forward quantity, is untouched),
every kernel fault fails the kernels-phase limit, the adapter fault fails
train_small's update limits (the AdamW step's change of the weights against
the CPU's, and the share of weights it moves), the hash-corner and
hash-level faults fail atlas_small's hash-table gradient limit (the atlas's
forward and its other gradients are untouched), both p2p faults fail
blend_small's limit or its exact-match check, and the unrouted kernels'
faults fail the unrouted limits.
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


def _geglu_gate_small_flushed():
    from videoswap_torch.ops import geglu_ffn as gf
    gate = gf.geglu_gate

    def faulted(h):
        g = gate(h)
        if g.is_cuda:
            g[g.abs() < 2.0 ** -4] = 0
        return g
    return mock.patch.object(gf, 'geglu_gate', faulted)


def _temporal_last_head():
    from videoswap_torch.ops.temporal_attention import temporal_attention

    def faulted(q, k, v, heads, frames):
        out = temporal_attention(q, k, v, heads, frames)
        if out.is_cuda:
            out[:, -(out.shape[1] // heads):] = 0
        return out
    return mock.patch('videoswap_torch.ops.attention.temporal_attention',
                      faulted)


def _temporal_last_location():
    import torch

    from videoswap_torch.ops import temporal_attention as ta
    kernel = ta.temporal_attention_kernel

    def faulted(q, k, v, heads, frames):
        out = kernel(q, k, v, heads, frames)
        n = out.shape[0] // frames
        _, lg = ta.plan(frames, out.shape[1], heads)
        loc = torch.arange(n, device=out.device)
        last = (loc % lg == lg - 1) | (loc == n - 1)
        out.view(n, frames, -1)[last] = 0
        return out
    return mock.patch.object(ta, 'temporal_attention_kernel', faulted)


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


@contextlib.contextmanager
def _fused_last_location():
    """Zero the fused kernel's output rows of the last location of each
    row set (CUDA tensors only; a mask product, so autograd goes on)."""
    import torch

    from videoswap_torch.models import motion_module as mm

    def wrap(fn, bfhw):
        def faulted(g, x, pe, flat, heads, f, n_blocks=1, include_ffn=True):
            out = fn(g, x, pe, flat, heads, f, n_blocks, include_ffn)
            if not out.is_cuda:
                return out
            c = out.shape[-1]
            locs = 64 // f       # whole locations a 64-row set of the kernel
            n = out.shape[0] * out.shape[2] if bfhw else out.shape[0] // f
            keep = (torch.arange(n, device=out.device) % locs
                    != locs - 1).to(out.dtype)
            if bfhw:
                return out * keep.view(out.shape[0], 1, -1, 1)
            return (out.view(n, f, c) * keep.view(n, 1, 1)).view(-1, c)
        return faulted

    with mock.patch.object(mm, 'fused_temporal_transformer',
                           wrap(mm.fused_temporal_transformer, False)), \
            mock.patch.object(mm, 'fused_temporal_transformer_bfhw',
                              wrap(mm.fused_temporal_transformer_bfhw,
                                   True)):
        yield


def _hash_drop(rows):
    """Drop rows (index -1) in every launch of the hash kernel; `rows(idx)`
    names them in idx (L, R)."""
    from videoswap_torch.ops import hash_table_grad as hg
    launch = hg._launch_levels

    def faulted(idx, val, used, out, mode='auto'):
        idx = idx.clone()
        idx[rows(idx)] = -1
        return launch(idx, val, used, out, mode)
    return mock.patch.object(hg, '_launch_levels', faulted)


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


def _spatial_last_key_tile():
    from videoswap_torch.ops import spatial_attention as sa
    launch = sa._launch

    def faulted(q, k, v, out, heads):
        sk = k.shape[1]
        if sk > 64:
            keep = (sk - 1) // 64 * 64
            k, v = k[:, :keep], v[:, :keep]
        return launch(q, k, v, out, heads)
    return mock.patch.object(sa, '_launch', faulted)


def _conv_last_tap():
    from videoswap_torch.ops import gn_silu_conv as gc
    launch = gc._launch

    def faulted(x, scale, shift, w_packed, bias, out):
        w_packed = w_packed.clone()
        w_packed[:, 2, 2] = 0                   # (Cout, ky, kx, Cin)
        return launch(x, scale, shift, w_packed, bias, out)
    return mock.patch.object(gc, '_launch', faulted)


def _conv_last_pixel_tile():
    import torch

    from videoswap_torch.ops import gn_silu_conv as gc
    launch = gc._launch

    def faulted(x, scale, shift, w_packed, bias, out):
        launch(x, scale, shift, w_packed, bias, out)
        h, w = x.shape[1:3]
        tw, pw, segments, tiles = gc.plan(h, w)
        v = torch.arange((tiles - 1) * gc.ROWS, h * pw, device=out.device)
        y, xv = v // pw, v % pw
        for s in range(segments):
            keep = (xv < tw) & (s * tw + xv < w)
            out[:, y[keep], s * tw + xv[keep]] = 0
    return mock.patch.object(gc, '_launch', faulted)


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
    'geglu_gate_small_flushed': lambda tr: _geglu_gate_small_flushed(),
    'temporal_last_head': lambda tr: _temporal_last_head(),
    'temporal_last_location': lambda tr: _temporal_last_location(),
    'flash_last_key_tile': lambda tr: _flash_last_key_tile(),
    'flash_bwd_dkv_last_q_tile': lambda tr: _flash_bwd_dkv_last_q_tile(),
    'flash_bwd_dq_last_k_tile': lambda tr: _flash_bwd_dq_last_k_tile(),
    'adapter_bf16_weights': _adapter_bf16_weights,
    'hash_last_corner': lambda tr: _hash_drop(
        lambda idx: (slice(None), slice(idx.shape[1] * 3 // 4, None))),
    'hash_last_block': lambda tr: _hash_drop(
        lambda idx: (slice(None), slice((idx.shape[1] - 1) // 256 * 256,
                                        None))),
    'hash_last_level': lambda tr: _hash_drop(
        lambda idx: slice(idx.shape[0] - 1, None) if idx.shape[0] > 1
        else slice(0, 0)),
    'fused_last_head': lambda tr: _fused_fault('last_head'),
    'fused_skip_ffn': lambda tr: _fused_fault('skip_ffn'),
    'fused_last_location': lambda tr: _fused_last_location(),
    'edit_cross_skipped': lambda tr: _edit_cross_skipped(),
    'blend_latents_skipped': lambda tr: _blend_latents_skipped(),
    'spatial_last_key_tile': lambda tr: _spatial_last_key_tile(),
    'conv_last_tap': lambda tr: _conv_last_tap(),
    'conv_last_pixel_tile': lambda tr: _conv_last_pixel_tile(),
}
BACKWARD_FAULTS = ('flash_bwd_dkv_last_q_tile', 'flash_bwd_dq_last_k_tile')
ATLAS_FAULTS = ('hash_last_corner', 'hash_last_level')
KERNEL_ONLY_FAULTS = ('hash_last_block', 'geglu_gate_small_flushed',
                      'spatial_last_key_tile', 'conv_last_tap',
                      'conv_last_pixel_tile')
UNROUTED_FAULTS = ('spatial_last_key_tile', 'conv_last_tap',
                   'conv_last_pixel_tile')
TRAINER_FAULTS = ('adapter_bf16_weights',)
BLEND_FAULTS = ('edit_cross_skipped', 'blend_latents_skipped')


def kernel_error(fault: str) -> float:
    """max |faulted wrapper - fp32 plain| at one level-0 shape of the
    faulted kernel, as chip_smoke.py's kernels phase measures it (for the
    backward kernels and the fused temporal transformer, relative to the
    largest |plain| entry; the backward at the training step's
    self-attention shape; the gate pass at level 2's, in bf16 ulps)."""
    import torch
    import torch.nn.functional as F

    from videoswap_torch.models import layers
    from videoswap_torch.ops import attention
    from videoswap_torch.ops import flash_attention as fa
    from videoswap_torch.ops import geglu_ffn as gf
    from videoswap_torch.ops import hash_table_grad as hg
    from videoswap_torch.ops import temporal_attention as ta
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    f32 = (lambda ts: [t.float() for t in ts])
    if fault.startswith('spatial'):
        from videoswap_torch.ops import spatial_attention as sa
        q, k, v = (cs._rand(gen, (2, 4096, 320)) for _ in range(3))
        out = sa.spatial_self_attention(q, k, v, 8)
        ref = sa.spatial_attention_plain(*f32((q, k, v)), 8, 1)
        return float((out.float() - ref).abs().max())
    if fault.startswith('conv'):
        # level 0, two images, relative to the largest |plain| entry
        from videoswap_torch.ops import gn_silu_conv as gc
        x, gamma, beta, weight, bias = cs._unrouted_conv_args(gen, 64, 320)
        x = x[:2].contiguous()
        scale, shift = gc.gn_scale_shift(*gc.gn_stats(x, 32), gamma, beta)
        out = gc.gn_silu_conv_kernel(x, scale, shift, weight, bias)
        ref = gc.gn_silu_conv_plain(x.float(), scale, shift, weight.float(),
                                    bias)
        return float((out.float() - ref).abs().max() / ref.abs().max())
    if fault.startswith('hash'):
        # a main step's 16 levels in one call (as the hash encoding's
        # backward makes it) against the plain version level by level: the
        # largest error over levels, each relative to its level's largest
        # |plain| entry (chip_smoke.py's limit at one level)
        from videoswap_torch.atlas.imlp import (_level_geometry,
                                                _level_resolutions)
        res = _level_resolutions(16, 16, 1.38)
        uv = torch.rand((60000, 2), generator=gen, device='cuda') * 1.4 - 0.7
        idx, u, v, _ = _level_geometry(uv, res, 2 ** 19)
        idx = idx.to(torch.int32).reshape(16, -1)
        val = ((u * v)[..., None] * torch.randn(
            (16, 1, 60000, 2), generator=gen, device='cuda')).reshape(
            16, -1, 2).contiguous()
        used = [min((r + 1) ** 2, 2 ** 19) for r in res]
        out = hg.hash_table_grad_levels(
            idx, val, used, torch.zeros((16, 2 ** 19, 2), device='cuda'))
        errs = []
        for lv, n in enumerate(used):
            ref = hg.hash_table_grad_plain(idx[lv], val[lv], n)
            errs.append(float((out[lv, :n] - ref).abs().max()
                              / ref.abs().max()))
        return max(errs)
    if fault.startswith('fused'):
        from videoswap_torch.models import motion_module as mm
        from videoswap_torch.ops import fused_temporal as ft
        g, x, pe, flat, _ = cs._fused_inputs(gen, 2, 256, 320, True)
        g2, x2 = (ft.rows_of(t).contiguous() for t in (g, x))
        out = mm.fused_temporal_transformer(g2, x2, pe, flat, 8, cs.FRAMES)
        ref = ft.fused_temporal_plain(g2.float(), x2.float(), pe.float(),
                                      f32(flat), 8, cs.FRAMES)
        return float((out.float() - ref).abs().max() / ref.abs().max())
    if fault.startswith('geglu_gate'):
        # level 2's gate pass, in bf16 ulps of each entry of the bf16 plain
        # version (chip_smoke.py's limit); the error over the largest
        # |plain| entry is logged beside it
        c = 1280
        h = F.linear(cs._rand(gen, (8192, c)),
                     cs._rand(gen, (8 * c, c), c ** -0.5),
                     cs._rand(gen, (8 * c,), 0.1))
        out = gf.geglu_gate(h)
        ref = gf.geglu_gate_plain(h.float())
        rel = float((out.float() - ref).abs().max() / ref.abs().max())
        cs.log(f'# {fault} kernel: max err / max|plain| {rel:.3e}')
        return cs.bf16_ulps(out, gf.geglu_gate_plain(h))
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
        # the swap's level-2 shape (C = 1280, 2 x 16 x 16 locations)
        q, k, v = (cs._rand(gen, (512 * cs.FRAMES, 1280)) for _ in range(3))
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
    ref_blend, _ = cs.blend_small_run(cpu, lora, True)
    unrouted_inputs = cs.unrouted_inputs(pipe.unet)
    rows = {}
    for name, plant in FAULTS.items():
        with plant(trainer):
            loss, grad, update = cs.small_train_step(trainer, batch, draws)
            blend, _ = cs.blend_small_run(pipe, lora, True)
            _, check = cs.blend_small_run(pipe, lora, True,
                                          cs.BLEND_CHECK_TH)
            row = {'unet_rel_err': cs.rel_err(cs.unet_forward(pipe.unet),
                                              ref_unet),
                   'small_rel_err': cs.rel_err(cs.small_sample(pipe),
                                               ref_small),
                   'train_loss_rel_err': abs(loss - ref_loss) / abs(ref_loss),
                   'train_grad_rel_err': cs.rel_err(grad, ref_grad),
                   'train_update_rel_err': cs.rel_err(update, ref_update),
                   'train_moved': cs.moved_share(update),
                   'blend_small_rel_err': cs.rel_err(blend, ref_blend),
                   'blend_exact_shares': check.shares,
                   'blend_chance_shares': check.chance,
                   'blend_exact_fails': not check.ok()}
            atlas = cs.atlas_small_errors(
                cs.atlas_small_step(atlas_gpu, atlas_draws), ref_atlas)
            row.update({f'atlas_{k}_rel_err': v for k, v in atlas.items()
                        if k != 'per_net'})
            row['atlas_fails'] = sorted(
                k for k, v in cs.atlas_small_fails(atlas).items() if v)
            unrouted = cs.unrouted_module_errors(pipe.unet, unrouted_inputs)
            row.update({f'unrouted_{k.replace(" ", "_")}_rel_err': v
                        for k, v in unrouted.items()})
            row['unrouted_fails'] = cs.unrouted_fails(unrouted)
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
                  'geglu_gate': cs.TOL['geglu_gate'],
                  'geglu': cs.TOL['geglu_ffn'],
                  'temporal': cs.TOL['temporal_attention'],
                  'flash_bwd_dkv': cs.TOL['flash_attention_bwd_dkv'],
                  'flash_bwd_dq': cs.TOL['flash_attention_bwd_dq'],
                  'flash_last': cs.TOL['flash_attention_fwd'],
                  'fused': cs.TOL['fused_temporal'],
                  'spatial': cs.TOL['spatial_self_attention'],
                  'conv': cs.TOL['gn_silu_conv']}
    caught = {}
    for name, r in rows.items():
        if name in TRAINER_FAULTS:
            caught[name] = bool(r['train_update_fails'])
            continue
        if name in BLEND_FAULTS:
            caught[name] = bool(r['blend_small_fails']
                                or r['blend_exact_fails'])
            continue
        tol = next(t for key, t in kernel_tol.items()
                   if name.startswith(key))
        if name in UNROUTED_FAULTS:
            model = r['unrouted_fails']
        elif name in KERNEL_ONLY_FAULTS:
            model = True
        elif name in ATLAS_FAULTS:
            model = 'hash_grad' in r['atlas_fails']
        elif name in BACKWARD_FAULTS:
            model = r['train_grad_fails']
        else:
            model = (r['unet_fails'] or r['small_fails']
                     or r['blend_small_fails'] or r['blend_exact_fails']
                     or r['train_loss_fails'] or r['train_grad_fails'])
        caught[name] = bool(model and r['kernel_err'] > tol)
    ok = not any(v for k, v in sound.items() if k.endswith('_fails')) \
        and all(caught.values())
    print(json.dumps({'ok': ok, 'unet_tol': cs.MODEL_REL_TOL,
                      'small_tol': cs.SAMPLE_REL_TOL,
                      'blend_small_tol': cs.BLEND_REL_TOL,
                      'train_loss_tol': cs.TRAIN_LOSS_TOL,
                      'train_grad_tol': cs.TRAIN_GRAD_TOL,
                      'train_update_tol': cs.TRAIN_UPDATE_TOL,
                      'train_moved_min': cs.TRAIN_MOVED_MIN,
                      'unrouted_tols': {'spatial': cs.UNROUTED_ATTN_TOL,
                                        'conv': cs.UNROUTED_CONV_TOL},
                      'atlas_tols': {'loss': cs.ATLAS_LOSS_TOL,
                                     'grad': cs.ATLAS_GRAD_TOL,
                                     'hash_grad': cs.ATLAS_HASH_GRAD_TOL,
                                     'update': cs.ATLAS_UPDATE_TOL},
                      'sound': sound,
                      'faults': rows, 'caught': caught}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
