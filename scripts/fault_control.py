#!/usr/bin/env python3
"""Control run for the model-level limits of chip_smoke.py.

    python3 scripts/fault_control.py [--only long_video|sharded|shard_blocks]

Plants one fault at a time, in a kernel's wrapper (a chunk of the kernel's
work skipped), in the trainer, in the blended swap, on the recipe's path
(the DPM++ step, the loader, the point overlay) or in the train CLI's
resume, and runs
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
                      rows past the last whole tile dropped);
- flash_partial_block_upper_rows: the flash forward's second consumer
                      (query rows 64-127 of a 128-row block) writes nothing
                      in a last block that is partly full with more than 64
                      rows (Sq % 128 > 64). No 512x512 or 256x256 shape has
                      such a block (4096, 1024 and 256 are whole blocks, 64
                      and 16 one consumer's), so no model check of the
                      square sizes can see it, and the recipe phase's own
                      check compares the CLI with the same kernels; the
                      1009 recipe's 336- and 84-token levels do: the
                      kernels phase's check at the recipe's shapes
                      (chip_smoke.recipe_shape_kernels) must catch it.

The recipe's faults, each run against the checks of chip_smoke.py's
dpm_small and recipe phases (the 2001 DPM++ recipe through the CLI on a
synthetic experiment tree written once; the CPU's dpm_small latents taken
once):

- dpm_first_order:    every DPM-Solver++ step of a tensor on the card takes
                      the first-order update (the 2M correction skipped):
                      dpm_small's latents against the CPU's, and its step
                      check (the step on the card against its float64
                      restatement), which sees it alone where the latents'
                      limit may not;
- loader_drops_motion_module: the loader drops AnimateDiff's motion-module
                      file (its state is not merged into the U-Net's): the
                      recipe's load check (0 missing keys, every tensor as
                      written);
- vispoint_ignores_index_list: the point overlay draws every point, not the
                      swap's selection: the recipe's `_vispoint` check (the
                      2001 run's swap selects two points).

The sharded swap's faults, each planted in every rank of chip_smoke.py's
sharded phase (its spawned world and its torchrun CLI, whose ranks this
script starts under the plant with `--child-plant`) and run against that
phase's checks (`--only sharded` runs these alone, after one sound recipe
phase; `--only shard_blocks` runs the phase's building-block check alone,
sound and under each fault):

- gn_shard_stats:     the resnets' GroupNorm takes each rank's own frames'
                      statistics (no sum over sp): the phase's building
                      blocks (norm1 on a video whose frames differ in mean
                      and scale; the sample puts CFG halves, not frames, on
                      sp, and on the CLI's inversion of a clip whose frames
                      look alike it took the frames' rel L2 against the
                      unsharded run from 4.51e-2 to 4.56e-2, inside the
                      limit);
- tp_bias_every_rank: the row-parallel out-projections (to_out.0, net.2)
                      add their bias on every tp rank: the phase's building
                      blocks (biases drawn nonzero: the seeded weights
                      hold zero biases, so the sample cannot see it);
- w1_contiguous_split: net.0.proj's rows are cut as contiguous blocks of the
                      8C rows (rank 0 all of `a`, rank 1 all of the gate),
                      not as [a | gate] pairs: the sample at the tp layouts;
- blend_heads_unreduced: the blend masks' head mean is taken over the
                      rank's tp heads alone: the phase's mask check (seeded
                      maps whose heads attend to different halves; at the
                      swaps' blend threshold a random model's mask is 1
                      everywhere, so no swap of the phase can see it);
- a2a_frames_reversed: the motion modules' inverse all-to-all puts the
                      frames back in reverse order: the sample (tp splits
                      the locations) and the sharded CLI.

The sharded training paths' faults, each planted in every rank of
chip_smoke.py's sharded_train world and run against that phase's checks
(`--only sharded_train` runs these alone; the unsharded references are
taken once, the CLIs run with the sound world only); each is caught on the
CPU too (tests/test_torch_sharded_train.py::test_fault_plant_is_caught):

- column_entry_identity: the column-parallel entry's backward is the
                      identity (each tp rank's input gradient holds only
                      its own heads' and hidden units' part): the adapter
                      step's gradient at the tp meshes;
- gather_grad_summed: the gathers' backward (the motion modules' tp
                      all-gather, the U-Net exit's) sums the gradient over
                      the group instead of taking this rank's part: the
                      adapter step's gradient at the tp meshes;
- atlas_local_masked_mean: the atlas's masked means divide by the rank's
                      own mask count, not the whole batch's: the atlas's
                      loss terms at dp 2 and 4;
- lora_grad_unsummed: the LoRA factors of the cut sites keep each rank's
                      own gradient (not summed over tp): ED-LoRA's factor
                      gradients at tp 2 and 4;
- adapter_grad_counts_replicas: the adapter's gradient is summed over
                      every rank of the mesh, replicated copies included
                      (tp ranks, the rows of a batch of 1 on dp ranks): the
                      adapter step's gradient at (2,1,1) B = 1 and the tp
                      meshes.

The train CLI's fault, run against the checks of chip_smoke.py's
train_recipe phase (the 2001 training config, 2 steps, then --resume to 4,
in the same tree):

- resume_fresh_adamw: --resume restores the adapter and the step from the
                      train state but starts a fresh AdamW (its moments and
                      step counts lost): train_recipe's resume check (the
                      resumed run's adapter and AdamW state against the
                      saved ones, bit for bit).

The shape-change chain's faults, each run against the checks of
chip_smoke.py's atlas_recipe phase at its own depth (the three atlas CLIs
on options/train_atlas/atlas_swan.yml; about three minutes a run: a
shallower atlas leaves the dragged points where alpha <= 0.5, and then the
propagated tracks cannot show a fault of the drag):

- propagate_ignores_drag: the propagate CLI moves each point to where it
                      is (the target points replaced by the source's):
                      the TAP file against a direct propagation;
- card_drag_doubled:  propagation through nets on the card applies each
                      drag at twice its length (the CLI and the direct
                      call alike): the TAP file against the propagation
                      through the nets moved to the CPU;
- checkpoint_before_training: the train CLI saves the nets as they were
                      built, before pretraining and training: the
                      checkpoint reloaded against the trained nets;
- backward_flow_negated: the extract_flow CLI writes the forward flow
                      negated as the backward flow: the CLI's file
                      against compute_bidirectional_flow called directly;
- cli_skips_inverse_step: the train CLI's iterations take the main step
                      alone: its logged losses against a direct
                      AtlasTrainer's;
- box_filter_tf32:    the 7x7 box filter of the matching flow's candidate
                      choice reads its inputs at TF32 precision (10
                      mantissa bits, what a TF32 convolution would read)
                      on the card: the box filter on the card against the
                      CPU (the flows themselves moved too little: 2.4e-4
                      more of the pixels by more than 0.01 px).

The semantic-point faults, each run against the card's side of
chip_smoke.py's semantic_points checks (sp_card_checks: the phase's sound
run first, its CPU references taken once, in the recipe phase's tree).
Each is planted on the card alone: a fault of the code that both devices
run would reach the CPU's references too, where a check of the card
against the CPU cannot see it. The checks named for the first three see
the fault in either place (two read the card alone, the draw's compares
the card's second call with the CPU's first); the bilinear map resize in
the shared code is a fault that the CPU tests catch against the JAX
package, as they catch the first three
(tests/test_torch_dift.py::test_up_block_1_tap_matches_jax and
::test_featurizer_matches_jax_given_its_draw, the tap;
::test_featurizer_draws_the_same_noise_at_every_call, the draw;
tests/test_torch_cotracker.py::test_predictor_matches_jax, the backward
run; tests/test_torch_pose.py::test_maps_match_jax and
::test_cubic_resize_is_jaxs, the resize), and TF32 exists only on the
card:

- dift_tap_up_block_0: the featurizer on the card returns the up_block_0
                      tap instead of up_block_1: the features' shape
                      against the up_block_1 tap's (the card alone);
- dift_fresh_noise_per_frame: the featurizer on the card draws its noise
                      from a generator that goes on from call to call (each
                      frame its own draw): the features of its second call
                      against the CPU's first (so also where the CPU's draw
                      goes on);
- cotracker_no_backward: CoTracker on the card skips the backward run on
                      the reversed video (the frames before a query keep
                      their zeros): those frames' tracks filled (the card
                      alone);
- pose_bilinear_maps: OpenPose on the card resizes its maps with the
                      antialiased bilinear filter instead of the cubic one:
                      its maps against the CPU's;
- cotracker_tf32:     CoTracker on the card runs with TF32 products and
                      convolutions: its tracks against the CPU's.

The ED-LoRA path's and the swap CLI's new faults, each planted on the card
alone and run against the card's side of the check named for it (the
CPU's references taken once: edlora_small's loss and gradients, the swap
CLI's CLIP scorer's embeddings and scores of a synthetic 16-frame clip):

- merge_drops_alpha:  the ED-LoRA trainer's merge on the card adds
                      up @ down without alpha (edlora_small runs at alpha
                      0.7 with non-zero factors): edlora_small's loss and
                      gradients against the CPU's;
- global_grad_clip:   the ED-LoRA trainer's update on the card clips every
                      gradient by one global norm instead of each group by
                      its own: edlora_small's update check (the trainer's
                      two updates against the restated optax, both groups
                      above the clip norm);
- clip_unnormalised:  the CLIP scorer's preprocessing on the card skips
                      the openai normalisation: clip_attn's embeddings and
                      scores against the CPU's;
- attn_sums_not_divided: the attention dump on the card shows the edit's
                      summed maps without dividing them by the step count:
                      clip_attn's check of the summed maps (probabilities
                      whose rows sum to 1).

The long-video path's and the recompute modes' faults, each run against
the check named for it (chip_smoke.py's long_video module checks on a
windowed U-Net holding the smoke pipeline's weights: each level's module on
the card against its fp32 restatement with the plain versions, level 0 also
at a stride with a flush window, stride == window against the chunked
window-free module, two runs; and the train phase's recompute A/B):

- window_average_undivided: the windows' sum is not divided by each
                      frame's window count (the average divided by 1):
                      long_video's module check;
- window_pe_shifted:  each window adds the position table's rows of its
                      own frames, pe[s:s+w], in place of pe[:w]:
                      long_video's module check and its stride == window
                      identity;
- window_flush_dropped: window_index drops the last window where it is a
                      flush window (its start not a stride after the one
                      before): the frames after the last whole stride have
                      no window (long_video's module check at
                      LONG_FLUSH_STRIDE: not finite);
- save_flash_recomputes: the 'save_flash' policy recomputes the flash
                      forward too (it saves nothing): the recompute A/B's
                      launch count, which must be the layout's.

The last three of the kernel faults are faults of the unrouted kernels,
which no model path runs:
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
blend_small's limit or its exact-match check, the unrouted kernels'
faults fail the unrouted limits, the sound recipe run passes dpm_small's
and the recipe's checks, and each recipe fault fails the check named for
it above; the sound train-recipe run passes train_recipe's checks and
resume_fresh_adamw fails its resume check; the sound run passes the kernels phase's check at the recipe's
shapes, and flash_partial_block_upper_rows fails it; the sound atlas
recipe passes atlas_recipe's checks and each of its faults fails the check
named for it; the sound semantic_points run passes its checks and each
semantic-point fault fails the check named for it; the sound ED-LoRA,
CLIP and attention checks pass and each of their faults fails the check
named for it; the sound long-video and recompute checks pass and each of
their faults fails the check named for it. `--only long_video` runs that
group alone (about two minutes).
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


def _flash_partial_block_upper_rows():
    from videoswap_torch.ops import flash_attention as fa
    kernel = fa.flash_attention_kernel

    def faulted(q, k, v):
        out, lse = kernel(q, k, v)
        sq = q.shape[1]
        if sq % 128 > 64:
            out[:, sq // 128 * 128 + 64:] = 0
        return out, lse
    return mock.patch.object(fa, 'flash_attention_kernel', faulted)


def recipe_shapes_error(fault: str) -> str:
    """The kernels phase's check at the recipe's shapes with the fault
    planted: its error message, or '' when it passes."""
    import torch
    gen = torch.Generator(device='cuda').manual_seed(cs.SEED)
    with FAULTS[fault](None):
        try:
            cs.recipe_shape_kernels({'kernels': {}}, gen)
        except cs.PhaseError as e:
            return str(e)
    return ''


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
def _dpm_first_order():
    from videoswap_torch.pipelines import videoswap_pipeline as vp
    from videoswap_torch.schedulers import dpm
    step = dpm.dpm_pp_2m_step

    def faulted(sched, model_output, t, sample, prev_x0, step_index, n):
        if sample.is_cuda:
            step_index = 0                      # D = x0: first order
        return step(sched, model_output, t, sample, prev_x0, step_index, n)
    with mock.patch.object(dpm, 'dpm_pp_2m_step', faulted), \
            mock.patch.object(vp, 'dpm_pp_2m_step', faulted):
        yield


def _loader_drops_motion_module():
    from videoswap_torch.models import converters
    return mock.patch.object(converters, 'merge_motion_module',
                             lambda unet_sd, motion_sd: dict(unet_sd))


@contextlib.contextmanager
def _vispoint_ignores_index_list():
    from videoswap_torch.pipelines import videoswap_pipeline as vp
    from videoswap_torch.utils import vis_util
    draw = vis_util.overlay_points

    def faulted(frames, tap_dict, *args, **kwargs):
        return draw(frames, dict(tap_dict, index_list=None), *args, **kwargs)
    with mock.patch.object(vis_util, 'overlay_points', faulted), \
            mock.patch.object(vp, 'overlay_points', faulted):
        yield


@contextlib.contextmanager
def _resume_fresh_adamw():
    from videoswap_torch import builders
    from videoswap_torch import train as train_cli
    from videoswap_torch.models import converters

    def faulted(path, adapter, optimizer):
        state = converters.load_torch_file(path)
        adapter.load_state_dict(state['adapter'], strict=True)
        return int(state['global_step'])
    with mock.patch.object(builders, 'load_train_state', faulted), \
            mock.patch.object(train_cli, 'load_train_state', faulted):
        yield


@contextlib.contextmanager
def _propagate_ignores_drag():
    from videoswap_torch import propagate_point_displacement as ppd
    real = ppd.propagate_point_sequence

    def faulted(source, target, *args):
        return real(source, {n: source[n] for n in target}, *args)
    with mock.patch.object(ppd, 'propagate_point_sequence', faulted):
        yield


@contextlib.contextmanager
def _card_drag_doubled():
    from videoswap_torch import propagate_point_displacement as ppd
    from videoswap_torch.atlas import propagate
    real_bind, real_point = propagate.bind_nets, propagate.propagate_point
    card = []

    def bind(nets):
        fns = real_bind(nets)
        if nets['FG_UV_Mapping'].hidden_0.weight.is_cuda:
            card.append(fns[0])
        return fns

    def point(x, y, tx, ty, t, n, fg_map, *args):
        if any(fg_map is f for f in card):
            tx, ty = 2 * tx - x, 2 * ty - y
        return real_point(x, y, tx, ty, t, n, fg_map, *args)
    with mock.patch.object(propagate, 'bind_nets', bind), \
            mock.patch.object(ppd, 'bind_nets', bind), \
            mock.patch.object(propagate, 'propagate_point', point):
        yield


@contextlib.contextmanager
def _checkpoint_before_training():
    import copy

    from videoswap_torch import train_atlas
    build = train_atlas.build_atlas_nets
    save = train_atlas.save_atlas_checkpoint
    built = {}

    def keep(*args, **kwargs):
        nets = build(*args, **kwargs)
        built['nets'] = copy.deepcopy(nets)
        return nets
    with mock.patch.object(train_atlas, 'build_atlas_nets', keep), \
            mock.patch.object(train_atlas, 'save_atlas_checkpoint',
                              lambda path, nets: save(path, built['nets'])):
        yield


@contextlib.contextmanager
def _backward_flow_negated():
    from videoswap_torch import extract_flow
    real = extract_flow.compute_bidirectional_flow

    def faulted(*args, **kwargs):
        flow = real(*args, **kwargs)
        flow[1] = -flow[0]
        return flow
    with mock.patch.object(extract_flow, 'compute_bidirectional_flow',
                           faulted):
        yield


@contextlib.contextmanager
def _cli_skips_inverse_step():
    from videoswap_torch.atlas.trainer import AtlasTrainer

    def faulted(self, start_step, n, generator):
        ld = {}
        for it in range(start_step + 1, start_step + n + 1):
            ld = self.step(it, generator)
        return ld
    with mock.patch.object(AtlasTrainer, 'run_steps', faulted):
        yield


@contextlib.contextmanager
def _box_filter_tf32():
    import torch

    from videoswap_torch.preprocess import matching_flow
    real = matching_flow.box_filter

    def faulted(x, k):
        if x.is_cuda:       # TF32 keeps 10 of fp32's 23 mantissa bits
            x = (x.view(torch.int32) & ~0x1FFF).view(torch.float32)
        return real(x, k)
    with mock.patch.object(matching_flow, 'box_filter', faulted):
        yield


@contextlib.contextmanager
def _dift_tap_up_block_0():
    from videoswap_torch.preprocess import dift
    real = dift.SDFeaturizer.forward

    def faulted(self, image, prompt, noise=None):
        if self.device.type != 'cuda':
            return real(self, image, prompt, noise)
        with mock.patch.object(dift, 'TAP', 'up_block_0'):
            return real(self, image, prompt, noise)
    with mock.patch.object(dift.SDFeaturizer, 'forward', faulted):
        yield


@contextlib.contextmanager
def _dift_fresh_noise_per_frame():
    import torch

    from videoswap_torch.preprocess import dift
    real = dift.SDFeaturizer.forward
    gens = {}

    def faulted(self, image, prompt, noise=None):
        if self.device.type == 'cuda' and noise is None:
            gen = gens.setdefault(id(self),
                                  torch.Generator().manual_seed(
                                      dift.NOISE_SEED))
            noise = torch.randn(self.noise_shape(tuple(image.shape[:2])),
                                generator=gen)
        return real(self, image, prompt, noise)
    with mock.patch.object(dift.SDFeaturizer, 'forward', faulted):
        yield


@contextlib.contextmanager
def _cotracker_no_backward():
    from videoswap_torch.preprocess import cotracker_native as cn
    real = cn.NativeCoTrackerPredictor.__call__

    def faulted(self, video, queries, backward_tracking=True):
        return real(self, video, queries,
                    backward_tracking and self.device.type != 'cuda')
    with mock.patch.object(cn.NativeCoTrackerPredictor, '__call__',
                           faulted):
        yield


@contextlib.contextmanager
def _pose_bilinear_maps():
    import torch.nn.functional as F

    from videoswap_torch.preprocess import pose
    real = pose.resize_cubic

    def faulted(x, out_h, out_w):
        if not x.is_cuda or x.shape[-1] == 3:      # the maps, not the input
            return real(x, out_h, out_w)
        lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
        y = F.interpolate(x.reshape(-1, h, w, c).permute(0, 3, 1, 2),
                          size=(out_h, out_w), mode='bilinear',
                          align_corners=False, antialias=True)
        return y.permute(0, 2, 3, 1).reshape(*lead, out_h, out_w, c)
    with mock.patch.object(pose, 'resize_cubic', faulted):
        yield


@contextlib.contextmanager
def _cotracker_tf32():
    import torch

    from videoswap_torch.preprocess import cotracker_native as cn

    @contextlib.contextmanager
    def tf32():
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
    with mock.patch.object(cn, 'fp32_math', tf32):
        yield


@contextlib.contextmanager
def _merge_drops_alpha():
    from videoswap_torch import edlora_train as et
    real = et.merge_lora

    def faulted(frozen, lora_params, sites, alpha, slicers=None):
        on_card = any(p['up'].is_cuda for p in lora_params.values())
        return real(frozen, lora_params, sites, 1.0 if on_card else alpha,
                    slicers)
    with mock.patch.object(et, 'merge_lora', faulted):
        yield


@contextlib.contextmanager
def _global_grad_clip():
    from videoswap_torch import edlora_train as et
    real = et.EDLoRATrainer.update

    def faulted(self, optimizer):
        if not self.max_grad_norm or self.device.type != 'cuda':
            return real(self, optimizer)
        et.clip_by_global_norm_(
            [p.grad for g in optimizer.param_groups for p in g['params']
             if p.grad is not None], float(self.max_grad_norm))
        optimizer.step()
    with mock.patch.object(et.EDLoRATrainer, 'update', faulted):
        yield


@contextlib.contextmanager
def _clip_unnormalised():
    import torch

    from videoswap_torch.models import clip_vision as cv
    real = cv.preprocess_frames

    def faulted(frames, image_size=224, device=None):
        out = real(frames, image_size, device)
        if not out.is_cuda:
            return out
        mean = torch.tensor(cv.CLIP_IMAGE_MEAN, device=out.device)
        std = torch.tensor(cv.CLIP_IMAGE_STD, device=out.device)
        return out * std + mean
    with mock.patch.object(cv, 'preprocess_frames', faulted):
        yield


@contextlib.contextmanager
def _attn_sums_not_divided():
    from videoswap_torch.pipelines import VideoSwapPipeline
    real = VideoSwapPipeline._dump_attention_maps

    def faulted(self, *args, **kw):
        if kw.get('attn_sums') and self.device.type == 'cuda':
            kw['num_steps'] = 1
        return real(self, *args, **kw)
    with mock.patch.object(VideoSwapPipeline, '_dump_attention_maps',
                           faulted):
        yield


@contextlib.contextmanager
def _window_average_undivided():
    import numpy as np

    from videoswap_torch.models import motion_module as mm
    with mock.patch.object(mm, 'window_weights',
                           lambda idx, f: np.ones((f,), np.float32)):
        yield


@contextlib.contextmanager
def _window_pe_shifted():
    import torch

    from videoswap_torch.models import motion_module as mm

    def faulted(self, h, starts, w):
        table = torch.from_numpy(mm.sinusoidal_position_table(
            h.shape[1], h.shape[-1])).to(h.device, h.dtype)
        hw = torch.stack([h[:, s:s + w] + table[s:s + w] for s in starts],
                         dim=1)
        return hw.reshape(-1, w, h.shape[-1])
    with mock.patch.object(mm.TemporalTransformerBlock, 'windows', faulted):
        yield


@contextlib.contextmanager
def _window_flush_dropped():
    from videoswap_torch.models import motion_module as mm
    real = mm.window_index

    def faulted(f, window, stride):
        idx = real(f, window, stride)
        flush = len(idx) > 1 and idx[-1, 0] - idx[-2, 0] != stride
        return idx[:-1] if flush else idx
    with mock.patch.object(mm, 'window_index', faulted):
        yield


@contextlib.contextmanager
def _save_flash_recomputes():
    from torch.utils.checkpoint import CheckpointPolicy

    from videoswap_torch.models import unet3d
    with mock.patch.object(unet3d, '_save_flash_policy',
                           lambda *a, **k: CheckpointPolicy.PREFER_RECOMPUTE):
        yield


@contextlib.contextmanager
def _gn_shard_stats():
    from videoswap_torch.parallel import sharding
    with mock.patch.object(sharding, 'stats_group', lambda: None):
        yield


@contextlib.contextmanager
def _tp_bias_every_rank():
    from videoswap_torch.parallel import sharding
    with mock.patch.object(sharding, 'bias_on_rank', lambda b, t: b):
        yield


@contextlib.contextmanager
def _w1_contiguous_split():
    import torch

    from videoswap_torch.parallel import sharding

    def faulted(inner, t, tp):
        n = 2 * inner // tp
        return torch.arange(t * n, (t + 1) * n)
    with mock.patch.object(sharding, 'geglu_rows', faulted):
        yield


@contextlib.contextmanager
def _blend_heads_unreduced():
    from videoswap_torch.parallel import sharding
    with mock.patch.object(sharding, 'head_sum',
                           lambda x, dim: (x.float().sum(dim), x.shape[dim])):
        yield


@contextlib.contextmanager
def _a2a_frames_reversed():
    from videoswap_torch.parallel import sharding
    real = sharding.locations_to_frames
    with mock.patch.object(sharding, 'locations_to_frames',
                           lambda y, split, el: real(y.flip(1), split, el)):
        yield


# the sharded swap's faults -> context managers planting them (in every
# rank), and the check of chip_smoke.py's sharded phase that must catch each
SHARD_FAULTS = {
    'sound': (contextlib.nullcontext, None),
    'gn_shard_stats': (_gn_shard_stats, 'blocks:'),
    'tp_bias_every_rank': (_tp_bias_every_rank, 'blocks:'),
    'w1_contiguous_split': (_w1_contiguous_split, 'sample'),
    'blend_heads_unreduced': (_blend_heads_unreduced, 'mask:'),
    'a2a_frames_reversed': (_a2a_frames_reversed, 'sample'),
}


@contextlib.contextmanager
def _column_entry_identity():
    from videoswap_torch.parallel import sharding
    with mock.patch.object(sharding, 'copy_to_tp', lambda x, group: x):
        yield


@contextlib.contextmanager
def _gather_grad_summed():
    from videoswap_torch.parallel import sharding

    def faulted(g, group, part):
        return part(sharding._sum(g, group, backward=True))
    with mock.patch.object(sharding, 'gather_backward', faulted):
        yield


@contextlib.contextmanager
def _atlas_local_masked_mean():
    from videoswap_torch.atlas import losses
    with mock.patch.object(losses, 'global_count', lambda m: m.sum()):
        yield


@contextlib.contextmanager
def _lora_grad_unsummed():
    from videoswap_torch import edlora_train as et
    with mock.patch.object(et, 'factor_axes', lambda site, slicers: ()):
        yield


@contextlib.contextmanager
def _adapter_grad_counts_replicas():
    from videoswap_torch.parallel import sharding
    from videoswap_torch.pipelines import trainer as tr

    def faulted(self, batch):
        if self.mesh is not None:
            sharding.reduce_gradients(self.adapter.parameters(), self.mesh,
                                      ('dp', 'sp', 'tp'))
    with mock.patch.object(tr.VideoSwapTrainer, 'reduce_gradients',
                           faulted):
        yield


# the sharded training paths' faults -> context managers planting them (in
# every rank), and the check of chip_smoke.py's sharded_train phase that
# must catch each (tests/test_torch_sharded_train.py catches each on the
# CPU too)
TRAIN_FAULTS = {
    'sound': (contextlib.nullcontext, None),
    'column_entry_identity': (_column_entry_identity, 'adapter'),
    'gather_grad_summed': (_gather_grad_summed, 'adapter'),
    'atlas_local_masked_mean': (_atlas_local_masked_mean, 'atlas'),
    'lora_grad_unsummed': (_lora_grad_unsummed, 'edlora'),
    'adapter_grad_counts_replicas': (_adapter_grad_counts_replicas,
                                     'adapter'),
}


def shard_cli_command(plant: str):
    """chip_smoke.sharded_cli_command with `plant` entered in every rank
    (this script's --child-plant mode runs the swap CLI under it)."""
    real = cs.sharded_cli_command     # before shard_rows patches it

    def command(yml, shape):
        cmd = real(yml, shape)
        i = cmd.index('-m', 3)
        return cmd[:i] + [str(Path(__file__).resolve()), '--child-plant',
                          plant] + cmd[i + 2:]
    return command


def shard_rows(state) -> dict:
    """The sound sharded phase, then each fault of SHARD_FAULTS planted in
    every rank of its world and of its torchrun CLI: {fault: readings and
    the checks that failed ('sample', 'mask:', 'cli')}."""
    import torch
    rows = {}
    for name, (_, check) in SHARD_FAULTS.items():
        plant = None if name == 'sound' else name
        cmd = (cs.sharded_cli_command if plant is None
               else shard_cli_command(plant))
        with mock.patch.object(cs, 'sharded_cli_command', cmd):
            r, cli, fails = cs.sharded_run(state, plant)
        torch.cuda.empty_cache()
        kinds = sorted({f.split(' ')[0] for f in fails})
        rows[name] = {'sample_rel_err': {k: v['rel_err'] for k, v in
                                         r['layouts'].items()},
                      'mask_differ': r['mask_differ'],
                      'cli_rel_err': cli.get('rel_err'),
                      'fails': fails, 'checks': kinds}
        cs.log(f'# sharded {name}: {json.dumps(rows[name])}')
    return rows


def shard_block_rows() -> dict:
    """chip_smoke.py's sharded building blocks alone (a world of its
    ranks), sound and under each fault of SHARD_FAULTS: {fault: the errors
    by rank and the checks that failed}."""
    rows = {}
    for name in SHARD_FAULTS:
        plant = None if name == 'sound' else name
        blocks = [r['blocks'] for r in
                  cs.run_shard_world(plant, blocks_only=True)]
        fails = cs.shard_block_fails(blocks)
        rows[name] = {'blocks': blocks, 'fails': fails,
                      'checks': sorted({f.split(' ')[0] for f in fails})}
        cs.log(f'# sharded blocks {name}: {json.dumps(rows[name])}')
    return rows


def shard_caught(rows: dict) -> tuple[bool, dict]:
    rows = dict(rows)
    sound = rows.pop('sound')
    return (not sound['fails'],
            {name: SHARD_FAULTS[name][1] in row['checks']
             for name, row in rows.items()})


def train_shard_rows(state) -> dict:
    """chip_smoke.py's sharded_train phase, sound (with its CLIs) and with
    each fault of TRAIN_FAULTS planted in every rank of its world, against
    one set of unsharded references: {fault: readings and the checks that
    failed ('adapter', 'edlora', 'atlas', 'cli')}."""
    import torch
    ref = cs.train_shard_references()
    rows = {}
    for name in TRAIN_FAULTS:
        plant = None if name == 'sound' else name
        r, fails = cs.sharded_train_run(state, plant, ref)
        torch.cuda.empty_cache()
        rows[name] = {
            'cases': {k: {m: c[m] for m in ('loss', 'grad', 'errors',
                                            'same_bits') if m in c}
                      for k, c in r['cases'].items()},
            'fails': fails,
            'checks': sorted({f.split(':')[0].split(' ')[0] for f in fails})}
        cs.log(f'# sharded_train {name}: {json.dumps(rows[name])}')
    return rows


def train_shard_caught(rows: dict) -> tuple[bool, dict]:
    rows = dict(rows)
    sound = rows.pop('sound')
    return (not sound['fails'],
            {name: TRAIN_FAULTS[name][1] in row['checks']
             for name, row in rows.items()})


# the long-video and recompute faults -> context managers planting them,
# and the check that must catch each
LONG_VIDEO_FAULTS = {
    'sound': (contextlib.nullcontext, None),
    'window_average_undivided': (_window_average_undivided, 'long_video'),
    'window_pe_shifted': (_window_pe_shifted, 'long_video'),
    'window_flush_dropped': (_window_flush_dropped, 'long_video'),
    'save_flash_recomputes': (_save_flash_recomputes, 'train_remat'),
}


def long_video_rows(pipe) -> dict:
    """The sound run, then each fault of LONG_VIDEO_FAULTS, against the
    long_video phase's module checks (the windowed modules of a U-Net on
    `pipe`'s weights against their fp32 restatement, the stride == window
    identity, two runs) and the train phase's recompute A/B (launches
    against the layout's, gradients against True's): {fault: readings and
    the checks that failed}."""
    import torch
    unet = cs.long_video_unet(pipe.unet)
    trainer = cs.make_trainer(pipe)
    batch = cs.full_train_batch(trainer)
    draws = cs.remat_draws(trainer, batch)
    expected = cs.flash_launches_expected(trainer.unet, cs.SIZE // 8)
    rows = {}
    for name, (plant, _) in LONG_VIDEO_FAULTS.items():
        with plant():
            errs = cs.long_video_module_errors(unet)
            ab = cs.remat_ab_readings(cs.remat_ab(trainer, batch, draws),
                                      expected)
        torch.cuda.empty_cache()
        fails = ((['long_video'] if cs.long_video_fails(errs) else [])
                 + (['train_remat'] if cs.remat_ab_fails(ab) else []))
        rows[name] = {'long_video': errs, 'train_remat': {
            'spread': ab['spread'],
            'modes': [{k: m[k] for k in ('mode', 'flash_launches',
                                         'expected_launches', 'grad_vs_true')}
                      for m in ab['modes']]}, 'fails': fails}
        cs.log(f'# long_video/remat {name}: {json.dumps(rows[name])}')
    return rows


# the ED-LoRA, CLIP and attention faults -> context managers planting
# them, and the check that must catch each
EDLORA_FAULTS = {
    'sound': (contextlib.nullcontext, None),
    'merge_drops_alpha': (_merge_drops_alpha, 'edlora_small'),
    'global_grad_clip': (_global_grad_clip, 'edlora_small update'),
    'clip_unnormalised': (_clip_unnormalised, 'clip'),
    'attn_sums_not_divided': (_attn_sums_not_divided, 'attention'),
}


def edlora_clip_attn_rows(pipe) -> dict:
    """The sound run, then each fault of EDLORA_FAULTS, against
    edlora_small's checks, clip_attn's CLIP checks (the ViT-L/14 scorer on
    a synthetic 16-frame 512x512 clip) and its check of the summed
    attention maps (blend_small's swap): {fault: readings and the checks
    that failed}."""
    import os
    import tempfile

    import torch

    s = cs.edlora_small_setup()
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        inputs = cs.clip_inputs({}, d)
        ref = cs.clip_readings(cs.clip_scorer(inputs, 'cpu'), inputs)
        gpu_scorer = cs.clip_scorer(inputs, 'cuda')
        lora = os.path.join(d, 'edlora_hermione.pth')
        cs.edlora_file(pipe, lora)
        for name, (plant, _) in EDLORA_FAULTS.items():
            with plant():
                e = cs.edlora_small_errors(s['gpu'], s['cpu_ref'],
                                           s['inputs'])
                c = cs.clip_errors(gpu_scorer, inputs, ref)
                a = cs.attn_dump_run(pipe, lora, os.path.join(d, name))
            torch.cuda.empty_cache()
            small = cs.edlora_small_fails(e)
            fails = ((['edlora_small'] if set(small) - {'update'} else [])
                     + (['edlora_small update'] if 'update' in small else [])
                     + (['clip'] if cs.clip_fails(c) else [])
                     + (['attention'] if cs.attn_dump_fails(a) else []))
            rows[name] = {'edlora_small': e, 'clip': c,
                          'attn_row_err': cs.attn_row_error(a['maps']),
                          'fails': fails}
            cs.log(f'# edlora/clip/attention {name}: '
                   f'{json.dumps(rows[name])}')
    return rows


# the semantic-point faults -> context managers planting them, and the
# semantic_points check that must catch each
SP_FAULTS = {
    'dift_tap_up_block_0': (_dift_tap_up_block_0, 'features shape'),
    'dift_fresh_noise_per_frame': (_dift_fresh_noise_per_frame,
                                   'features card vs CPU'),
    'cotracker_no_backward': (_cotracker_no_backward,
                              'cotracker backward run'),
    'pose_bilinear_maps': (_pose_bilinear_maps, 'pose card vs CPU'),
    'cotracker_tf32': (_cotracker_tf32, 'cotracker card vs CPU'),
}


def semantic_point_rows(tree: Path, pipe) -> dict:
    """The sound semantic_points run in `tree`, then each semantic-point
    fault against the card's side of its checks (the CPU's side taken once,
    by the sound run): {fault: readings and the checks that failed}."""
    import tempfile

    import torch
    with tempfile.TemporaryDirectory() as d:
        r = cs.semantic_points_run(tree, Path(d), pipe)
        rows = {'sound': {'card': r['card'], 'tracker_px': r['tracker_px'],
                          'standin_px': r['standin_px'],
                          'semantic_points_fails':
                              cs.semantic_points_fails(r)}}
        cs.log(f'# semantic_points sound: {json.dumps(rows["sound"])}')
        for name, (plant, _) in SP_FAULTS.items():
            with plant():
                c = cs.sp_card_checks(r['inputs'], r['refs'])
            torch.cuda.empty_cache()
            rows[name] = {**c, 'semantic_points_fails': cs.sp_card_fails(c)}
            cs.log(f'# semantic_points {name}: {json.dumps(rows[name])}')
    return rows


# the shape-change chain's faults -> context managers planting them, and
# the atlas_recipe check that must catch each
ATLAS_RECIPE_FAULTS = {
    'sound': (contextlib.nullcontext, None),
    'propagate_ignores_drag': (_propagate_ignores_drag, 'TAP vs direct'),
    'card_drag_doubled': (_card_drag_doubled, 'TAP vs CPU'),
    'checkpoint_before_training': (_checkpoint_before_training,
                                   'checkpoint'),
    'backward_flow_negated': (_backward_flow_negated,
                              'flow file vs direct call'),
    'cli_skips_inverse_step': (_cli_skips_inverse_step, 'CLI vs direct'),
    'box_filter_tf32': (_box_filter_tf32, 'flow card vs CPU'),
}


def atlas_recipe_rows() -> dict:
    """Each atlas-recipe fault (and the sound run) against atlas_recipe's
    checks, each in a tree of its own: {fault: readings and the checks
    that failed}."""
    import tempfile

    import torch
    rows = {}
    for name, (plant, _) in ATLAS_RECIPE_FAULTS.items():
        with tempfile.TemporaryDirectory() as d, plant():
            r = cs.atlas_recipe_run(Path(d))
        torch.cuda.empty_cache()
        rows[name] = {'flow_shift': r['flow_shift'],
                      'flow_file_differs': r['flow_file_differs'],
                      'flow_device': r['flow_device'],
                      'cli_vs_direct': r['cli_vs_direct'],
                      'checkpoint_differs': len(r['checkpoint_differs']),
                      'psnr': [r['validation'][r['iters']]['psnr'],
                               r['psnr_reloaded']],
                      'tap': r['tap'],
                      'atlas_recipe_fails': cs.atlas_recipe_fails(r)}
        cs.log(f'# atlas_recipe {name}: {json.dumps(rows[name])}')
    return rows


# the train CLI's faults -> context managers planting them
TRAIN_RECIPE_FAULTS = {
    'sound': contextlib.nullcontext,
    'resume_fresh_adamw': _resume_fresh_adamw,
}

# the recipe's faults -> context managers planting them
RECIPE_FAULTS = {
    'sound': contextlib.nullcontext,
    'dpm_first_order': _dpm_first_order,
    'loader_drops_motion_module': _loader_drops_motion_module,
    'vispoint_ignores_index_list': _vispoint_ignores_index_list,
}


def recipe_rows(pipe, cpu) -> dict:
    """Each recipe fault (and the sound run) against dpm_small's checks and
    the 2001 recipe's, then each train-recipe fault (and the sound run)
    against train_recipe's, then the semantic-point faults
    (semantic_point_rows), in the same tree; {fault: readings and the
    checks that failed}, the train recipe's under 'train_recipe', the
    semantic points' under 'semantic_points'."""
    import tempfile

    import torch
    ref = cs.small_sample(cpu, 'dpmpp_2m', cs.DPM_STEPS)
    rows = {}
    with tempfile.TemporaryDirectory() as d:
        tree = Path(d)
        written = cs.make_recipe_tree(pipe, tree)
        for name, plant in RECIPE_FAULTS.items():
            with plant():
                dpm = cs.dpm_small_errors(pipe, ref=ref)
                r = cs.recipe_run('2001', tree, written)
            torch.cuda.empty_cache()
            rows[name] = {'dpm_small': dpm,
                          'dpm_small_fails': cs.dpm_small_fails(dpm),
                          'recipe_load': r['load'],
                          'recipe_rel_err': r['rel_err'],
                          'recipe_vispoint': r['vispoint'],
                          'recipe_fails': cs.recipe_fails(r)}
            cs.log(f'# {name}: {json.dumps(rows[name])}')
        rows['train_recipe'] = {}
        for name, plant in TRAIN_RECIPE_FAULTS.items():
            with plant():
                r = cs.train_recipe_run(tree)
            torch.cuda.empty_cache()
            row = {k: r[k] for k in ('start_step', 'resume_differences',
                                     'losses', 'moved', 'cli_vs_direct',
                                     'direct_spread')}
            row['train_recipe_fails'] = cs.train_recipe_fails(r)
            row['resume_differences'] = row['resume_differences'][:8]
            rows['train_recipe'][name] = row
            cs.log(f'# train_recipe {name}: {json.dumps(row)}')
        rows['semantic_points'] = semantic_point_rows(tree, pipe)
    return rows


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
    'flash_partial_block_upper_rows':
        lambda tr: _flash_partial_block_upper_rows(),
}
BACKWARD_FAULTS = ('flash_bwd_dkv_last_q_tile', 'flash_bwd_dq_last_k_tile')
ATLAS_FAULTS = ('hash_last_corner', 'hash_last_level')
KERNEL_ONLY_FAULTS = ('hash_last_block', 'geglu_gate_small_flushed',
                      'spatial_last_key_tile', 'conv_last_tap',
                      'conv_last_pixel_tile')
UNROUTED_FAULTS = ('spatial_last_key_tile', 'conv_last_tap',
                   'conv_last_pixel_tile')
TRAINER_FAULTS = ('adapter_bf16_weights',)
# faults that only the kernels phase's check at the recipe's shapes sees
RECIPE_SHAPE_FAULTS = ('flash_partial_block_upper_rows',)
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


def long_video_caught(rows: dict) -> tuple[bool, dict]:
    """(the sound run passed, {fault: caught by the check named for it})."""
    rows = dict(rows)
    sound = rows.pop('sound')
    return (not sound['fails'],
            {name: LONG_VIDEO_FAULTS[name][1] in row['fails']
             for name, row in rows.items()})


def child_plant(argv: list) -> None:
    """`--child-plant NAME <swap CLI arguments>`: one rank of the sharded
    CLI under SHARD_FAULTS[NAME] (torchrun starts this script in each)."""
    from videoswap_torch.test import main as swap_main
    with SHARD_FAULTS[argv[0]][0]():
        swap_main(argv[1:])


def sharded_state(pipe) -> dict:
    """The sharded phase's state: the recipe phase run once, sound, for its
    unsharded 1009 frames and its tree."""
    state = {'pipe': pipe}
    cs.phase_recipe({'launches': {}}, state)
    return state


def main() -> None:
    import argparse
    import tempfile

    import torch
    if sys.argv[1:2] == ['--child-plant']:
        child_plant(sys.argv[2:])
        return
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--only', choices=['long_video', 'sharded',
                                       'shard_blocks', 'sharded_train'],
                    help='run only this group of faults')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        cs.die('no CUDA device: this script runs only on a GPU')
    cs.full_fp32()
    cs.log(f'# nvidia-smi: {cs.card()}')
    if args.only == 'shard_blocks':
        from videoswap_torch.ops import _build
        _build.library()
        rows = shard_block_rows()
        sound_ok = not rows['sound']['fails']
        caught = {name: 'blocks:' in row['checks']
                  for name, row in rows.items() if name != 'sound'}
        must = [n for n, (_, check) in SHARD_FAULTS.items()
                if check == 'blocks:']
        ok = sound_ok and all(caught[n] for n in must)
        print(json.dumps({'ok': ok, 'block_tols': cs.SHARD_BLOCK_TOLS,
                          'shard_block_faults': rows, 'caught': caught,
                          'must_catch': must}), flush=True)
        sys.exit(0 if ok else 1)
    pipe = cs.build_pipeline('cuda', torch.bfloat16)
    if args.only == 'sharded':
        rows = shard_rows(sharded_state(pipe))
        sound_ok, caught = shard_caught(rows)
        ok = sound_ok and all(caught.values())
        print(json.dumps({'ok': ok, 'sharded_tols': {
            'sample': cs.SHARD_REL_TOL, 'cli': cs.SHARD_CLI_TOL},
            'sharded_faults': rows,
            'caught': caught}), flush=True)
        sys.exit(0 if ok else 1)
    if args.only == 'sharded_train':
        rows = train_shard_rows({'pipe': pipe})
        sound_ok, caught = train_shard_caught(rows)
        ok = sound_ok and all(caught.values())
        print(json.dumps({'ok': ok, 'sharded_train_faults': rows,
                          'caught': caught}), flush=True)
        sys.exit(0 if ok else 1)
    if args.only == 'long_video':
        rows = long_video_rows(pipe)
        sound_ok, caught = long_video_caught(rows)
        ok = sound_ok and all(caught.values())
        print(json.dumps({'ok': ok, 'long_video_tol': cs.LONG_MODULE_TOL,
                          'long_video_faults': rows, 'caught': caught}),
              flush=True)
        sys.exit(0 if ok else 1)
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
        if name in ('sound',) + RECIPE_SHAPE_FAULTS:
            row['recipe_shapes_error'] = recipe_shapes_error(name)
        rows[name] = row
        cs.log(f'# {name}: {json.dumps(row)}')
    lora_dir.cleanup()
    edlora = edlora_clip_attn_rows(pipe)
    edlora_sound = edlora.pop('sound')
    long_video = long_video_rows(pipe)
    long_video_sound_ok, long_video_caught_ = long_video_caught(long_video)
    sharded_state_ = sharded_state(pipe)
    sharded = shard_rows(sharded_state_)
    sharded_sound_ok, sharded_caught_ = shard_caught(sharded)
    sharded_train = train_shard_rows(sharded_state_)
    sharded_train_sound_ok, sharded_train_caught_ = train_shard_caught(
        sharded_train)
    recipe = recipe_rows(pipe, cpu)
    atlas_recipe = atlas_recipe_rows()
    atlas_recipe_sound = atlas_recipe.pop('sound')
    sound = rows.pop('sound')
    train_recipe = recipe.pop('train_recipe')
    train_recipe_sound = train_recipe.pop('sound')
    sp = recipe.pop('semantic_points')
    sp_sound = sp.pop('sound')
    recipe_sound = recipe.pop('sound')
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
        if name in RECIPE_SHAPE_FAULTS:
            caught[name] = bool(r['recipe_shapes_error'])
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
    caught['dpm_first_order'] = bool(
        recipe['dpm_first_order']['dpm_small_fails'])
    caught['loader_drops_motion_module'] = any(
        f.startswith('load unet')
        for f in recipe['loader_drops_motion_module']['recipe_fails'])
    caught['vispoint_ignores_index_list'] = 'vispoint' in recipe[
        'vispoint_ignores_index_list']['recipe_fails']
    caught['resume_fresh_adamw'] = 'resume' in train_recipe[
        'resume_fresh_adamw']['train_recipe_fails']
    for name, row in atlas_recipe.items():
        caught[name] = ATLAS_RECIPE_FAULTS[name][1] in row[
            'atlas_recipe_fails']
    for name, row in sp.items():
        caught[name] = SP_FAULTS[name][1] in row['semantic_points_fails']
    for name, row in edlora.items():
        caught[name] = EDLORA_FAULTS[name][1] in row['fails']
    caught.update(long_video_caught_)
    caught.update(sharded_caught_)
    caught.update(sharded_train_caught_)
    ok = not any(v for k, v in sound.items() if k.endswith('_fails')) \
        and not sound['recipe_shapes_error'] \
        and not recipe_sound['dpm_small_fails'] \
        and not recipe_sound['recipe_fails'] \
        and not train_recipe_sound['train_recipe_fails'] \
        and not atlas_recipe_sound['atlas_recipe_fails'] \
        and not sp_sound['semantic_points_fails'] \
        and not edlora_sound['fails'] \
        and long_video_sound_ok \
        and sharded_sound_ok \
        and sharded_train_sound_ok \
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
                      'dpm_step_tol': cs.DPM_STEP_TOL,
                      'recipe_tol': cs.RECIPE_REL_TOL,
                      'train_cli_tols': {'loss': cs.TRAIN_CLI_LOSS_TOL,
                                         'update': cs.TRAIN_CLI_UPDATE_TOL},
                      'sound': sound, 'recipe_sound': recipe_sound,
                      'train_recipe_sound': train_recipe_sound,
                      'faults': rows, 'recipe_faults': recipe,
                      'train_recipe_faults': train_recipe,
                      'atlas_recipe_tols': {
                          'flow_shift': cs.ATLAS_FLOW_SHIFT_TOL,
                          'flow_off_share': cs.ATLAS_FLOW_OFF_SHARE,
                          'flow_median': cs.ATLAS_FLOW_MEDIAN_TOL,
                          'tap_cpu_px': cs.ATLAS_TAP_CPU_PX,
                          'tap_alpha_margin': cs.ATLAS_TAP_ALPHA_MARGIN},
                      'atlas_recipe_sound': atlas_recipe_sound,
                      'atlas_recipe_faults': atlas_recipe,
                      'semantic_points_tols': {
                          'features': cs.MODEL_REL_TOL,
                          'cotracker_px': cs.SP_COTRACKER_PX,
                          'cotracker_fmaps': cs.SP_COTRACKER_FMAPS_TOL,
                          'pose': cs.SP_POSE_TOL,
                          'unimatch': cs.SP_UNIMATCH_TOL},
                      'semantic_points_sound': sp_sound,
                      'semantic_points_faults': sp,
                      'edlora_tols': {'loss': cs.EDLORA_LOSS_TOL,
                                      'grad': cs.EDLORA_GRAD_TOL,
                                      'update': cs.EDLORA_UPDATE_TOL,
                                      'clip_embeds': cs.CLIP_EMBED_TOL,
                                      'clip_score': cs.CLIP_SCORE_TOL,
                                      'attn_row': cs.ATTN_ROW_TOL},
                      'edlora_sound': edlora_sound,
                      'edlora_faults': edlora,
                      'long_video_tol': cs.LONG_MODULE_TOL,
                      'long_video_faults': long_video,
                      'sharded_tols': {'sample': cs.SHARD_REL_TOL,
                                       'cli': cs.SHARD_CLI_TOL},
                      'sharded_faults': sharded,
                      'sharded_train_faults': sharded_train,
                      'caught': caught}), flush=True)
    sys.exit(0 if ok else 1)


if __name__ == '__main__':
    main()
