"""What the ranks of tests/test_torch_sharded_train.py's CPU world run
(JAX-free: the spawned children import no JAX). Each case returns plain
numbers and numpy arrays; the test module holds them to the JAX package's
single-device results and to each other.

The world has four ranks. Its meshes are made first, by every rank (the
process groups are made collectively); then each rank runs the cases of the
meshes that hold it, the two pairs of ranks side by side, then the meshes
of all four. `spec` arrives through a queue, so that the ranks start while
the parent makes it.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

WORLD = 4
PAIR_A, PAIR_B, ALL = (0, 1), (2, 3), (0, 1, 2, 3)
# (case, mesh shape, ranks) in the order each rank runs them
ADAPTER_MESHES = (('adapter_b2', (1, 2, 1), PAIR_A),
                  ('adapter_b2', (1, 1, 2), PAIR_B),
                  ('adapter_b2', (2, 1, 1), PAIR_A),
                  ('adapter_b1', (2, 1, 1), PAIR_B),
                  ('adapter_b2', (1, 2, 2), ALL))
EDLORA_MESHES = (('edlora', (1, 1, 2), PAIR_B), ('edlora', (1, 1, 4), ALL))
ATLAS_MESHES = (('atlas', (2, 1, 1), PAIR_A),)
BLOCK_MESHES = (('blocks_sp', (1, 2, 1), PAIR_A),
                ('blocks_tp', (1, 1, 2), PAIR_B),
                ('blocks_sptp', (1, 2, 2), ALL))
CASES = ADAPTER_MESHES + EDLORA_MESHES + ATLAS_MESHES + BLOCK_MESHES
# scripts/fault_control.py's TRAIN_FAULTS -> the case of CASES that runs
# again under the plant, in every rank of its mesh
PLANT_CASES = {
    'column_entry_identity': ('blocks_tp', (1, 1, 2)),
    'gather_grad_summed': ('blocks_sptp', (1, 2, 2)),
    'atlas_local_masked_mean': ('atlas', (2, 1, 1)),
    'lora_grad_unsummed': ('edlora', (1, 1, 2)),
    'adapter_grad_counts_replicas': ('adapter_b1', (2, 1, 1)),
}


def _np(t):
    return t.detach().to('cpu', torch.float32).numpy().copy()


def fault_plants() -> dict:
    """scripts/fault_control.py's TRAIN_FAULTS: {name: (plant, check)}."""
    from tests.fixtures.sharded_cases import fault_control
    return fault_control().TRAIN_FAULTS


# ------------------------------------------------------- building blocks

def _grads(fn, inputs, params, dout):
    """(d out . dout) / d (inputs, params), as numpy."""
    for t in list(inputs) + list(params):
        t.grad = None
    out = fn()
    out.backward(dout)
    return [_np(t.grad if t.grad is not None else torch.zeros_like(t))
            for t in list(inputs) + list(params)]


def block_grads(kind: str, mesh) -> dict:
    """The gradients of each sharded building block on `mesh` against the
    same module run whole on this rank (the same seeded inputs on every
    rank), fp32: {site: max abs difference over inputs and weights,
    relative to the whole's largest entry}. tp: self- and cross-attention
    and the GEGLU FFN (their weight gradients summed over tp where cut,
    compared on this rank's shard); sp: the resnet GroupNorm with its
    statistics over sp; sp and tp: the motion module's all-to-all round
    trip (frames -> locations -> frames) and the U-Net exit's gather."""
    from videoswap_torch.models.attention_blocks import BasicTransformerBlock
    from videoswap_torch.models.layers import GroupNorm
    from videoswap_torch.models.motion_module import \
        TemporalTransformer3DModel
    from videoswap_torch.parallel import sharding
    torch.manual_seed(0)
    f, c = 4, 16
    x = torch.randn(2, f, 4, 6, c) * 2 + 0.5
    ramp = torch.arange(f, dtype=torch.float32).view(1, -1, 1, 1, 1)
    x = x * (1 + ramp / 4) + ramp
    dout_v = torch.randn(x.shape)
    out = {}
    lay = sharding.layout_for(2, f, mesh)
    if mesh.sp > 1:
        lay = sharding.batch_layout(2, f, mesh)      # frames over sp
    (r0, r1), (f0, f1) = lay.rows, lay.frames

    def rel(a, b):
        return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))

    if kind in ('blocks_sp', 'blocks_sptp'):
        gn = GroupNorm(4, c)
        with torch.no_grad():
            gn.weight.normal_()
            gn.bias.normal_()
        xw = x.clone().requires_grad_()
        whole = _grads(lambda: gn(xw), [xw], [gn.weight, gn.bias], dout_v)
        xl = lay.take(x).clone().requires_grad_()
        with sharding.video_run(sharding.VideoRun(mesh, lay, lay)):
            part = _grads(lambda: gn(xl), [xl], [gn.weight, gn.bias],
                          lay.take(dout_v))
        # the weights' gradients of the parts summed over sp
        wsum = [sharding.sum_distinct(torch.from_numpy(p), mesh,
                                      sharding.distinct_axes(lay)).numpy()
                for p in part[1:]]
        out['group_norm'] = max(
            rel(part[0], whole[0][r0:r1, f0:f1]),
            *(rel(a, b) for a, b in zip(wsum, whole[1:])))

        mm = TemporalTransformer3DModel(c, heads=2, norm_groups=4)
        mparams = list(mm.parameters())
        xw = x.clone().requires_grad_()
        whole = _grads(lambda: mm(xw), [xw], mparams, dout_v)
        xl = lay.take(x).clone().requires_grad_()
        with sharding.video_run(sharding.VideoRun(mesh, lay, lay)):
            part = _grads(lambda: mm(xl), [xl], mparams, lay.take(dout_v))
        # the module is replicated: its weights' gradients summed over the
        # ranks that ran other frames (the per-frame GroupNorm, before the
        # split) or other locations (everything after it)
        wsum = [sharding.sum_distinct(
            torch.from_numpy(p), mesh,
            ('sp',) if n.startswith('norm.') else ('sp', 'tp')).numpy()
            for n, p in zip([n for n, _ in mm.named_parameters()],
                            part[1:])]
        out['motion'] = max(rel(part[0], whole[0][r0:r1, f0:f1]),
                            *(rel(a, b) for a, b in zip(wsum, whole[1:])))

        # the all-to-all round trip: identity both ways
        xl = lay.take(x).reshape(r1 - r0, f1 - f0, 24, c).clone() \
            .requires_grad_()
        with sharding.video_run(sharding.VideoRun(mesh, lay, lay)):
            split = sharding.location_split()
            loc, el = sharding.frames_to_locations(xl, split)
            back = sharding.locations_to_frames(loc * 3.0, split, el)
        d = torch.randn(back.shape)
        back.backward(d)
        out['round_trip'] = max(rel(_np(back), 3 * _np(xl)),
                                rel(_np(xl.grad), 3 * _np(d)))

        # the U-Net exit's gather: this rank's own part of the gradient
        xl = lay.take(x).clone().requires_grad_()
        whole_x = lay.gather(xl)
        whole_x.backward(dout_v)
        out['gather'] = max(rel(_np(whole_x), _np(x)),
                            rel(_np(xl.grad), _np(lay.take(dout_v))))

    if kind in ('blocks_tp', 'blocks_sptp'):
        blk = BasicTransformerBlock(c, 2, 8, 12)
        with torch.no_grad():
            for lin in (blk.attn1.to_out[0], blk.attn2.to_out[0],
                        blk.ff.net[0].proj, blk.ff.net[2]):
                lin.bias.normal_()
        tokens = torch.randn(3, 24, c)
        ctx = torch.randn(3, 77, 12)
        dout = torch.randn(3, 24, c)
        sblk = copy.deepcopy(blk)
        slicers = sharding.shard_unet(sblk, mesh)
        params = dict(blk.named_parameters())
        sparams = dict(sblk.named_parameters())
        for site, fn, sfn in (
                ('attn_self', lambda t, c_: blk.attn1(t),
                 lambda t, c_: sblk.attn1(t)),
                ('attn_cross', lambda t, c_: blk.attn2(t, c_),
                 lambda t, c_: sblk.attn2(t, c_)),
                ('ffn', lambda t, c_: blk.ff(t),
                 lambda t, c_: sblk.ff(t))):
            prefix = {'attn_self': 'attn1.', 'attn_cross': 'attn2.',
                      'ffn': 'ff.'}[site]
            names = [n for n in params if n.startswith(prefix)]
            tw, cw = tokens.clone().requires_grad_(), \
                ctx.clone().requires_grad_()
            whole = _grads(lambda: fn(tw, cw), [tw, cw],
                           [params[n] for n in names], dout)
            tl, cl = tokens.clone().requires_grad_(), \
                ctx.clone().requires_grad_()
            part = _grads(lambda: sfn(tl, cl), [tl, cl],
                          [sparams[n] for n in names], dout)
            errs = [rel(part[0], whole[0])]
            if site == 'attn_cross':
                errs.append(rel(part[1], whole[1]))
            for n, p, w in zip(names, part[2:], whole[2:]):
                ref = torch.from_numpy(w)
                # a row-parallel bias (held on tp rank 0, zeros elsewhere)
                # gets the whole gradient on every rank
                if n in slicers and not n.endswith(('to_out.0.bias',
                                                    'net.2.bias')):
                    ref = slicers[n](ref)
                errs.append(rel(p, ref.numpy()))
            out[site] = max(errs)
    return out


# ---------------------------------------------------------------- adapter

def build_adapter_trainer(spec, device='cpu'):
    from videoswap_torch.builders import build_models
    from videoswap_torch.pipelines import VideoSwapTrainer
    built = build_models({'models': spec['adapter_models_opt']},
                         device=device)
    for name, sd in spec['adapter_sd'].items():
        built[name].load_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    return VideoSwapTrainer(tune_cfg=dict(spec['adapter_tune']),
                            optimizer_cfg={'lr': spec['adapter_lr']},
                            **built)


def adapter_step(spec, key: str, mesh) -> dict:
    """One sharded step of the adapter trainer on the batch and JAX draws
    `spec[key]`: the loss, the reduced gradients, and the adapter's
    weights and AdamW state after the update."""
    from videoswap_torch.parallel import sharding
    from videoswap_torch.pipelines import shard_trainer
    trainer = shard_trainer(build_adapter_trainer(spec), mesh)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in spec[key]['batch'].items()}
    draws = {k: torch.from_numpy(np.asarray(v))
             for k, v in spec[key]['draws'].items()}
    trainer.make_draws = lambda b, g: draws
    sharding.reset_moved()
    loss = trainer.step(batch, None)
    state = sharding.optimizer_tensors(trainer.optimizer)
    return {'loss': float(loss),
            'grads': {n: _np(p.grad)
                      for n, p in trainer.adapter.named_parameters()},
            'after': np.concatenate([_np(t).reshape(-1) for t in state]),
            'moved': dict(sharding.moved),
            'moved_backward': dict(sharding.moved_backward)}


# ---------------------------------------------------------------- ED-LoRA

def edlora_steps(spec, mesh, single: bool = True) -> dict:
    """The JAX test's two ED-LoRA steps, tp-sharded: the losses, each
    group's gradients of the last step and the train params after it, in
    jax.tree.leaves order; on the mesh's first rank also the same steps
    unsharded ('single')."""
    out = _edlora_run(spec, mesh)
    if single and mesh.index == 0:
        out['single'] = _edlora_run(spec, None)
    return out


def _edlora_run(spec, mesh) -> dict:
    from videoswap_torch import edlora_train as et
    from videoswap_torch.builders import build_models
    from videoswap_torch.models.converters import \
        edlora_train_params_from_jax
    from videoswap_torch.parallel import replicate_tree
    e = spec['edlora']
    built = build_models({'models': e['models_opt']}, device='cpu')
    for name, sd in e['sd'].items():
        built[name].load_state_dict(
            {k: torch.from_numpy(v) for k, v in sd.items()}, strict=True)
    trainer = et.EDLoRATrainer(
        unet=built['unet'], text_encoder=built['text_encoder'],
        vae=built['vae'], sched=built['sched'],
        unet_sites=et.lora_sites(built['unet'], 'unet', 'attn'),
        text_sites=et.lora_sites(built['text_encoder'], 'text_encoder',
                                 'attn'),
        alpha=1.0, optimizer_cfg=e['optimizer'], max_grad_norm=1.0)
    if mesh is not None:
        trainer = et.shard_edlora_trainer(trainer, mesh)
    tp = edlora_train_params_from_jax(e['init'])
    groups = et.param_groups(tp)
    for t in groups['emb'] + groups['lora']:
        t.requires_grad_(True)
    replicate_tree(groups['emb'] + groups['lora'], mesh)
    opt = trainer.init_state(tp)
    batch = {k: torch.from_numpy(np.asarray(v))
             for k, v in e['batch'].items()}
    draws = iter([{k: torch.from_numpy(np.asarray(v)) for k, v in d.items()}
                  for d in e['draws']])
    trainer.make_draws = lambda b, g: next(draws)
    leaves, grads = sorted_leaves(tp), []
    update = trainer.update

    def recorded(optimizer):          # the reduced gradients, unclipped
        grads.append([_np(t.grad) for t in leaves])
        update(optimizer)
    trainer.update = recorded
    losses = [float(trainer.step(tp, opt, batch, None)) for _ in e['draws']]
    return {'losses': losses, 'grads': grads[-1], 'grads_first': grads[0],
            'after': [_np(t) for t in leaves]}


def sorted_leaves(tp: dict) -> list:
    """The train params' tensors in jax.tree.leaves order (sorted keys at
    every level)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k])
        else:
            out.append(node)
    walk(tp)
    return out


# ------------------------------------------------------------------ atlas

def atlas_steps(spec, mesh) -> dict:
    """One main step and one inverse step on the JAX draws, dp-sharded:
    the loss terms, the inverse loss, each step's reduced gradients and
    every net's parameters after."""
    from videoswap_torch.atlas.imlp import IMLP
    from videoswap_torch.atlas.trainer import (INVERSE_NET, MAIN_NETS,
                                               AtlasTrainer)
    a = spec['atlas']
    nets = {}
    for n, kw in a['net_kw'].items():
        nets[n] = IMLP(**kw)
        nets[n].load_state_dict({k: torch.from_numpy(v) for k, v in
                                 a['sd'][n].items()}, strict=True)
    trainer = AtlasTrainer(nets, a['data'], a['train_opt'],
                           larger_dim=a['larger_dim'],
                           num_frames=a['num_frames'], device='cpu',
                           mesh=mesh)
    draws = [tuple(torch.from_numpy(np.asarray(v)).long() for v in d)
             for d in a['draws']]
    ld = trainer.step(1, draws=draws[0])
    grads = {n: {k: _np(p.grad) for k, p in trainer.nets[n]
                 .named_parameters()} for n in MAIN_NETS}
    inv = trainer.inverse_step(draws=draws[1])
    grads[INVERSE_NET] = {k: _np(p.grad) for k, p in
                          trainer.nets[INVERSE_NET].named_parameters()}
    return {'losses': {k: float(v) for k, v in ld.items()}, 'grads': grads,
            'inverse': float(inv),
            'after': {n: {k: _np(v) for k, v in net.state_dict().items()}
                      for n, net in trainer.nets.items()}}


# ------------------------------------------------------------------ world

def run_case(spec, case: str, mesh, plant: bool = False) -> dict:
    if case.startswith('adapter'):
        return adapter_step(spec, case, mesh)
    if case == 'edlora':
        return edlora_steps(spec, mesh, single=not plant)
    if case == 'atlas':
        return atlas_steps(spec, mesh)
    return block_grads(case, mesh)


def train_worker(rank: int, specq) -> dict:
    """A rank of the world: every mesh of CASES made first, then the cases
    that hold this rank, in order, then each fault plant's case under the
    plant; {(case, shape): readings} and {('plant', name): readings}."""
    from videoswap_torch.parallel import make_mesh
    spec = specq.get()
    torch.manual_seed(0)
    meshes = {(case, shape): make_mesh(shape, ranks)
              for case, shape, ranks in CASES}
    out = {}
    for key, mesh in meshes.items():
        if mesh.member:
            out[key] = run_case(spec, key[0], mesh)
    plants = fault_plants()
    for name, key in PLANT_CASES.items():
        if meshes[key].member:
            with plants[name][0]():
                out[('plant', name)] = run_case(spec, key[0], meshes[key],
                                                plant=True)
    return out
