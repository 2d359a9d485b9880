"""What the ranks of the sharded tests' CPU worlds run (JAX-free: the
spawned children import no JAX). Each worker returns plain numbers and
numpy arrays; the test modules hold them to their limits.

The fault plants are scripts/fault_control.py's (SHARD_FAULTS), entered in
every rank.
"""

from __future__ import annotations

import copy
import importlib.util
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]


def fault_control():
    spec = importlib.util.spec_from_file_location(
        'fault_control', ROOT / 'scripts' / 'fault_control.py')
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _max(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


# ------------------------------------------------------- building blocks

def blocks_worker(rank: int, plants: tuple) -> dict:
    """Two ranks: each building block sharded over sp = 2 or tp = 2 against
    the same op run whole, sound and under each of `plants`."""
    from videoswap_torch.models.attention_blocks import BasicTransformerBlock
    from videoswap_torch.models.layers import GroupNorm
    from videoswap_torch.models.motion_module import \
        TemporalTransformer3DModel
    from videoswap_torch.p2p import blend
    from videoswap_torch.parallel import make_mesh, sharding
    fc = fault_control()
    mesh_sp, mesh_tp = make_mesh((1, 2, 1)), make_mesh((1, 1, 2))
    torch.manual_seed(0)
    f = 4
    x = torch.randn(1, f, 4, 6, 16) * 2 + 0.5
    gn = GroupNorm(4, 16)
    with torch.no_grad():
        gn.weight.normal_()
        gn.bias.normal_()
    mm = TemporalTransformer3DModel(16, heads=2, norm_groups=4).eval()
    blk = BasicTransformerBlock(16, 2, 8, 12).eval()
    tokens = torch.randn(2, 24, 16)
    ctx = torch.randn(2, 77, 12)
    # heads 0-1 attend to the map's first half, heads 2-3 to its second:
    # the mean over every head is high on both halves
    maps = torch.rand(2, f, 4, 16, 77) * 0.1
    maps[:, :, :2, :8] += 1.0
    maps[:, :, 2:, 8:] += 1.0
    alpha = (torch.rand(2, 77) > 0.8).float()
    with torch.no_grad():
        whole = {'group_norm': gn(x), 'motion': mm(x),
                 'attn_self': blk.attn1(tokens),
                 'attn_cross': blk.attn2(tokens, ctx),
                 'ffn': blk.ff(tokens),
                 'blend': blend.blend_mask([maps], alpha, 0.5, (4, 4), 4, 4)}
    out = {}
    for plant in ('sound',) + tuple(plants):
        with fc.SHARD_FAULTS[plant][0](), torch.no_grad():
            r = {}
            lay = sharding.layout_for(1, f, mesh_sp)
            f0, f1 = lay.frames
            with sharding.video_run(sharding.VideoRun(mesh_sp, lay, lay)):
                r['group_norm'] = _max(gn(lay.take(x)),
                                       whole['group_norm'][:, f0:f1])
                r['motion_sp'] = _max(mm(lay.take(x)),
                                      whole['motion'][:, f0:f1])
                split = sharding.location_split()
                both = lay.take(x).reshape(1, f1 - f0, 24, 16)
                loc, el = sharding.frames_to_locations(both, split)
                back = sharding.locations_to_frames(loc, split, el)
                r['round_trip'] = _max(back, both)
                r['loc_chunk'] = list(loc.shape)
            lay_tp = sharding.layout_for(1, f, mesh_tp)
            with sharding.video_run(sharding.VideoRun(mesh_tp, lay_tp,
                                                      lay_tp)):
                r['motion_tp'] = _max(mm(x), whole['motion'])
            sblk = copy.deepcopy(blk)
            sharding.shard_unet(sblk, mesh_tp)
            r['attn_self'] = _max(sblk.attn1(tokens), whole['attn_self'])
            r['attn_cross'] = _max(sblk.attn2(tokens, ctx),
                                   whole['attn_cross'])
            r['ffn'] = _max(sblk.ff(tokens), whole['ffn'])
            r['heads_local'] = sblk.attn1.heads
            r['w1_rows'] = list(sblk.ff.net[0].proj.weight.shape)
            t = mesh_tp.coord[2]
            with sharding.mesh_scope(mesh_tp):
                m = blend.blend_mask([maps[:, :, 2 * t:2 * t + 2]], alpha,
                                     0.5, (4, 4), 4, 4)
            r['blend_differ'] = int((m != whole['blend']).sum())
            r['blend_true'] = int(whole['blend'].sum())
        out[plant] = r
    return out


# ------------------------------------------------------ the sharded swap

def swap_worker(rank: int, specq) -> dict:
    """The ranks of a world whose spec arrives through `specq` (so that the
    ranks start while the parent makes it): the tiny pipeline built from
    `spec`'s state dicts; on every (kind, mesh shape, ranks) of
    `spec['meshes']` that holds this rank (the meshes made first, so that
    meshes on other ranks run at once), the sampled latents ('sample'),
    the blended swap's frames ('validation') or the windowed U-Net's
    forward ('unet_long'); each mesh's first rank returns them with its
    collectives' bytes. Rank `spec['port_rank']`, in no mesh, runs each
    kind unsharded ('port')."""
    from videoswap_torch.parallel import make_mesh, shard_pipeline
    from videoswap_torch.parallel import sharding
    spec = specq.get()
    pipe = build_pipeline(spec)
    meshes = [(kind, make_mesh(shape, ranks))
              for kind, shape, ranks in spec['meshes']]
    out = {}
    if rank == spec['port_rank']:
        out['port'] = {kind: run_kind(pipe, kind, spec)
                       for kind in ('sample', 'validation', 'unet_long')}
    for kind, mesh in meshes:
        if not mesh.member:
            continue
        sharding.reset_moved()
        got = run_kind(shard_pipeline(pipe, mesh), kind, spec, mesh)
        if mesh.index == 0:
            out[(kind, mesh.shape)] = {'out': got,
                                       'moved': dict(sharding.moved)}
    return out


def build_unet(cfg: dict, sd: dict):
    from videoswap_torch.models import AnimateDiffUNet3DModel, UNet3DConfig
    unet = AnimateDiffUNet3DModel(UNet3DConfig(**cfg))
    unet.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()},
                         strict=True)
    return unet.eval()


def build_pipeline(spec: dict):
    from videoswap_torch.models import (AdapterConfig, SparsePointAdapter)
    from videoswap_torch.models.clip_text import (CLIPTextConfig,
                                                  CLIPTextModel)
    from videoswap_torch.models.vae import AutoencoderKL
    from videoswap_torch.pipelines import VideoSwapPipeline
    from videoswap_torch.schedulers import make_schedule
    from videoswap_torch.utils.tokenizer import HashTokenizer
    mods = {'unet': build_unet(spec['unet_cfg'], spec['sd']['unet']),
            'vae': AutoencoderKL(**spec['vae_kw']),
            'text_encoder': CLIPTextModel(CLIPTextConfig(**spec['clip_kw'])),
            'adapter': SparsePointAdapter(AdapterConfig(
                **spec['adapter_kw']))}
    for name, m in mods.items():
        if name != 'unet':
            m.load_state_dict({k: torch.from_numpy(v) for k, v in
                               spec['sd'][name].items()}, strict=True)
        m.eval()
    return VideoSwapPipeline(tokenizer=HashTokenizer(),
                             sched=make_schedule(), **mods)


def run_kind(pipe, kind: str, spec: dict, mesh=None) -> np.ndarray:
    """'sample': the latents of `sample`; 'validation': the swap's frames
    (np output, [-1, 1]); 'unet_long': the windowed U-Net's forward (its
    own U-Net, tp-sharded on `mesh` where one is given)."""
    video, cond = spec['video'], spec['conditions']
    if kind == 'unet_long':
        unet = build_unet(spec['long_unet_cfg'], spec['sd']['unet'])
        if mesh is not None:
            from videoswap_torch.parallel import sharding
            unet.tp_slicers = sharding.shard_unet(unet, mesh)
            unet.mesh = mesh
        x, t, text = (torch.from_numpy(a) for a in spec['long_inputs'])
        with torch.no_grad():
            return unet(x, t, text).numpy()
    if kind == 'sample':
        with torch.no_grad():
            lat = pipe.sample(**spec['sample_kw'],
                              latents=torch.from_numpy(spec['latents']),
                              conditions=cond, output_type='latent')
        return lat.numpy()
    res = pipe.validation(video, cond, spec['prompt'], spec['editing'],
                          output_type='np')
    return res[spec['swap']]

