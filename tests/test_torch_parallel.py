"""The port's `parallel/` on the CPU: the layout rule against the JAX
package's, the sharded building blocks in one spawned gloo world of two
ranks against the same ops run whole (each of scripts/fault_control.py's
sharded-swap plants shown caught), the multi-process file handling, and the
swap CLI under `torchrun --shard 1,2,1 --device cpu`.

Limits: the building blocks sharded against whole, fp32, <= 1e-5; the
all-to-all round trip bit-equal. The CLI's sharded frames against its
unsharded frames: as the port's other blended CLI tests, at most 1% of the
values off, none by more than 2 levels.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures import sharded_cases
from tests.fixtures.torch_world import run_world
from videoswap_torch.ops.geglu_ffn import geglu_ffn_plain
from videoswap_torch.parallel import Mesh, param_sharding_rules, sharding
from videoswap_torch.parallel import dist as vdist
from videoswap_tpu.parallel import make_mesh as j_make_mesh
from videoswap_tpu.parallel import param_sharding_rules as j_rules
from videoswap_tpu.parallel.sharding import (constrain_frames,
                                             video_sharding as j_video)

ROOT = Path(__file__).resolve().parents[1]
PLANTS = ('gn_shard_stats', 'tp_bias_every_rank', 'w1_contiguous_split',
          'blend_heads_unreduced', 'a2a_frames_reversed')


def _mesh(shape):
    return Mesh(shape=tuple(shape), ranks=tuple(range(int(np.prod(shape)))),
                coord=None)


def _spec(entries):
    """A JAX PartitionSpec's entries, padded to (batch, frames)."""
    e = tuple(entries) + (None, None)
    return e[0], e[1]


# tests/test_sharding_constraints.py's cases: mesh, (B, F)
LAYOUT_CASES = [((1, 2, 4), (2, 4)), ((1, 2, 4), (1, 4)),
                ((1, 2, 4), (1, 3)), ((2, 2, 2), (4, 2)),
                ((2, 2, 2), (3, 2)), ((2, 2, 2), (2, 2)),
                ((1, 2, 2), (2, 16)), ((1, 4, 1), (1, 2))]


@pytest.mark.parametrize('shape, bf', LAYOUT_CASES)
def test_layout_rule_equals_constrain_frames(shape, bf):
    mesh = j_make_mesh(shape, jax.devices()[:int(np.prod(shape))])
    x = jnp.ones((*bf, 8, 8, 3))
    with jax.set_mesh(mesh):
        y = jax.jit(constrain_frames)(x)
    assert sharding.video_spec(*bf, _mesh(shape)) == _spec(y.sharding.spec)
    assert sharding.video_sharding(x.shape, _mesh(shape)) \
        == tuple(j_video(mesh, x.shape).spec) + (None,) * (x.ndim - len(
            j_video(mesh, x.shape).spec))


def test_param_sharding_rules_match_the_jax_rules():
    """tests/test_multichip.py's cases; the port's weights are (out, in),
    the JAX kernels (in, out), so each split axis is the other one."""
    class Leaf:
        ndim = 2
    flip = {('tp', None): (None, 'tp'), (None, 'tp'): ('tp', None), (): ()}
    for jpath, tpath in ((('attn1', 'to_q', 'kernel'), 'attn1.to_q.weight'),
                         (('ff', 'net_2', 'kernel'), 'ff.net.2.weight'),
                         (('ff', 'net_0_proj', 'kernel'),
                          'ff.net.0.proj.weight'),
                         (('attn2', 'to_out_0', 'kernel'),
                          'attn2.to_out.0.weight')):
        want = tuple(j_rules(jpath, Leaf()))
        got = param_sharding_rules(tpath.split('.'), 2)
        assert flip[got] == (want + (None, None))[:2] if want else got == ()
    assert param_sharding_rules(('conv1', 'weight'), 4) == ()
    assert param_sharding_rules(('attn1', 'to_q', 'weight'), 2) == \
        ('tp', None)
    assert param_sharding_rules(('ff', 'net', '2', 'weight'), 2) == \
        (None, 'tp')


def test_mesh_refuses_a_shape_that_is_not_the_world():
    from videoswap_torch.parallel import make_mesh
    assert make_mesh((1, 1, 1)).groups == {}
    with pytest.raises(ValueError, match='mesh'):
        make_mesh((1, 2, 1))


def test_geglu_plain_at_half_width_sums_to_the_full_product():
    """H = 4C / 2: each half's [a | gate] rows and W2 columns, b2 once,
    summed, give the full-width product; a contiguous split of the 8C rows
    (rank 0 all of a, rank 1 all of gate) does not."""
    torch.manual_seed(0)
    c = 16
    x = torch.randn(10, c)
    w1, b1 = torch.randn(8 * c, c) * c ** -0.5, torch.randn(8 * c) * 0.1
    w2, b2 = torch.randn(c, 4 * c) * (4 * c) ** -0.5, torch.randn(c) * 0.1
    full = geglu_ffn_plain(x, w1, b1, w2, b2)

    def summed(rows_fn):
        out = 0
        for t in range(2):
            r = rows_fn(4 * c, t, 2)
            out = out + geglu_ffn_plain(
                x, w1[r], b1[r], w2[:, t * 2 * c:(t + 1) * 2 * c],
                sharding.bias_on_rank(b2, t))
        return out
    assert float((summed(sharding.geglu_rows) - full).abs().max()) <= 1e-5
    contiguous = (lambda inner, t, tp: torch.arange(
        t * 2 * inner // tp, (t + 1) * 2 * inner // tp))
    assert float((summed(contiguous) - full).abs().max()) > 1e-2


def test_edlora_merge_on_a_tp_shard_equals_the_merged_weights_cut():
    """An ED-LoRA merge into a tensor-parallel rank's weights (the deltas
    cut by `shard_unet`'s slicers) equals the merged full weights cut the
    same way, for both tp ranks; the bias held by rank 0 alone."""
    import copy

    from videoswap_torch.edlora import _UNET_LORA, _eligible, \
        merge_lora_into_params
    from videoswap_torch.models.attention_blocks import BasicTransformerBlock
    torch.manual_seed(0)
    blk = BasicTransformerBlock(16, 2, 8, 12)
    full = dict(blk.named_parameters())
    lora = {}
    for k, w in full.items():
        if _eligible(k, _UNET_LORA):
            lora[k.replace('.weight', '.lora_down.weight')] = torch.randn(
                2, w.shape[1])
            lora[k.replace('.weight', '.lora_up.weight')] = torch.randn(
                w.shape[0], 2)
    merged_full, n = merge_lora_into_params(full, lora, 'unet', 0.7)
    assert n == 10     # to_q, to_k, to_v, to_out.0 of both attentions; the FFN
    for t in range(2):
        sblk = copy.deepcopy(blk)
        mesh = Mesh(shape=(1, 1, 2), ranks=(0, 1), coord=(0, 0, t))
        slicers = sharding.shard_unet(sblk, mesh)
        local = dict(sblk.named_parameters())
        merged, _ = merge_lora_into_params(local, lora, 'unet', 0.7,
                                           slicers=slicers)
        for k, w in merged.items():
            np.testing.assert_allclose(w.detach(), slicers[k](
                merged_full[k]).detach(), rtol=0, atol=1e-6)
        assert torch.equal(local['ff.net.2.bias'],
                           full['ff.net.2.bias'] * (t == 0))


@pytest.fixture(scope='module')
def blocks(tmp_path_factory):
    out = run_world(2, sharded_cases.blocks_worker, (PLANTS,),
                    tmp_path_factory.mktemp('blocks'))
    return out


BLOCK_LIMITS = {'group_norm': 1e-5, 'motion_sp': 1e-5, 'motion_tp': 1e-5,
                'attn_self': 1e-5, 'attn_cross': 1e-5, 'ffn': 1e-5}


def test_sharded_blocks_equal_the_whole_ops(blocks):
    for rank, res in enumerate(blocks):
        r = res['sound']
        for key, tol in BLOCK_LIMITS.items():
            assert r[key] <= tol, (rank, key, r[key])
        assert r['round_trip'] == 0.0            # bit-equal
        # 24 locations in 2 chunks of 12, with all 4 frames
        assert r['loc_chunk'] == [1, 4, 12, 16]
        assert r['heads_local'] == 1 and r['w1_rows'] == [64, 16]
        assert r['blend_differ'] == 0 and 0 < r['blend_true']


@pytest.mark.parametrize('plant, key', [
    ('gn_shard_stats', 'group_norm'),
    ('tp_bias_every_rank', 'attn_self'),
    ('w1_contiguous_split', 'ffn'),
    ('blend_heads_unreduced', 'blend_differ'),
    ('a2a_frames_reversed', 'round_trip'),
])
def test_each_sharded_fault_is_caught(blocks, plant, key):
    """A shard's own GroupNorm statistics, a row-parallel bias added on
    every tp rank, a contiguous W1 split, an unreduced head mean and a
    frame order reversed by the inverse all-to-all each break the equality
    the sound run holds."""
    worst = max(r[plant][key] for r in blocks)
    assert worst > (0 if key == 'blend_differ' else 1e-3), (plant, worst)
    if plant == 'tp_bias_every_rank':
        assert max(r[plant]['ffn'] for r in blocks) > 1e-3
    if plant == 'a2a_frames_reversed':
        assert max(r[plant]['motion_sp'] for r in blocks) > 1e-3


# ------------------------------------------------- multi-process file IO

def test_single_process_defaults(monkeypatch):
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    assert not vdist.distributed_requested()
    assert not vdist.maybe_initialize_distributed()
    assert vdist.is_main_process() and vdist.world_size() == 1
    vdist.barrier()                                  # no-op at 1 process


def test_env_requests_distributed(monkeypatch):
    monkeypatch.setenv('WORLD_SIZE', '2')
    assert vdist.distributed_requested()
    assert vdist.choose_backend('cpu', 2) == 'gloo'


def test_checkpoint_and_exp_dir_writes_gated_off_main(tmp_path,
                                                      monkeypatch):
    from videoswap_torch import builders
    from videoswap_torch.models import AdapterConfig, SparsePointAdapter
    from videoswap_torch.parallel import dist as pdist
    from videoswap_torch.utils import logger as vlogger
    adapter = SparsePointAdapter(AdapterConfig(
        embedding_channels=4, channels=(4, 4, 8, 8), mid_dim=4))
    cfg = tmp_path / 'x.yml'
    cfg.write_text('name: gated\n')
    for mod in (pdist, builders, vlogger):
        monkeypatch.setattr(mod, 'is_main_process', lambda: False)
    ckpt = tmp_path / 'adapter.pth'
    builders.save_adapter_checkpoint(str(ckpt), adapter)
    paths = vlogger.set_path_logger(str(tmp_path), str(cfg),
                                    {'name': 'gated'}, is_train=True)
    assert not ckpt.exists() and not os.path.exists(paths['exp_root'])
    for mod in (pdist, builders, vlogger):
        monkeypatch.setattr(mod, 'is_main_process', lambda: True)
    builders.save_adapter_checkpoint(str(ckpt), adapter)
    paths = vlogger.set_path_logger(str(tmp_path), str(cfg),
                                    {'name': 'gated'}, is_train=True)
    assert ckpt.exists() and os.path.isdir(paths['models'])


# ------------------------------------------------------------------ CLI

def _torchrun(n, yml, shard, cwd, env):
    return subprocess.Popen(
        [sys.executable, '-m', 'torch.distributed.run', '--standalone',
         '--nproc_per_node', str(n), '-m', 'videoswap_torch.test', '-opt',
         str(yml), '--shard', shard, '--device', 'cpu'],
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    from tests import test_torch_cli as tc
    from videoswap_torch.builders import build_models
    cs = tc._chip_smoke()
    tree = tmp_path_factory.mktemp('tree')
    built = build_models({'models': tc.MODELS_OPT}, device='cpu', seed=11)
    cs.write_experiment_tree(built, tree,
                             {'edlora_hermione.pth': cs.BLEND_CONCEPTS},
                             dtype=torch.float32)
    cs.write_clip(tree, tc.CLIP_FRAMES, 72, {'TAP.pth': (tc.H, tc.W),
                                             'TAP_other.pth': (tc.H, tc.W)},
                  emb=12)
    cs.write_clip_dir(tree / 'clip', tc.TINY_CLIP)
    yml = tree / 'tiny_cli.yml'
    yml.write_text(tc.CONFIG.format(tree=tree, root=ROOT, frames=tc.FRAMES,
                                    h=tc.H, w=tc.W,
                                    clip_frames=tc.CLIP_FRAMES))
    for d in ('sharded', 'mismatch', 'whole'):
        (tree / d).mkdir()
        (tree / d / 'clip').symlink_to(tree / 'clip')
    env = dict(os.environ, OMP_NUM_THREADS='1', PYTHONPATH=str(ROOT))
    procs = {'sharded': _torchrun(2, yml, '1,2,1', tree / 'sharded', env),
             'mismatch': _torchrun(1, yml, '1,2,1', tree / 'mismatch', env)}
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        from videoswap_torch.test import test
        whole = test(str(tree / 'whole'), str(yml), device='cpu')
    finally:
        torch.set_num_threads(n)
    logs = {k: p.communicate(timeout=300)[0] for k, p in procs.items()}
    codes = {k: p.returncode for k, p in procs.items()}
    return tree, whole, logs, codes


def _frames(vis: Path, key: str) -> np.ndarray:
    from PIL import Image
    files = sorted((vis / key / f'frames_{key}').glob('*.png'))
    return np.stack([np.asarray(Image.open(f)) for f in files])


def test_sharded_cli_writes_on_rank_0_alone(cli_runs):
    tree, whole, logs, codes = cli_runs
    assert codes['sharded'] == 0, logs['sharded'][-3000:]
    results = tree / 'sharded' / 'results'
    assert [p.name for p in results.iterdir()] == ['tiny_cli']
    exp = results / 'tiny_cli'
    assert len(list(exp.glob('*.log'))) == 1          # rank 0's log alone
    vis = exp / 'visualization'
    assert sorted(p.name for p in vis.iterdir()) == sorted(
        ['metrics.json', 'source', *whole['results'],
         'man_to_hermione_attention', 'man_to_dog_attention'])
    assert 'backend gloo' in logs['sharded']
    assert 'rank 1: done (the main process writes)' in logs['sharded']
    for key, ref in whole['results'].items():
        got = _frames(vis, key)
        diff = np.abs(got.astype(np.int32) - ref.astype(np.int32))
        assert float((diff > 0).mean()) <= 1e-2, (key, (diff > 0).mean())
        assert int(diff.max()) <= 2, (key, diff.max())


def test_sharded_cli_refuses_a_world_that_is_not_the_mesh(cli_runs):
    tree, _, logs, codes = cli_runs
    assert codes['mismatch'] != 0
    assert '--shard 1,2,1 needs 2 ranks; the world has 1' in logs['mismatch']
    assert not (tree / 'mismatch' / 'results').exists()
