"""The port's sharded training paths against the JAX package's
single-device steps, on the CPU in fp32: one spawned gloo world of four
ranks (tests/fixtures/sharded_train_cases.py) runs

- each sharded building block's gradients against the same module run
  whole (tp attention and GEGLU FFN, the GroupNorm over sp, the motion
  module's all-to-all round trip, the U-Net exit's gather), 1e-5 of the
  whole's largest entry;
- the adapter step at `__graft_entry__.dryrun_multichip`'s config on the
  meshes (1,2,1), (1,1,2), (1,2,2), (2,1,1) at B = 2 and (2,1,1) at B = 1
  (the rows replicated over dp), held to the JAX package's loss (rtol 1e-4)
  and per-leaf gradients (rtol 5e-4, atol 5e-5 of the leaf's largest
  entry), the dryrun's limits, on the JAX draws;
- ED-LoRA at tp = 2 and 4, held to tests/test_edlora_shard.py's two
  single-device steps with its limits (losses rtol 1e-5, gradients rtol
  2e-4 / atol 1e-7, updated params rtol 2e-4 / atol 1e-5);
- the atlas at dp = 2, held to tests/test_atlas.py's single-device main and
  inverse steps with its limits (losses rtol 5e-5, params rtol 1e-4 / atol
  3e-5);
- scripts/fault_control.py's TRAIN_FAULTS, each planted in every rank of a
  case that must catch it.

After each step every rank holds the same bits of the trainable state.
The JAX references run in processes of their own while the world works
(one each for the adapter's two batch sizes, ED-LoRA and the atlas in this
one). Beside them, the three training CLIs run under `torchrun
--nproc_per_node 2 ... --device cpu` and once without it: only rank 0
writes, and the results equal the single process's (train --distributed
bit for bit: every rank runs the same unsharded steps); a world of another
size is refused.
"""

import concurrent.futures
import json
import os
import re
import subprocess
import sys
from multiprocessing import get_context
from pathlib import Path

import numpy as np
import pytest
import torch

from tests.fixtures import sharded_train_cases as cases
from tests.fixtures import sharded_train_jax as J
from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from tests.fixtures.torch_world import start_world
from videoswap_torch.models.converters import jax_params_to_state_dict

ROOT = Path(__file__).resolve().parents[1]
BLOCK_TOL = 1e-5
# ED-LoRA against the JAX package, relative L2 of each group (concept
# embeddings, LoRA factors): the port's own single-device steps read 1.38e-4
# (the embeddings' gradient: fp32 sums of the U-Net and CLIP in another
# order) and 1.27e-3 (the embeddings after Adam's two steps, which amplify
# that where the gradient is near 0); about twice each
EDLORA_JAX_L2 = {'grads': 3e-4, 'after': 3e-3}


# ------------------------------------------------------------------ CLIs
# the train CLI's config: tests/test_torch_train_cli.py's tiny models on
# the smoke clip, 2 steps
TRAIN_CFG = {
    'name': 'dist_train', 'manual_seed': 7, 'mixed_precision': 'no',
    'models': {
        'unet': {'unet_cfg': {
            'block_out_channels': [16, 32, 32, 32], 'attention_head_dim': 4,
            'cross_attention_dim': 24, 'norm_num_groups': 8,
            'motion_heads': 4}},
        'adapter': {'adapter_cfg': {'embedding_channels': 12,
                                    'channels': [16, 32, 32, 32],
                                    'mid_dim': 8}},
        'vae_cfg': {'block_out_channels': [8, 8, 16, 16], 'norm_groups': 8},
        'text_encoder_cfg': {'hidden_size': 24, 'num_layers': 1,
                             'num_heads': 4, 'intermediate_size': 32}},
    'path': {},
    'train': {'train_pipeline': 'VideoSwapTrainer',
              'optimizer': {'type': 'AdamW', 'lr': 5.0e-4,
                            'weight_decay': 0.01},
              'tune_cfg': {'drop_rate': 0.2, 'min_timestep': 0.5,
                           'loss_type': 'local'},
              'lr_scheduler': 'constant', 'total_iter': 2,
              'warmup_iter': 0},
    'logger': {'print_freq': 1, 'save_checkpoint_freq': 2},
}


def _cli_trees(base: Path) -> dict:
    """The smoke data and the three CLIs' configs under `base`: {cli:
    config path}."""
    sys.path.insert(0, str(ROOT))
    from scripts.make_atlas_smoke import make as make_atlas
    from scripts.make_smoke_dataset import make as make_smoke
    make_smoke(str(base / 'smoke'), frames=4, size=64)
    make_atlas(str(base / 'atlas_smoke'), frames=4, size=32)
    smoke = base / 'smoke'
    train = dict(TRAIN_CFG, datasets={
        'type': 'SingleVideoPointDataset', 'path': str(smoke / 'frames'),
        'tap_path': str(smoke / 'TAP.pth'), 'prompt': 'a cat walking',
        'num_frames': 2, 'total_frames': 4,
        'video_transform': [{'type': 'Resize', 'size': 64},
                            {'type': 'ToTensor'},
                            {'type': 'Normalize', 'mean': [0.5],
                             'std': [0.5]}],
        'batch_size_per_gpu': 1, 'dataset_enlarge_ratio': 4})
    out = {'train': base / 'train.yml'}
    out['train'].write_text(json.dumps(train))          # JSON is YAML
    resume = dict(train, train=dict(train['train'], total_iter=4))
    (base / 'train_resume.yml').write_text(json.dumps(resume))
    text = (ROOT / 'options' / 'smoke' / 'train_edlora_smoke.yml') \
        .read_text().replace('image_dir: datasets/smoke/concepts',
                             f'image_dir: {smoke / "concepts"}') \
        .replace('total_iter: 4', 'total_iter: 2') \
        .replace('save_checkpoint_freq: 4', 'save_checkpoint_freq: 2')
    out['train_edlora'] = base / 'edlora.yml'
    out['train_edlora'].write_text(text)
    text = (ROOT / 'options' / 'smoke' / 'train_atlas_smoke.yml') \
        .read_text().replace('datasets/atlas_smoke',
                             str(base / 'atlas_smoke')) \
        .replace('total_iter: 20', 'total_iter: 4') \
        .replace('pretrain_UV_mapping_iter: 2',
                 'pretrain_UV_mapping_iter: 1') \
        .replace('val_freq: 20', 'val_freq: 4') \
        .replace('full_eval: true', 'full_eval: false') \
        .replace('save_checkpoint_freq: !!float 20',
                 'save_checkpoint_freq: 4')
    out['train_atlas'] = base / 'atlas.yml'
    out['train_atlas'].write_text(text)
    return out


ATLAS_CLI_LR, ATLAS_CLI_ITERS = 1e-3, 4      # the atlas smoke config's
SHARD_FLAG = {'train': ['--distributed'], 'train_edlora': ['--shard', '2'],
              'train_atlas': ['--shard', '2']}


def _launch(cli: str, yml: Path, root: Path, kind: str, extra=()):
    """The CLI under `torchrun --nproc_per_node 2` ('dist') or alone
    ('single') in `root`: (Popen, root)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS='1')
    root.mkdir(exist_ok=True)
    cmd = [sys.executable, '-m', f'videoswap_torch.{cli}', '-opt', str(yml),
           '--device', 'cpu', *extra]
    if kind == 'dist':
        cmd = ([sys.executable, '-m', 'torch.distributed.run',
                '--standalone', '--nproc_per_node', '2'] + cmd[1:]
               + SHARD_FLAG[cli])
    return subprocess.Popen(cmd, cwd=root, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), root


def _start_clis(base: Path) -> dict:
    """Each CLI under `torchrun --nproc_per_node 2` and alone, each in a
    root of its own: {(cli, 'dist' | 'single'): (Popen, root)}."""
    return {(cli, kind): _launch(cli, yml, base / f'{cli}_{kind}', kind)
            for cli, yml in _cli_trees(base).items()
            for kind in ('dist', 'single')}


def _start_resumes(procs: dict, base: Path) -> None:
    """Once the train CLI's two runs have ended, both again with --resume
    to step 4, in the same roots: procs[('train_resume', kind)]."""
    for kind in ('dist', 'single'):
        proc, root = procs[('train', kind)]
        proc.wait(timeout=600)
        procs[('train_resume', kind)] = _launch(
            'train', base / 'train_resume.yml', root, kind, ['--resume'])


def _finish_clis(procs: dict) -> dict:
    out = {}
    for key, (proc, root) in procs.items():
        text, _ = proc.communicate(timeout=600)
        out[key] = {'code': proc.returncode, 'tail': text[-4000:],
                    'root': root}
    return out


# ---------------------------------------------------------------- fixture
def _sd(params: dict) -> dict:
    return {k: v.numpy() for k, v in jax_params_to_state_dict(params).items()}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """The world's readings ('port'), the JAX references ('jax') and the
    CLIs' runs ('cli'). The world and the CLIs start first; the world
    takes its spec through a queue; the JAX references run while they
    work."""
    specq = get_context('spawn').Queue()
    world = start_world(cases.WORLD, cases.train_worker, (specq,),
                        tmp_path_factory.mktemp('train_world'))
    pool = concurrent.futures.ProcessPoolExecutor(
        3, mp_context=get_context('spawn'))
    refs = {f'adapter_b{b}': pool.submit(J.adapter_reference, b)
            for b in (2, 1)}
    refs['edlora'] = pool.submit(J.edlora_reference)
    cli_base = tmp_path_factory.mktemp('clis')
    clis = _start_clis(cli_base)
    aparams = J.adapter_params()
    einputs = J.edlora_inputs()
    ainputs = J.atlas_inputs()
    spec = {
        'adapter_models_opt': {
            'unet': {'unet_cfg': J.ADAPTER_UNET},
            'vae_cfg': J.ADAPTER_VAE, 'text_encoder_cfg': J.ADAPTER_CLIP,
            'adapter': {'adapter_cfg': J.ADAPTER_AD}},
        'adapter_sd': {n: _sd(aparams[n]) for n in J.ADAPTER_NAMES},
        'adapter_tune': J.ADAPTER_TUNE, 'adapter_lr': J.ADAPTER_LR,
        'adapter_b2': {'batch': J.adapter_batch(2),
                       'draws': J.adapter_draws(2)},
        'adapter_b1': {'batch': J.adapter_batch(1),
                       'draws': J.adapter_draws(1)},
        'edlora': {
            'models_opt': {'unet': {'unet_cfg': J.EDLORA_UNET},
                           'vae_cfg': J.EDLORA_VAE,
                           'text_encoder_cfg': J.EDLORA_CLIP},
            'sd': {n: _sd(einputs['params'][n]) for n in J.EDLORA_NAMES},
            'optimizer': J.EDLORA_OPT, 'init': einputs['init'],
            'batch': einputs['batch'], 'draws': einputs['draws']},
        'atlas': {
            'net_kw': J.ATLAS_NETS,
            'sd': {n: _sd(ainputs['params'][n]) for n in J.ATLAS_NETS},
            'data': ainputs['data'], 'train_opt': ainputs['train_opt'],
            'larger_dim': 16, 'num_frames': 4, 'draws': ainputs['draws']}}
    for _ in range(cases.WORLD):
        specq.put(spec)
    _start_resumes(clis, cli_base)
    with pool:
        jax_out = {'atlas': J.atlas_reference(ainputs)}
        jax_out.update({k: f.result() for k, f in refs.items()})
    ranks = world.results(timeout=600)
    return {'jax': jax_out, 'ranks': ranks, 'cli': _finish_clis(clis),
            'atlas_lr': ainputs['train_opt']['optimizer']['lr']}


def _by_rank(runs, key) -> list:
    return [r[key] for r in runs['ranks'] if key in r]


# -------------------------------------------------------- building blocks
BLOCK_SITES = [('blocks_sp', (1, 2, 1), s) for s in
               ('group_norm', 'motion', 'round_trip', 'gather')] + \
    [('blocks_tp', (1, 1, 2), s) for s in
     ('attn_self', 'attn_cross', 'ffn')] + \
    [('blocks_sptp', (1, 2, 2), s) for s in
     ('group_norm', 'motion', 'round_trip', 'gather', 'attn_self',
      'attn_cross', 'ffn')]


@pytest.mark.parametrize('case, shape, site', BLOCK_SITES)
def test_collective_gradients_match_the_whole_module(runs, case, shape,
                                                     site):
    """Each rank's output and input gradient against its part of the
    whole module's, and the weights' gradients (summed over the ranks
    that hold other parts; on this rank's shard where cut), fp32."""
    errs = [r[site] for r in _by_rank(runs, (case, shape))]
    assert len(errs) == int(np.prod(shape))
    assert max(errs) <= BLOCK_TOL, errs


# ---------------------------------------------------------------- adapter
ADAPTER_CASES = [(c, s) for c, s, _ in cases.ADAPTER_MESHES]


@pytest.mark.parametrize('case, shape', ADAPTER_CASES)
def test_adapter_step_matches_jax(runs, case, shape):
    ref = runs['jax'][case]
    ref_grads = jax_params_to_state_dict({'params': ref['grads']})
    for r in _by_rank(runs, (case, shape)):
        np.testing.assert_allclose(r['loss'], ref['loss'], rtol=1e-4)
        assert set(r['grads']) == set(ref_grads)
        for name, g in r['grads'].items():
            want = ref_grads[name].numpy()
            scale = max(1e-6, float(np.abs(want).max()))
            np.testing.assert_allclose(g, want, rtol=5e-4,
                                       atol=5e-5 * scale, err_msg=name)
        fwd, bwd = r['moved'], r['moved_backward']
        if shape[2] > 1:      # tp partial sums, and the entries' gradients
            assert fwd['all_reduce'] > 0 and bwd['all_reduce'] > 0
        if shape[1] > 1:      # frames -> locations and back, both ways
            assert fwd['all_to_all'] > 0 and bwd['all_to_all'] > 0


@pytest.mark.parametrize('case, shape', ADAPTER_CASES)
def test_adapter_ranks_end_bit_equal(runs, case, shape):
    """The adapter's weights and AdamW state after the step."""
    after = [r['after'] for r in _by_rank(runs, (case, shape))]
    assert len(after) == int(np.prod(shape))
    for a in after[1:]:
        np.testing.assert_array_equal(a, after[0])


# ---------------------------------------------------------------- ED-LoRA
EDLORA_CASES = [s for _, s, _ in cases.EDLORA_MESHES]


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _groups(leaves) -> dict:
    """jax.tree.leaves of the train params -> {'emb', 'lora'} flat (the
    one concept's embedding sorts first)."""
    return {'emb': leaves[0].ravel(),
            'lora': np.concatenate([a.ravel() for a in leaves[1:]])}


def _adam_close(p, want, grads, lr, rtol, atol) -> None:
    """Updated params within rtol / atol, entries whose gradient (any of
    `grads`) is below 1e-6 in magnitude within 2 lr: Adam's step moves a
    weight by lr g / (|g| + 1e-8), whose slope at such g is up to lr / 1e-8,
    so there fp32 rounding of g in the last bits shows (the rule of
    tests/test_torch_atlas.py)."""
    tiny = np.zeros(p.shape, bool)
    for g in grads:
        tiny |= np.abs(g.reshape(p.shape)) < 1e-6
    assert np.abs(p - want)[tiny].max(initial=0) <= 2 * lr
    np.testing.assert_allclose(p[~tiny], want[~tiny], rtol=rtol, atol=atol)


@pytest.mark.parametrize('shape', EDLORA_CASES)
def test_edlora_steps_match_jax(runs, shape):
    """The sharded steps against the port's own single-device steps with
    tests/test_edlora_shard.py's limits (what that test holds the JAX
    package's sharded step to: the same steps in one framework): the
    losses and the first step's reduced gradients before the clip; and,
    against both, each group's last gradients and updated values within
    EDLORA_JAX_L2, the port's own rounding against the JAX package (and
    the losses within rtol 1e-5)."""
    ref = runs['jax']['edlora']
    got = _by_rank(runs, ('edlora', shape))
    single = got[0]['single']
    for r in got:
        np.testing.assert_allclose(r['losses'], single['losses'],
                                   rtol=1e-5)
        np.testing.assert_allclose(r['losses'], ref['losses'], rtol=1e-5)
        assert len(r['grads']) == len(ref['grads']) == len(single['grads'])
        for i, (g, s) in enumerate(zip(r['grads_first'],
                                       single['grads_first'])):
            np.testing.assert_allclose(g, s, rtol=2e-4, atol=1e-7,
                                       err_msg=f'first step grad {i}')
        # the last step's gradients and the params after it come after
        # Adam's first step, which amplifies the rounding of a gradient
        # near 0 (by lr / 1e-8 at most): held as a whole, as against the
        # JAX package
        for key in ('grads', 'after'):
            for name, a in _groups(r[key]).items():
                assert _rel_l2(a, _groups(single[key])[name]) \
                    <= EDLORA_JAX_L2[key], (key, name)
        for key in ('grads', 'after'):
            want = _groups([a.reshape(b.shape) for a, b in
                            zip(ref[key], r[key])])
            for name, a in _groups(r[key]).items():
                assert _rel_l2(a, want[name]) <= EDLORA_JAX_L2[key], (
                    key, name)


@pytest.mark.parametrize('shape', EDLORA_CASES)
def test_edlora_ranks_end_bit_equal(runs, shape):
    """The factors and the concept embeddings after the two steps."""
    after = [r['after'] for r in _by_rank(runs, ('edlora', shape))]
    assert len(after) == shape[2]
    for a in after[1:]:
        for x, y in zip(a, after[0]):
            np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------------ atlas
def _atlas_params(runs, r):
    return {n: jax_params_to_state_dict(runs['jax']['atlas']['params'][n])
            for n in r['after']}


def test_atlas_steps_match_jax(runs):
    """Loss terms rtol 5e-5 and params rtol 1e-4 / atol 3e-5 (the JAX
    test's), entries whose reduced gradient is below 1e-6 held to 2 lr
    (`_adam_close`)."""
    ref = runs['jax']['atlas']
    lr = runs['atlas_lr']
    for r in _by_rank(runs, ('atlas', (2, 1, 1))):
        assert set(r['losses']) == set(ref['losses'])
        for k, v in ref['losses'].items():
            np.testing.assert_allclose(r['losses'][k], v, rtol=5e-5,
                                       err_msg=k)
        np.testing.assert_allclose(r['inverse'], ref['inverse'], rtol=5e-5)
        want = _atlas_params(runs, r)
        for n, sd in r['after'].items():
            for k, v in sd.items():
                _adam_close(v, want[n][k].numpy(), (r['grads'][n][k],), lr,
                            1e-4, 3e-5)


def test_atlas_ranks_end_bit_equal(runs):
    after = [r['after'] for r in _by_rank(runs, ('atlas', (2, 1, 1)))]
    assert len(after) == 2
    for n, sd in after[0].items():
        for k, v in sd.items():
            np.testing.assert_array_equal(after[1][n][k], v)


# ------------------------------------------------------------ fault plants
def _plant_caught(runs, name) -> bool:
    """Whether the plant's readings fail the limits of the tests above."""
    case, shape = cases.PLANT_CASES[name]
    got = _by_rank(runs, ('plant', name))
    assert len(got) == int(np.prod(shape))
    if case.startswith('blocks'):
        return max(max(r.values()) for r in got) > BLOCK_TOL
    if case == 'atlas':
        ref = runs['jax']['atlas']['losses']
        return any(not np.isclose(r['losses'][k], v, rtol=5e-5, atol=0)
                   for r in got for k, v in ref.items())
    if case == 'edlora':
        ref = _by_rank(runs, ('edlora', shape))[0]['single']['grads']
        return any(not np.allclose(g, w, rtol=2e-4, atol=1e-7)
                   for r in got for g, w in zip(r['grads'], ref))
    ref = jax_params_to_state_dict({'params': runs['jax'][case]['grads']})
    return any(not np.allclose(g, ref[n].numpy(), rtol=5e-4,
                               atol=5e-5 * float(np.abs(ref[n].numpy())
                                                 .max()))
               for r in got for n, g in r['grads'].items())


@pytest.mark.parametrize('name', sorted(cases.PLANT_CASES))
def test_fault_plant_is_caught(runs, name):
    assert _plant_caught(runs, name), name


# ------------------------------------------------------------------- CLIs
def _tree_files(root: Path) -> list:
    """The files under `root`, a log's start time taken out of its name."""
    return sorted(re.sub(r'_\d{8}_\d{6}\.log$', '.log',
                         str(p.relative_to(root)))
                  for p in root.rglob('*') if p.is_file())


def _ran(runs, cli) -> tuple:
    """The roots of the CLI's run under torchrun and alone (both ended)."""
    d, s = runs['cli'][(cli, 'dist')], runs['cli'][(cli, 'single')]
    assert d['code'] == 0, d['tail']
    assert s['code'] == 0, s['tail']
    return d['root'], s['root']


def _same_tree(dist_root, single_root, runs: int = 1) -> None:
    """Rank 0 alone wrote: the sharded run's tree has the single run's
    files (one experiment, one log a run) and nothing else."""
    files = [_tree_files(r) for r in (dist_root, single_root)]
    assert files[0] == files[1]
    assert not any('archived' in f for f in files[0])
    assert sum(f.endswith('.log') for f in files[0]) == runs


def _load(root, pattern):
    paths = sorted(root.glob(pattern))
    assert len(paths) == 1, pattern
    return torch.load(paths[0], weights_only=True)


def _flat(tree, prefix=''):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f'{prefix}{k}.'))
        return out
    return {prefix[:-1]: tree}


def _same_states(d, s, patterns) -> None:
    for pattern in patterns:
        a, b = _flat(_load(d, pattern)), _flat(_load(s, pattern))
        assert sorted(a) == sorted(b)
        for k in a:
            if torch.is_tensor(a[k]):
                assert torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize('step', [2, 4])
def test_train_distributed_equals_the_single_process(runs, step):
    """Every rank runs the same unsharded steps: the adapter after 2 steps
    and after --resume to 4 (each rank restores the train state rank 0
    wrote), and the train state at the end, equal the single process's bit
    for bit; each run wrote one log."""
    _ran(runs, 'train')
    d, s = _ran(runs, 'train_resume')
    _same_tree(d, s, runs=2)
    _same_states(d, s, [f'experiments/*/models/models_{step}/adapter.pth']
                 + ['experiments/*/models/train_state.pth'] * (step == 4))
    state = _load(d, 'experiments/*/models/train_state.pth')
    assert state['global_step'] == 4


def test_train_edlora_shard_equals_the_single_process(runs):
    """tp = 2: the checkpoint within fp32 rounding of the single process's
    (the partial products summed in another order, two steps), and the
    concept config the same."""
    d, s = _ran(runs, 'train_edlora')
    _same_tree(d, s)
    pattern = 'experiments/*/models/models_2/'
    a = _flat(_load(d, pattern + 'edlora_model-latest.pth'))
    b = _flat(_load(s, pattern + 'edlora_model-latest.pth'))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_allclose(a[k].numpy(), b[k].numpy(), rtol=2e-4,
                                   atol=1e-5, err_msg=k)
    cfg = [json.loads(next(r.glob(pattern + 'new_concept_cfg.json'))
                      .read_text()) for r in (d, s)]
    assert cfg[0] == cfg[1]


def test_train_atlas_shard_equals_the_single_process(runs):
    """dp = 2: the nets after pretraining and 4 iterations within fp32
    rounding of the single process's (the points' sums split in two), but
    for a few hash-table entries that Adam moves on a gradient near 0."""
    d, s = _ran(runs, 'train_atlas')
    _same_tree(d, s)
    a = _flat(_load(d, 'experiments/*/models/models_4.pth'))
    b = _flat(_load(s, 'experiments/*/models/models_4.pth'))
    assert sorted(a) == sorted(b)
    for k in a:
        x, y = a[k].numpy(), b[k].numpy()
        far = ~np.isclose(x, y, rtol=1e-3, atol=1e-4)
        # Adam moves an entry whose gradient is near 0 by up to lr a step
        # on either side of the rounding: a few of the 2^19-entry hash
        # table's, by at most 2 lr an iteration (pretraining leaves the
        # table alone), the rest within rounding
        assert far.mean() <= 1e-5 and \
            np.abs(x - y).max() <= 2 * ATLAS_CLI_LR * ATLAS_CLI_ITERS, k


@pytest.mark.parametrize('cli', ['train_edlora', 'train_atlas'])
def test_shard_refuses_another_world(cli, tmp_path, monkeypatch):
    """--shard 2 in a world of one process is refused before anything
    runs (no process group, no experiment directory)."""
    import importlib
    mod = importlib.import_module(f'videoswap_torch.{cli}')
    monkeypatch.delenv('WORLD_SIZE', raising=False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(ValueError, match='--shard 2 needs 2 ranks; the '
                                         'world has 1'):
        mod.main(['-opt', str(tmp_path / 'missing.yml'), '--shard', '2',
                  '--device', 'cpu'])
    assert not torch.distributed.is_initialized()
    assert list(tmp_path.iterdir()) == []
