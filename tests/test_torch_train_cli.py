"""The port's adapter-training CLI (`python3 -m videoswap_torch.train -opt
<yaml> [--resume] --device cpu`) on the smoke clip
(`scripts/make_smoke_dataset.make(frames=4, size=64)`) with
tests/test_cli_e2e.py's tiny models, fp32 on the CPU.

One module fixture trains 2 steps, then resumes to 4 with validation at
step 4 (the 2 + 2 steps of chip_smoke.py's train_recipe phase). Checked,
each exactly (the same arithmetic on the same CPU): the experiment tree;
the resumed run's adapter, AdamW moments and step against the first run's;
the CLI's first 2 steps against `VideoSwapTrainer.step` called directly;
the adapter file against the JAX package's strict loader. Then the
step-indexed checkpoint manager's retention against the JAX test's, the
CLI's orbax backend, the `MessageLogger` line against the JAX package's,
and the imports and refusals of the CLI.
"""

import json
import os
import subprocess
import sys
import types
from pathlib import Path
from unittest import mock

import numpy as np
import pytest
import torch

from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from videoswap_torch.builders import build_models, load_adapter_checkpoint
from videoswap_torch.data import build_dataset
from videoswap_torch.models import SparsePointAdapter
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.pipelines import VideoSwapTrainer
from videoswap_torch.train import state_snapshot, train
from videoswap_torch.utils.checkpointing import (CheckpointManager,
                                                 restore_pytree, save_pytree)

ROOT = Path(__file__).resolve().parents[1]
SEED = 7
# tests/test_cli_e2e.py's TINY_MODELS
TINY_MODELS = {
    'unet': {'unet_cfg': {
        'block_out_channels': [16, 32, 32, 32], 'attention_head_dim': 4,
        'cross_attention_dim': 24, 'norm_num_groups': 8, 'motion_heads': 4}},
    'adapter': {'adapter_cfg': {
        'embedding_channels': 12, 'channels': [16, 32, 32, 32],
        'mid_dim': 8}},
    'vae_cfg': {'block_out_channels': [8, 8, 16, 16], 'norm_groups': 8},
    'text_encoder_cfg': {'hidden_size': 24, 'num_layers': 1,
                         'num_heads': 4, 'intermediate_size': 32},
}
TUNE = {'drop_rate': 0.2, 'min_timestep': 0.5, 'loss_type': 'local'}
OPTIMIZER = {'type': 'AdamW', 'lr': 5.0e-4, 'weight_decay': 0.01,
             'betas': [0.9, 0.999]}


def _config(data: Path, name: str, total_iter: int, **logger) -> dict:
    return {
        'name': name, 'manual_seed': SEED, 'mixed_precision': 'no',
        'datasets': {
            'type': 'SingleVideoPointDataset',
            'path': str(data / 'frames'), 'tap_path': str(data / 'TAP.pth'),
            'prompt': 'a cat walking on a gradient floor',
            'num_frames': 2, 'total_frames': 4,
            'video_transform': [
                {'type': 'Resize', 'size': 64}, {'type': 'ToTensor'},
                {'type': 'Normalize', 'mean': [0.5], 'std': [0.5]}],
            'batch_size_per_gpu': 1, 'dataset_enlarge_ratio': 4},
        'models': TINY_MODELS, 'path': {},
        'train': {'train_pipeline': 'VideoSwapTrainer',
                  'optimizer': OPTIMIZER, 'tune_cfg': TUNE,
                  'lr_scheduler': 'constant', 'total_iter': total_iter,
                  'warmup_iter': 0},
        'val': {'val_pipeline': 'VideoSwapPipeline', 'save_type': 'frame',
                'val_freq': 4, 'editing_config': {
                    'use_invertion_latents': True, 'use_blend': False,
                    'num_inference_steps': 2, 'guidance_scale': 7.5,
                    't2i_guidance_scale': 0.5, 't2i_start': 0.0,
                    't2i_end': 0.5, 'visualize_point': True,
                    'editing_prompts': {'cat2dog': {
                        'replace': 'cat -> dog', 'select_point': None,
                        'tap_path': None}}}},
        'logger': {'print_freq': 1, 'save_checkpoint_freq': 2, **logger},
    }


def _write(path: Path, cfg: dict) -> str:
    path.write_text(json.dumps(cfg, indent=1))       # JSON is YAML
    return str(path)


def _args(opt, resume=False):
    return types.SimpleNamespace(opt=opt, resume=resume, device='cpu',
                                 distributed=False)


def _assert_states_equal(a, b):
    """Two (nested) state dicts equal, tensors bit for bit."""
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype
        assert torch.equal(a.cpu(), b.cpu())
    elif isinstance(a, dict):
        assert isinstance(b, dict) and sorted(a) == sorted(b), (a, b)
        for k in a:
            _assert_states_equal(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_states_equal(x, y)
    else:
        assert a == b


@pytest.fixture(scope='module')
def data(tmp_path_factory):
    sys.path.insert(0, str(ROOT))
    from scripts.make_smoke_dataset import make
    d = tmp_path_factory.mktemp('data')
    make(str(d), frames=4, size=64)
    return d


@pytest.fixture(scope='module')
def runs(tmp_path_factory, data):
    n = torch.get_num_threads()
    torch.set_num_threads(2)     # beside the other test workers
    try:
        root = tmp_path_factory.mktemp('root')
        cfg2 = _config(data, 'smoke_train', 2)
        first = train(str(root), _args(_write(root / 'train2.yml', cfg2)))
        saved = state_snapshot(first['trainer'])
        second = train(str(root), _args(
            _write(root / 'train4.yml', _config(data, 'smoke_train', 4)),
            resume=True))
        yield root, cfg2, first, saved, second
    finally:
        torch.set_num_threads(n)


def test_cli_writes_checkpoints_and_validation(runs):
    root, _, first, _, second = runs
    exp = root / 'experiments' / 'smoke_train'
    models = exp / 'models'
    assert (models / 'models_2' / 'adapter.pth').is_file()
    assert (models / 'models_4' / 'adapter.pth').is_file()
    assert (models / 'train_state.pth').is_file()
    vis = exp / 'visualization' / 'iter_4'
    for key in ('cat2dog', 'cat2dog_vispoint'):
        assert len(list((vis / key / f'frames_{key}').glob('*.png'))) == 2
    assert list(second['validation']) == [4]
    assert first['validation'] == {}
    assert len(first['losses']) == len(second['losses']) == 2
    assert all(np.isfinite(first['losses'] + second['losses']))


def test_resume_restores_adapter_moments_and_step(runs):
    """The resumed run starts at step 2 from the first run's adapter and
    AdamW state (moments, step counts, hyper-parameters), bit for bit,
    in the same experiment directory."""
    root, _, _, saved, second = runs
    assert second['start_step'] == 2
    state = second['start_state']['optimizer']['state']
    assert len(state) == len(list(second['trainer'].adapter.parameters()))
    assert all(float(s['step']) == 2.0 for s in state.values())
    _assert_states_equal(second['start_state'], saved)
    assert [p.name for p in (root / 'experiments').iterdir()] == \
        ['smoke_train']
    assert (root / 'experiments' / 'smoke_train' / 'models' / 'models_2'
            ).is_dir()


def test_cli_equals_direct_trainer_steps(runs):
    """The CLI's first 2 steps against `VideoSwapTrainer.step` called
    directly on models built from the same config and seed, the batch
    made here from the dataset: the losses and the adapter, bit for
    bit."""
    root, cfg2, first, saved, _ = runs
    built = build_models(cfg2, str(root), device='cpu', seed=SEED)
    trainer = VideoSwapTrainer(**built, tune_cfg=TUNE,
                               optimizer_cfg=OPTIMIZER)
    _assert_states_equal(trainer.adapter.state_dict(),
                         first['start_state']['adapter'])
    item = build_dataset(cfg2['datasets'])[0]
    tok = built['tokenizer']
    batch = {'input_ids': torch.tensor(tok(
                 [item['prompt']], padding='max_length',
                 max_length=tok.model_max_length).input_ids),
             'pred_tracks': torch.from_numpy(item['pred_tracks']),
             'point_embedding': torch.from_numpy(item['point_embedding'])}
    with torch.no_grad():
        batch['latent_mean'], batch['latent_logvar'] = \
            trainer.vae.encode_video_moments(
                torch.from_numpy(item['pixels'])[None])
    gen = torch.Generator().manual_seed(SEED)
    losses = [trainer.step(batch, gen).item() for _ in range(2)]
    assert losses == first['losses']
    _assert_states_equal(trainer.adapter.state_dict(), saved['adapter'])


def test_adapter_file_loads_in_both_packages(runs):
    """`models_4/adapter.pth` loads strictly into a fresh adapter of the
    port and through the JAX package's loader (strict `convert_adapter`),
    and both give the trained weights exactly."""
    import jax
    import jax.numpy as jnp
    from videoswap_tpu.builders import load_adapter_checkpoint as j_load
    from videoswap_tpu.models import (AdapterConfig as JAdapterConfig,
                                      SparsePointAdapter as JAdapter)
    root, _, _, _, second = runs
    path = str(root / 'experiments' / 'smoke_train' / 'models' / 'models_4'
               / 'adapter.pth')
    trained = second['trainer'].adapter.state_dict()
    fresh = SparsePointAdapter(second['trainer'].adapter.cfg)
    assert load_adapter_checkpoint(path, fresh) == ([], [])
    _assert_states_equal(fresh.state_dict(), trained)

    cfg = TINY_MODELS['adapter']['adapter_cfg']
    jadapter = JAdapter(cfg=JAdapterConfig(**{
        k: tuple(v) if isinstance(v, list) else v for k, v in cfg.items()}))
    template = jax.eval_shape(
        lambda k, t, e: jadapter.init(k, t, (64, 64), e),
        jax.random.PRNGKey(0), jnp.zeros((2, 3, 2)), jnp.zeros((3, 12)))
    template = jax.tree.map(lambda s: np.zeros(s.shape, s.dtype),
                            template['params'])
    loaded = jax_params_to_state_dict(j_load(path, template))
    _assert_states_equal(loaded, trained)


def test_manager_retention_and_oneshot(tmp_path):
    """tests/test_checkpointing.py::test_manager_roundtrip_and_retention's
    saves (steps 10, 20, 30, max_to_keep=2) keep the steps it expects; a
    pruned step and a half-written one are not restored."""
    tree = {'adapter': {'w': torch.randn(8, 16),
                        'b': torch.randn(16).bfloat16()},
            'optimizer': {'state': {0: {'step': torch.tensor(3.0)}},
                          'param_groups': [{'lr': 1e-3,
                                            'betas': (0.9, 0.999)}]}}
    with CheckpointManager(str(tmp_path / 'ckpt'), max_to_keep=2) as mgr:
        for step in (10, 20, 30):
            mgr.save(step, dict(tree, global_step=step))
        (tmp_path / 'ckpt' / '40.tmp-killed').mkdir()
        assert mgr.latest_step() == 30
        assert mgr.all_steps() == [20, 30]
        out = mgr.restore()
        assert out['global_step'] == 30
        _assert_states_equal(out, dict(tree, global_step=30))
        with pytest.raises(FileNotFoundError):
            mgr.restore(step=10)
    save_pytree(str(tmp_path / 'one'), tree)
    _assert_states_equal(restore_pytree(str(tmp_path / 'one')), tree)


def test_cli_orbax_backend_resumes(tmp_path, data):
    """`logger.checkpoint_backend: orbax`: step-indexed saves, pruned to
    max_to_keep, and `--resume` from the latest, in place (the JAX
    package's test_train_cli_orbax_backend)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        cfg = _config(data, 'smoke_orbax', 2, save_checkpoint_freq=1,
                      checkpoint_backend='orbax', max_to_keep=2)
        del cfg['val']
        first = train(str(tmp_path), _args(_write(tmp_path / 'o2.yml', cfg)))
        odir = tmp_path / 'experiments' / 'smoke_orbax' / 'models' / 'orbax'
        assert CheckpointManager(str(odir)).all_steps() == [1, 2]
        saved = state_snapshot(first['trainer'])
        cfg['train']['total_iter'] = 3
        second = train(str(tmp_path), _args(
            _write(tmp_path / 'o3.yml', cfg), resume=True))
    finally:
        torch.set_num_threads(n)
    assert second['start_step'] == 2 and len(second['losses']) == 1
    _assert_states_equal(second['start_state'], saved)
    assert CheckpointManager(str(odir)).all_steps() == [2, 3]
    assert not (tmp_path / 'experiments' / 'smoke_orbax' / 'models' /
                'train_state.pth').exists()


def test_message_logger_line_equals_jax():
    from videoswap_tpu.utils.logger import MessageLogger as JMessageLogger
    from videoswap_torch.utils.logger import MessageLogger
    opt = {'name': 'a_long_experiment_name_past_thirty_characters',
           'train': {'total_iter': 100}}
    log_vars = {'iter': 40, 'lrs': [5e-4], 'total_loss': 0.0123456,
                'step_time': 0.6131}
    lines = []
    for cls in (JMessageLogger, MessageLogger):
        with mock.patch('time.time', side_effect=[1000.0, 1024.25]):
            ml = cls(opt, start_iter=10)
            ml.logger = types.SimpleNamespace(info=lines.append)
            ml(dict(log_vars))
    assert lines[0] == lines[1], lines
    assert lines[1].startswith('[a_long_experiment_name_past_th..][Iter:')


def test_train_cli_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'orbax', 'videoswap_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import videoswap_torch.train, videoswap_torch.utils.checkpointing\n"
        "import videoswap_torch.utils.profiling\n"
        "loaded = [m for m in sys.modules if m.split('.')[0] in\n"
        "          ('jax', 'flax', 'orbax', 'videoswap_tpu')\n"
        "          and sys.modules[m] is not None]\n"
        "assert not loaded, loaded\n"
        "print('ok')\n")
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')


@pytest.mark.parametrize('argv, match', [
    (['--device', 'cuda'], 'no CUDA device'),
])
def test_train_cli_refuses_what_is_not_ported(tmp_path, argv, match):
    """Here, the default device is refused with a message, before any
    work."""
    yml = tmp_path / 'x.yml'
    yml.write_text('name: x\n')
    res = subprocess.run(
        [sys.executable, '-m', 'videoswap_torch.train', '-opt', str(yml)]
        + argv, cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=str(ROOT)))
    assert res.returncode != 0 and match in res.stderr, res.stderr[-2000:]
    assert not (tmp_path / 'experiments').exists()



def _load(name: str, path: Path):
    import importlib.util
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_resume_fault_plant_is_seen(runs):
    """scripts/fault_control.py's resume_fresh_adamw, planted, replaces the
    name the CLI's resume looks up: a resume at the last step (no step
    left) then starts from the saved adapter and an empty AdamW state,
    which the resume check tells from the sound resume's."""
    import videoswap_torch.train as train_cli
    root, _, _, _, second = runs
    sys.modules.setdefault('chip_smoke',
                           _load('chip_smoke', ROOT / 'chip_smoke.py'))
    fc = _load('fault_control', ROOT / 'scripts' / 'fault_control.py')
    saved = state_snapshot(second['trainer'])
    sound = train_cli.load_train_state
    args = _args(str(root / 'train4.yml'), resume=True)
    with fc.TRAIN_RECIPE_FAULTS['resume_fresh_adamw']():
        assert train_cli.load_train_state is not sound
        planted = train(str(root), args)
    assert train_cli.load_train_state is sound
    assert planted['start_step'] == 4 and planted['losses'] == []
    assert planted['start_state']['optimizer']['state'] == {}
    _assert_states_equal(planted['start_state']['adapter'], saved['adapter'])
    _assert_states_equal(train(str(root), args)['start_state'], saved)
