"""The port's swap CLI (`python3 -m videoswap_torch.test -opt <yaml>
--device cpu`) on a tiny config that the test writes, in fp32 on the CPU.

The experiment tree is chip_smoke.py's (`write_experiment_tree`,
`write_clip`): the models' weights under the published file and key names
(the motion modules split off into `mm_sd_v14.ckpt`, the VAE's attention
under the deprecated names), a generated CLIP vocabulary, the adapter's
`.pth`, an ED-LoRA file, PNG frames and two TAP.pth files. The config has
two swaps: one with its own `tap_path` (the second TAP file) and the
DPM-Solver++ sampler, one with `select_point`; `visualize_point` and
`visualize_attention` on, and `path.clip_model_path` a CLIP directory
(relative to the root) with a tiny config.json and no weights.

The CLI's frames must equal, bit for bit, those of `validation` called
directly on the CLI's models (the same arithmetic on the same CPU); every
tensor must load as written (0 missing, 0 unused); each swap's `_vispoint`
frames may differ from its frames only inside the discs of its own
conditions' visible, selected points (chip_smoke.vispoint_errors); the
frame files, metrics.json (with CLIP scores of the source and each swap)
and each swap's attention heatmaps must be written.
"""

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from videoswap_torch.builders import build_models
from videoswap_torch.data.frame_point_dataset import load_tap_file
from videoswap_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
FRAMES, H, W, CLIP_FRAMES = 2, 64, 96, 8
UNET = {'block_out_channels': [8, 8, 16, 16], 'attention_head_dim': 2,
        'cross_attention_dim': 16, 'norm_num_groups': 4, 'motion_heads': 2}
MODELS_OPT = {
    'unet': {'unet_cfg': UNET},
    'adapter': {'adapter_cfg': {'embedding_channels': 12,
                                'channels': [8, 8, 16, 16], 'mid_dim': 8}},
    'vae_cfg': {'block_out_channels': [4, 4, 8, 8], 'norm_groups': 4},
    'text_encoder_cfg': {'hidden_size': 16, 'num_layers': 1, 'num_heads': 2,
                         'intermediate_size': 16},
}
CONFIG = """\
name: tiny_cli
manual_seed: 3
mixed_precision: 'no'
datasets:
  type: SingleVideoPointDataset
  path: {tree}/frames
  tap_path: {tree}/TAP.pth
  prompt: a man is walking in front of trees and grass
  num_frames: {frames}
  total_frames: {clip_frames}
  video_transform:
    - {{ type: Resize, size: [{h}, {w}] }}
    - {{ type: ToTensor }}
    - {{ type: Normalize, mean: [ 0.5 ], std: [ 0.5 ] }}
models:
  unet:
    inference_config_path: {root}/options/model_cfg/inference.yml
    motion_module_path: {tree}/mm_sd_v14.ckpt
    unet_cfg: {{ block_out_channels: [8, 8, 16, 16], attention_head_dim: 2,
                cross_attention_dim: 16, norm_num_groups: 4,
                motion_heads: 2 }}
  adapter:
    adapter_cfg:
      embedding_channels: 12
      channels: [8, 8, 16, 16]
      mid_dim: 8
  vae_cfg: {{ block_out_channels: [4, 4, 8, 8], norm_groups: 4 }}
  text_encoder_cfg: {{ hidden_size: 16, num_layers: 1, num_heads: 2,
                      intermediate_size: 16 }}
path:
  pretrained_model_path: {tree}/pretrained
  pretrained_adapter_path: {tree}/adapter.pth
  clip_model_path: clip
val:
  save_type: frame
  editing_config:
    use_invertion_latents: true
    use_blend: false
    guidance_scale: 7.5
    visualize_point: True
    visualize_attention: true
    editing_prompts:
      man_to_hermione:
        replace: man -> <hermione1> <hermione2>
        lora_path: {tree}/edlora_hermione.pth---0.7
        tap_path: {tree}/TAP_other.pth
        select_point: ~
        sampler: dpmpp_2m
      man_to_dog:
        replace: man -> dog
        select_point: [head, tail]   # two of the tracked points
    negative_prompt: low quality
    num_inference_steps: 3
    t2i_guidance_scale: 0.5
    t2i_end: 0.5
"""


# a CLIP directory's config.json at a tiny size (random weights)
TINY_CLIP = {
    'projection_dim': 16,
    'vision_config': {'image_size': 28, 'patch_size': 14, 'hidden_size': 32,
                      'num_hidden_layers': 1, 'num_attention_heads': 4,
                      'intermediate_size': 64},
    'text_config': {'vocab_size': 49408, 'hidden_size': 32,
                    'num_hidden_layers': 1, 'num_attention_heads': 4,
                    'max_position_embeddings': 77, 'intermediate_size': 64}}


def _chip_smoke():
    path = ROOT / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope='module')
def run(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)     # beside the other test workers
    try:
        cs = _chip_smoke()
        tree = tmp_path_factory.mktemp('tree')
        built = build_models({'models': MODELS_OPT}, device='cpu', seed=11)
        written = cs.write_experiment_tree(
            built, tree, {'edlora_hermione.pth': cs.BLEND_CONCEPTS},
            dtype=torch.float32)
        cs.write_clip(tree, CLIP_FRAMES, 72, {'TAP.pth': (H, W),
                                              'TAP_other.pth': (H, W)},
                      emb=12)
        cs.write_clip_dir(tree / 'clip', TINY_CLIP)
        yml = tree / 'tiny_cli.yml'
        yml.write_text(CONFIG.format(tree=tree, root=ROOT, frames=FRAMES,
                                     h=H, w=W, clip_frames=CLIP_FRAMES))
        from videoswap_torch.test import test
        out = test(str(tree), str(yml), device='cpu')
        ds = out['dataset']
        direct = out['pipeline'].validation(
            ds.get_frames(), ds.get_conditions(), ds.prompt,
            out['opt']['val']['editing_config'], train_dataset=ds,
            output_type='uint8')
        yield cs, tree, written, out, direct
    finally:
        torch.set_num_threads(n)


def test_cli_frames_equal_direct_validation(run):
    _, _, _, out, direct = run
    assert sorted(out['results']) == sorted(direct) == [
        'man_to_dog', 'man_to_dog_vispoint', 'man_to_hermione',
        'man_to_hermione_vispoint']
    for key, frames in out['results'].items():
        assert frames.shape == (FRAMES, H, W, 3) and frames.dtype == np.uint8
        np.testing.assert_array_equal(frames, direct[key])


def test_cli_loads_every_tensor_as_written(run):
    cs, _, written, out, _ = run
    pipe = out['pipeline']
    errs = cs.load_errors({k: getattr(pipe, k) for k in written}, written,
                          out['load_report'])
    assert sorted(errs) == ['adapter', 'text_encoder', 'unet', 'vae']
    assert not cs.load_fails(errs), errs
    assert type(pipe.tokenizer).__name__ == 'CLIPBPETokenizer'


def test_cli_swaps_take_their_own_conditions(run):
    """man_to_hermione's points are its own tap_path's, all of them;
    man_to_dog's the dataset's, the two selected. The overlays differ
    from the frames only inside those points' discs."""
    cs, tree, _, out, _ = run
    ds = out['dataset']
    other = load_tap_file(str(tree / 'TAP_other.pth'))
    own = ds.get_conditions()
    assert not np.array_equal(other['pred_tracks'][ds.select_id],
                              own['pred_tracks'])
    cases = {'man_to_hermione': dict(ds.get_conditions(
                 str(tree / 'TAP_other.pth')), index_list=None),
             'man_to_dog': dict(own, index_list=[
                 own['point_name2id'][n] for n in ('head', 'tail')])}
    for key, cond in cases.items():
        errs = cs.vispoint_errors(out['results'][key],
                                  out['results'][key + '_vispoint'], cond)
        assert not cs.vispoint_fails(errs), (key, errs)
    # the selection matters: with every point, man_to_dog's overlay
    # changed pixels outside the allowed discs
    errs = cs.vispoint_errors(out['results']['man_to_dog'],
                              out['results']['man_to_dog_vispoint'],
                              dict(own, index_list=[0]))
    assert errs['outside'] > 0


def test_cli_writes_frames_and_metrics(run):
    _, _, _, out, _ = run
    vis = Path(out['opt']['path']['visualization'])
    metrics = load_config(str(vis / 'metrics.json'))   # JSON is YAML
    assert sorted(metrics) == ['man_to_dog', 'man_to_dog_vispoint',
                               'man_to_hermione', 'man_to_hermione_vispoint',
                               'source']
    for key in ('source', 'man_to_hermione', 'man_to_hermione_vispoint',
                'man_to_dog', 'man_to_dog_vispoint'):
        assert len(list((vis / key / f'frames_{key}').glob('*.png'))) \
            == FRAMES
    t = out['timings']
    assert {'load', 'dataset', 'inversion', 'man_to_hermione',
            'man_to_dog', 'save'} <= set(t)
    assert len(t['man_to_dog']['step_s']) == 3 \
        and t['man_to_dog']['decode_s'] > 0


@pytest.mark.parametrize('argv, match', [
    (['--shard', '1,1,8'], 'Queue 1 item 9'),
    (['--device', 'cuda'], 'no CUDA device'),
])
def test_cli_refuses_what_is_not_ported(tmp_path, argv, match):
    """`--shard` and, here, the default device are refused with a message,
    before any work."""
    yml = tmp_path / 'x.yml'
    yml.write_text('name: x\n')
    res = subprocess.run(
        [sys.executable, '-m', 'videoswap_torch.test', '-opt', str(yml)]
        + argv, cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert res.returncode != 0 and match in res.stderr, res.stderr[-2000:]


@pytest.mark.parametrize('fault, module, name', [
    ('dpm_first_order', 'videoswap_torch.pipelines.videoswap_pipeline',
     'dpm_pp_2m_step'),
    ('loader_drops_motion_module', 'videoswap_torch.models.converters',
     'merge_motion_module'),
    ('vispoint_ignores_index_list',
     'videoswap_torch.pipelines.videoswap_pipeline', 'overlay_points'),
])
def test_recipe_fault_plants_reach_the_cli_path(fault, module, name):
    """scripts/fault_control.py's recipe faults replace the name the CLI's
    path looks up (the pipeline's own import, the builder's module
    attribute) while planted, and put it back after: a plant that misses
    it would leave the path sound and the control without its fault."""
    import importlib
    sys.modules.setdefault('chip_smoke', _chip_smoke())
    spec = importlib.util.spec_from_file_location(
        'fault_control', ROOT / 'scripts' / 'fault_control.py')
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    mod = importlib.import_module(module)
    sound = getattr(mod, name)
    with fc.RECIPE_FAULTS[fault]():
        assert getattr(mod, name) is not sound
    assert getattr(mod, name) is sound


def test_cli_dumps_attention_and_scores_clip(run):
    """visualize_attention writes each swap's heatmap strip (the one-pass
    dump: the config has no latent blend); clip_model_path scores the
    source and each swap, not the overlays."""
    _, _, _, out, _ = run
    vis = Path(out['opt']['path']['visualization'])
    metrics = out['metrics']
    for key in ('man_to_hermione', 'man_to_dog'):
        assert (vis / f'{key}_attention' / 'cross_attention.png').is_file()
        assert 0.0 <= metrics[key]['clip_score'] <= 100.0
        assert 'clip_score' not in metrics[key + '_vispoint']
    assert 'clip_score' in metrics['source']
    assert 'metrics' in out['timings']
