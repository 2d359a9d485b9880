"""The port's semantic-point CLI (`videoswap_torch.extract_semantic_point`)
on the CPU, fp32, against the JAX package's `propagate_general_keypoint`,
`propagate_human_keypoint` and `extract_point_embedding` (the root
extract_semantic_point.py) with the same weights:

- an experiment tree written by chip_smoke.py's `write_experiment_tree`
  from a tiny U-Net (motion modules on), VAE and CLIP text model whose
  seeded weights both packages load (the JAX side straight from its tree,
  the port from the files through `--model_opt`), and the tree's generated
  CLIP vocabulary, which both featurizers use;
- an 8-frame 64x96 clip of chip_smoke.py's `atlas_clip` (a textured disk
  over a textured background, known motion) with a keyframe annotation at
  frame 4: three named points and one empty entry;
- the object path with the DIFT tracker (no CoTracker checkpoint on disk),
  with the native CoTracker ($VS_COTRACKER_CKPT: chip_smoke.py's synthetic
  checkpoint; on both sides, for the CPU's time, the frames resized to
  96x128 instead of 384x512 and 2 refinements a window instead of 6, as
  the JAX package's own test of its predictor runs), and the human path
  (3 frames, `--pose_ckpt`: chip_smoke.py's synthetic body_pose_model.pth
  calibrated on the clip's first frame, three peaks a part there, from
  which both decodes assemble people); the human path's embedding on
  known tracks is held to the JAX package's directly.

The port's featurizer adds the JAX package's noise draw (the two packages'
generators differ by design). The TAP files must have the same keys, dtypes
and names, tracks within 0.01 px and embeddings within 1e-4 of the largest
entry; the port's FramePointDataset reads the written file.
"""

import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import extract_semantic_point as jesp
from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from tests.test_torch_cotracker import _chip_smoke
from videoswap_tpu.models import (AnimateDiffUNet3DModel as JUNet,
                                  UNet3DConfig as JUNetConfig)
from videoswap_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_tpu.preprocess import cotracker_native as jcot
from videoswap_tpu.preprocess.dift import SDFeaturizer as JFeaturizer
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_torch import extract_semantic_point as tesp
from videoswap_torch.builders import build_models
from videoswap_torch.data.frame_point_dataset import SingleVideoPointDataset
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.preprocess import cotracker_native as tcot
from videoswap_torch.utils.png import write_png

UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=24, norm_num_groups=8, motion_heads=4)
CLIP_KW = dict(vocab_size=49408, hidden_size=24, num_layers=1, num_heads=4,
               intermediate_size=32)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)
ADAPTER_KW = dict(embedding_channels=32, channels=[16, 32, 32, 32],
                  mid_dim=8)
FRAMES, H, W, KEY = 8, 64, 96, 4
ANNOTATION = {'head': [20, 30], 'body': [35, 40], 'empty': [],
              'tail': [44, 70]}
CATEGORY = 'swan'
MODEL_OPT = """\
models:
  unet:
    unet_cfg: {{ block_out_channels: [16, 32, 32, 32], attention_head_dim: 4,
                cross_attention_dim: 24, norm_num_groups: 8,
                motion_heads: 4 }}
    motion_module_path: {tree}/mm_sd_v14.ckpt
  adapter:
    adapter_cfg: {{ embedding_channels: 32, channels: [16, 32, 32, 32],
                   mid_dim: 8 }}
  vae_cfg: {{ block_out_channels: [8, 8, 16, 16], norm_groups: 8 }}
  text_encoder_cfg: {{ hidden_size: 24, num_layers: 1, num_heads: 4,
                      intermediate_size: 32 }}
path:
  pretrained_model_path: {tree}/pretrained
"""


def _random_params(shapes, seed):
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], 'key', path[-1]))
        if name == 'kernel':
            v = rs.randn(*x.shape) / math.sqrt(np.prod(x.shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rs.randn(*x.shape)
        elif name == 'bias':
            v = 0.1 * rs.randn(*x.shape)
        else:
            v = 0.02 * rs.randn(*x.shape)
        return v.astype(np.float32)

    return {'params': jax.tree_util.tree_map_with_path(leaf,
                                                       shapes['params'])}


def _uint8(video):
    return np.clip(np.round(video * 255), 0, 255).astype(np.uint8)


def _write_run_dir(root, video, frames):
    """<root>/frames/ (PNG frames) and <root>/00004.json; returns them."""
    (root / 'frames').mkdir(parents=True)
    for i, f in enumerate(_uint8(video[:frames])):
        write_png(str(root / 'frames' / f'{i:05d}.png'), f)
    anno = root / f'{KEY:05d}.json'
    anno.write_text(json.dumps(ANNOTATION))
    return str(root / 'frames'), str(anno)


@pytest.fixture(scope='module')
def setup(tmp_path_factory):
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    cs = _chip_smoke()
    tmp = tmp_path_factory.mktemp('sp')
    key = jax.random.PRNGKey(0)
    junet = JUNet(cfg=JUNetConfig(**UNET_KW), attn_impl='flash')
    jvae = JVAE(**VAE_KW)
    jclip = JCLIP(cfg=JCLIPConfig(**CLIP_KW))
    shapes = {
        'unet': jax.eval_shape(junet.init, key, jnp.zeros((1, 2, 8, 8, 4)),
                               jnp.array([0]), jnp.zeros((1, 77, 24))),
        'vae': jax.eval_shape(jvae.init, key, jnp.zeros((1, 32, 32, 3))),
        'text_encoder': jax.eval_shape(jclip.init, key,
                                       jnp.zeros((1, 77), jnp.int32)),
    }
    params = {name: _random_params(s, i + 7)
              for i, (name, s) in enumerate(shapes.items())}
    models = build_models({'models': {
        'unet': {'unet_cfg': UNET_KW},
        'adapter': {'adapter_cfg': ADAPTER_KW}, 'vae_cfg': VAE_KW,
        'text_encoder_cfg': CLIP_KW}}, device='cpu')
    for name in params:
        models[name].load_state_dict(jax_params_to_state_dict(params[name]),
                                     strict=True)
    tree = tmp / 'tree'
    cs.write_experiment_tree(models, tree, {}, dtype=torch.float32)
    model_opt = tmp / 'model_opt.yml'
    model_opt.write_text(MODEL_OPT.format(tree=tree))
    built = tesp.build_featurizer(str(model_opt), torch.device('cpu'))
    jfeat = _OnceEach(JFeaturizer(
        unet=junet, vae=jvae, text_encoder=jclip, tokenizer=built.tokenizer,
        sched=j_make_schedule(), params=params))
    noise = torch.from_numpy(np.array(jax.random.normal(
        jax.random.PRNGKey(0), built.noise_shape((H, W)), jnp.float32)))
    data = cs.atlas_clip(FRAMES, H, W, 'cpu')
    video = data['video'].numpy()
    cot = tmp / 'cotracker_stride_4_wind_8.pth'
    torch.save(cs.synthetic_cotracker_state(), cot)
    pose = tmp / 'body_pose_model.pth'
    torch.save(cs.calibrated_openpose_state(_uint8(video)[0], 'cpu'), pose)
    yield {'tmp': tmp, 'model_opt': str(model_opt), 'jfeat': jfeat,
           'noise': noise, 'video': video, 'cot': str(cot),
           'pose': str(pose)}
    torch.set_num_threads(n)


class _OnceEach:
    """The JAX featurizer computing each (frame, prompt)'s map once: its
    draw is PRNGKey(0) at every call, so a repeated call returns the same
    numbers, and the JAX functions call it up to three times a frame."""

    def __init__(self, featurizer):
        self.featurizer = featurizer
        self.maps = {}

    def forward(self, image, prompt):
        image = np.asarray(image, np.float32)
        key = (prompt, image.shape, image.tobytes())
        if key not in self.maps:
            self.maps[key] = self.featurizer.forward(image, prompt)
        return self.maps[key]


def _port_run(s, monkeypatch, name, frames, **kw):
    """The port's CLI on a run directory of its own, its featurizer adding
    the JAX package's draw; returns (frame_dir, annotation, result)."""
    frame_dir, anno = _write_run_dir(s['tmp'] / name, s['video'], frames)
    real = tesp.build_featurizer

    def build(*args):
        feat = real(*args)
        feat.forward = functools.partial(feat.forward, noise=s['noise'])
        return feat
    monkeypatch.setattr(tesp, 'build_featurizer', build)
    argv = ['--frame_dir', frame_dir, '--keyframe_annotation', anno,
            '--subject_category', CATEGORY, '--model_opt', s['model_opt'],
            '--device', 'cpu']
    for k, v in kw.items():
        argv += [f'--{k}', v]
    return frame_dir, anno, tesp.main(argv)


def _same_tap(path, ref, tracks_px=0.01):
    out = torch.load(path, weights_only=False)
    assert sorted(out) == sorted(ref) == ['point_embedding',
                                          'point_name2id', 'pred_tracks']
    assert out['point_name2id'] == ref['point_name2id']
    for k in ('pred_tracks', 'point_embedding'):
        assert out[k].dtype == torch.float32
        assert out[k].shape == ref[k].shape, k
    np.testing.assert_array_equal(out['pred_tracks'] < 0,
                                  ref['pred_tracks'] < 0)
    assert np.abs(out['pred_tracks'].numpy()
                  - ref['pred_tracks']).max() <= tracks_px
    emb = ref['point_embedding']
    assert np.abs(out['point_embedding'].numpy() - emb).max() \
        <= 1e-4 * max(1e-6, np.abs(emb).max())
    return out


_TCore = tcot.CoTrackerCore


class _JCore2(jcot.CoTrackerCore):
    iters: int = 2


@pytest.fixture(scope='module')
def object_runs(setup):
    """The object path through both trackers, port and JAX package."""
    s = setup
    mp = pytest.MonkeyPatch()
    runs = {}
    try:
        mp.chdir(s['tmp'])
        for name, ckpt in (('dift', ''), ('native_cotracker', s['cot'])):
            mp.setenv('VS_COTRACKER_CKPT', ckpt)
            mp.setattr(jcot, 'INTERP_SHAPE', (96, 128))
            mp.setattr(tcot, 'INTERP_SHAPE', (96, 128))
            mp.setattr(jcot, 'CoTrackerCore', _JCore2)
            mp.setattr(tcot, 'CoTrackerCore',
                       functools.partial(_TCore, iters=2))
            frame_dir, anno, out = _port_run(s, mp, name, FRAMES)
            ref = jesp.propagate_general_keypoint(frame_dir, anno,
                                                  s['jfeat'], CATEGORY)
            ref = jesp.extract_point_embedding(ref, frame_dir, anno,
                                               s['jfeat'], CATEGORY, False)
            runs[name] = (out, ref)
    finally:
        mp.undo()
    return runs


@pytest.mark.parametrize('tracker', ['dift', 'native_cotracker'])
def test_object_path_matches_jax(object_runs, tracker):
    out, ref = object_runs[tracker]
    assert out['source'] == tracker
    tap = _same_tap(out['path'], ref)
    assert tap['point_name2id'] == {'head': 0, 'body': 1, 'tail': 2}
    assert tap['pred_tracks'].shape == (FRAMES, 3, 2)
    assert tap['point_embedding'].shape == (3, 32)
    assert set(out['seconds']) == {'load', 'features', 'track', 'embed',
                                   'save'}


def test_dataset_reads_the_written_tap(object_runs):
    """The TAP file as a swap config's dataset reads it (Resize)."""
    out, _ = object_runs['dift']
    frame_dir = out['path'].replace('TAP.pth', 'frames')
    ds = SingleVideoPointDataset({
        'path': frame_dir, 'tap_path': out['path'], 'prompt': 'a swan',
        'num_frames': FRAMES, 'total_frames': FRAMES,
        'video_transform': [{'type': 'Resize', 'size': [32, 48]},
                            {'type': 'ToTensor'},
                            {'type': 'Normalize', 'mean': [0.5],
                             'std': [0.5]}]})
    cond = ds.get_conditions()
    assert cond['pred_tracks'].shape == (FRAMES, 3, 2)
    assert cond['point_embedding'].shape == (3, 32)
    assert np.isfinite(cond['point_embedding']).all()


def test_human_path_matches_jax(setup, monkeypatch):
    s = setup
    monkeypatch.chdir(s['tmp'])
    frame_dir, anno, out = _port_run(s, monkeypatch, 'human', 3,
                                     is_human='true', pose_ckpt=s['pose'])
    assert out['source'] == 'NativePoseDetector'
    ref = jesp.propagate_human_keypoint(frame_dir, pose_ckpt=s['pose'])
    ref = jesp.extract_point_embedding(ref, frame_dir, anno, s['jfeat'],
                                       CATEGORY, True)
    tap = _same_tap(out['path'], ref)
    assert tap['pred_tracks'].shape == (3, 18, 2)
    found = (tap['pred_tracks'] >= 0).all(-1).sum(-1)
    assert (found >= 4).all()             # a person a frame, 4 parts or more
    assert np.abs(tap['point_embedding'].numpy()).max() > 0


def test_human_embedding_matches_jax(setup, object_runs):
    """The human path's embedding on known tracks: the `% h`, `% w` wrap,
    rounding halves to even, frames where a point is missing."""
    s = setup
    out, _ = object_runs['dift']
    frame_dir = out['path'].replace('TAP.pth', 'frames')
    tracks = np.full((FRAMES, 4, 2), -1.0, np.float32)
    tracks[:, 0] = (10.5, 20.5)                   # halves: to even
    tracks[::2, 1] = (95.6, 63.6)                 # rounds to the border
    tracks[1:, 2] = (40.0, 12.0)
    feat = tesp.build_featurizer(s['model_opt'], torch.device('cpu'))
    feats = [feat.forward(a, f'photo of a {CATEGORY}', noise=s['noise'])
             for a in tesp._load_frames(frame_dir)[1]]
    got = tesp.extract_point_embedding(
        {'pred_tracks': tracks.copy()}, frame_dir, None, True, feats)
    ref = jesp.extract_point_embedding(
        {'pred_tracks': tracks.copy()}, frame_dir, None, s['jfeat'],
        CATEGORY, True)
    np.testing.assert_array_equal(got['pred_tracks'], ref['pred_tracks'])
    emb = ref['point_embedding']
    assert np.abs(got['point_embedding'] - emb).max() \
        <= 1e-4 * np.abs(emb).max()
    assert not got['point_embedding'][3].any()    # never seen


def test_cli_wants_cuda_without_device_cpu(tmp_path):
    """Without --device cpu the CLI runs on the card, and raises on a
    machine without one before it loads anything."""
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        tesp.main(['--frame_dir', str(tmp_path), '--keyframe_annotation',
                   str(tmp_path / '00000.json')])
