"""The port's atlas CLIs and the modules under them against the JAX package,
fp32 on the CPU, at a tiny size: nets 32 wide with 3 layers, a 4-level hash
grid with a 2^10 table, clips of 5 frames at 32x24 (the evaluation
functions) and of 4 frames written at 40x30 and loaded at 32x24 (the CLIs),
inputs from a numpy seed.

- atlas/evaluate.py function by function against videoswap_tpu/atlas/
  evaluate.py on the same weights (the bridge of models/converters.py),
  and `evaluate_model` writing the same file names and PSNR;
- atlas checkpoints: the port's `.pth` read by the JAX package's
  train_atlas.py `load_atlas_checkpoint`, every leaf equal to the port's
  weight (that loader keeps a template's random leaf for a key it cannot
  find, and says nothing), and a JAX param tree carried to a `.pth` and read
  back by the port;
- `load_input_data` of both packages on files the test writes;
- the train CLI's experiment tree, log cadence and losses (bit-equal to a
  direct AtlasTrainer from the same seed);
- the propagate CLI against the JAX package's
  `process_displacement_propagation` on the port's checkpoint;
- the propagated TAP file driving a 2-step swap through the port's test
  CLI as a per-swap `tap_path`.

Tolerances are stated at each test.
"""

import importlib.util
import json
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from videoswap_tpu.atlas import evaluate as jev
from videoswap_tpu.atlas.data import load_input_data as j_load_input_data
from videoswap_tpu.atlas.imlp import imlp_from_opt as j_imlp_from_opt
from videoswap_tpu.atlas.trainer import AtlasTrainer as JAtlasTrainer
from videoswap_torch import extract_flow
from videoswap_torch import propagate_point_displacement as ppd
from videoswap_torch import train_atlas
from videoswap_torch.atlas import evaluate as tev
from videoswap_torch.atlas.data import load_input_data
from videoswap_torch.atlas.trainer import AtlasTrainer
from videoswap_torch.builders import (atlas_state_dict, build_atlas_nets,
                                      load_atlas_checkpoint,
                                      save_atlas_checkpoint)
from videoswap_torch.data.frame_point_dataset import load_tap_file
from videoswap_torch.models.converters import jax_params_to_state_dict

ROOT = Path(__file__).resolve().parents[1]
F_, H_, W_ = 5, 24, 32
MODELS = {
    'FG_UV_Mapping': dict(input_dim=3, output_dim=2),
    'FG_UV_Mapping_Inverse': dict(input_dim=3, output_dim=3),
    'BG_UV_Mapping': dict(input_dim=3, output_dim=2),
    'F_Atlas': dict(input_dim=2, output_dim=3, pe_type='hash_encoding',
                    n_levels=4, log2_hashmap_size=10, skip_layers=[2]),
    'F_Alpha': dict(input_dim=3, output_dim=1, pe_type='encoding',
                    pe_dim=2),
}
MODELS = {n: dict(kw, hidden_dim=32, mlp_layers=3) for n, kw in MODELS.items()}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _clip(f=F_, h=H_, w=W_, seed=0):
    """A clip in load_input_data's layout: a moving disk (the mask) over a
    gradient, random flows and consistency masks."""
    rs = np.random.RandomState(seed)
    ys, xs = np.mgrid[0:h, 0:w]
    video = np.zeros((f, h, w, 3), np.float32)
    mask = np.zeros((f, h, w), np.float32)
    for i in range(f):
        video[i, ..., 0] = xs / w
        video[i, ..., 1] = ys / h
        video[i, ..., 2] = rs.rand(h, w) * 0.3
        m = (xs - 10 - 2 * i) ** 2 + (ys - 12) ** 2 < 30
        video[i][m] = [0.9, 0.2, 0.1]
        mask[i][m] = 1.0
    return dict(video=video, mask=mask,
                flows=(rs.randn(f, h, w, 2) * 0.8).astype(np.float32),
                flow_masks=(rs.rand(f, h, w) > 0.3).astype(np.float32))


@pytest.fixture(scope='module')
def nets():
    """The JAX nets and params from a PRNG key, and the port's nets with
    the same weights; the clip and its normalisations (larger_dim 32)."""
    jnets = {n: j_imlp_from_opt(o) for n, o in MODELS.items()}
    key = jax.random.PRNGKey(3)
    params = {}
    for n, net in jnets.items():
        key, k = jax.random.split(key)
        params[n] = jax.jit(net.init)(k, jnp.zeros((1, net.input_dim)))
    tnets = build_atlas_nets(MODELS, device='cpu')
    for n, net in tnets.items():
        net.load_state_dict(jax_params_to_state_dict(params[n]), strict=True)

    def norm_s(v):
        return v / (W_ / 2.0) - 1.0

    def norm_t(v):
        return v / (F_ / 2.0) - 1.0
    return types.SimpleNamespace(jnets=jnets, params=params, tnets=tnets,
                                 clip=_clip(), norm_s=norm_s, norm_t=norm_t)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# ------------------------------------------------------- evaluate.py
@pytest.mark.parametrize('case', ['bg_all', 'fg_mask', 'fg_none'])
def test_get_mapping_area_matches_jax(nets, case):
    """The UV box, gated on the raw F_Alpha output: the BG mapping over
    every pixel (inverted alpha), the FG mapping over the mask, and a
    threshold no pixel passes (the [0, 0] + 1 fallback). Within 1e-6."""
    mask = nets.clip['mask']
    kw = {'bg_all': dict(mask=mask > -1, shift=(-0.5, -0.5),
                         mapping='BG_UV_Mapping', invert_alpha=True,
                         alpha_thresh=-0.5),
          'fg_mask': dict(mask=mask > 0.5, shift=(0.5, 0.5),
                          mapping='FG_UV_Mapping', invert_alpha=False,
                          alpha_thresh=-0.5),
          'fg_none': dict(mask=mask > 0.5, shift=(0.5, 0.5),
                          mapping='FG_UV_Mapping', invert_alpha=False,
                          alpha_thresh=2.0)}[case]
    m, shift = kw.pop('mask'), kw.pop('shift')
    ref = jev.get_mapping_area(nets.jnets, nets.params, m, W_, F_, shift,
                               nets.norm_s, nets.norm_t, **kw)
    out = tev.get_mapping_area(nets.tnets, torch.from_numpy(m), W_, F_,
                               shift, nets.norm_s, nets.norm_t, **kw)
    assert set(out) == set(ref)
    for k in ref:
        np.testing.assert_allclose(out[k], ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    assert (ref['edge'] == 1.0 and ref['minx'] == 0.0) == (case == 'fg_none')


def test_textures_match_jax(nets):
    """F_Atlas over a box and over each layer's quadrant (within 1e-6), the
    edit pattern (within 1e-6) and the checkerboard (equal)."""
    args = (48, -0.3, 0.7, -0.1, 0.9)
    ref = jev.get_high_res_texture(nets.jnets, nets.params, *args)
    out = tev.get_high_res_texture(nets.tnets, *args)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-6)
    for layer in ('fg', 'bg'):
        np.testing.assert_allclose(
            _np(tev.render_atlas_texture(nets.tnets, layer, 40)),
            jev.render_atlas_texture(nets.jnets, nets.params, layer, 40),
            rtol=0, atol=1e-6)
    for res in (40, 200):
        tex = np.random.RandomState(res).rand(res, res, 3).astype(
            np.float32)
        np.testing.assert_allclose(
            _np(tev.apply_edit_pattern(torch.from_numpy(tex))),
            jev.apply_edit_pattern(tex), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(_np(tev._checkerboard(res)),
                                      jev._checkerboard(res))


def test_sample_texture_matches_jax():
    """Points in and around the box: the colours (float64) within 1e-12,
    the relevance test (floor and ceil inside), px and py equal."""
    rs = np.random.RandomState(1)
    tex = rs.rand(50, 50, 3).astype(np.float32)
    box = dict(minx=-0.2, miny=0.1, maxx=0.6, maxy=0.9, edge=0.8)
    u = rs.uniform(-0.4, 0.8, 4000).astype(np.float32)
    v = rs.uniform(-0.1, 1.1, 4000).astype(np.float32)
    u[:3] = [-0.2, 0.6, 0.6 - 1e-7]            # on the box's edges
    ref = jev.sample_texture(tex, box, u, v)
    out = tev.sample_texture(torch.from_numpy(tex), box,
                             torch.from_numpy(u), torch.from_numpy(v))
    np.testing.assert_allclose(_np(out[0]), ref[0], rtol=0, atol=1e-12)
    for a, b in zip(out[1:], ref[1:]):
        np.testing.assert_array_equal(_np(a), b)
    assert 0.3 < ref[1].mean() < 0.9


@pytest.fixture(scope='module')
def rec(nets):
    """The JAX reconstruction, as numpy and as tensors."""
    j = jev.reconstruct_video(nets.jnets, nets.params, W_, H_, F_,
                              nets.norm_s, nets.norm_t)
    return j, {k: torch.from_numpy(np.asarray(v)) for k, v in j.items()}


def test_render_edited_video_matches_jax(nets, rec):
    """On the same reconstruction and textures: the composite and the two
    layers within 1e-6, the alpha max-splat mask within 1e-7 and the BG
    used-area mask equal."""
    jrec, trec = rec
    rs = np.random.RandomState(2)
    tex_fg, tex_bg = (rs.rand(60, 60, 3).astype(np.float32)
                      for _ in range(2))
    box_fg = dict(minx=0.0, miny=0.0, maxx=1.0, maxy=1.0, edge=1.0)
    box_bg = dict(minx=-0.9, miny=-0.8, maxx=-0.1, maxy=-0.1, edge=0.8)
    kw = dict(box_fg=box_fg, box_bg=box_bg)
    ref = jev.render_edited_video(nets.jnets, nets.params, W_, H_, F_,
                                  nets.norm_s, nets.norm_t, tex_fg=tex_fg,
                                  tex_bg=tex_bg, rec=jrec, **kw)
    out = tev.render_edited_video(nets.tnets, W_, H_, F_, nets.norm_s,
                                  nets.norm_t, tex_fg=torch.from_numpy(tex_fg),
                                  tex_bg=torch.from_numpy(tex_bg), rec=trec,
                                  **kw)
    for k in ('edit', 'edit_fg', 'edit_bg'):
        np.testing.assert_allclose(_np(out[k]), ref[k], rtol=0, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(_np(out['mask_fg']), ref['mask_fg'], rtol=0,
                               atol=1e-7)
    np.testing.assert_array_equal(_np(out['mask_bg']), ref['mask_bg'])
    assert ref['mask_fg'].max() > 0 and ref['mask_bg'].sum() > 10


def test_compute_loss_videos_matches_jax(nets):
    """Every per-pixel map within 1e-5 of its largest entry, the rigidity
    maps within 5e-4 of each entry (they divide by the determinant of a
    random-init Jacobian taken as differences of neighbouring evaluations,
    which amplifies fp32 rounding: 1.1e-4 read here); the last frame's flow
    terms are 0."""
    kw = dict(derivative_amount=1, uv_mapping_scale=0.8)
    ref = jev.compute_loss_videos(nets.jnets, nets.params, nets.clip, W_, H_,
                                  F_, nets.norm_s, nets.norm_t, W_, **kw)
    out = tev.compute_loss_videos(nets.tnets, nets.clip, W_, H_, F_,
                                  nets.norm_s, nets.norm_t, W_, **kw)
    assert set(out) == set(ref)
    for k, v in ref.items():
        rigid = k.startswith('rigidity')
        np.testing.assert_allclose(_np(out[k]), v, rtol=5e-4 if rigid else 0,
                                   atol=0 if rigid else 1e-5 * np.abs(v).max(),
                                   err_msg=k)
    for k in ('flow_fg', 'flow_bg', 'flow_alpha'):
        assert not _np(out[k])[-1].any() and _np(out[k])[:-1].any()


def test_global_info_and_checkerboard_match_jax(nets, rec):
    """The diagnostic mosaic on the same inputs, within 1e-6; the
    checkerboard video from the reconstruction `evaluate_model` already
    has, against the JAX package's, which reconstructs again: equal."""
    jrec, trec = rec
    rs = np.random.RandomState(4)
    lv = {k: rs.rand(F_, H_, W_).astype(np.float32) * 3
          for k in ('rgb_error', 'flow_fg', 'flow_bg', 'flow_alpha',
                    'rigidity_fg')}
    ref = jev.global_info_frames(nets.clip['video'], jrec['rgb'], lv,
                                 jrec['alpha'], nets.clip['mask'])
    out = tev.global_info_frames(
        nets.clip['video'], trec['rgb'],
        {k: torch.from_numpy(v) for k, v in lv.items()}, trec['alpha'],
        nets.clip['mask'])
    assert out.shape == ref.shape == (F_, 2 * H_, 4 * W_, 3)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(
        _np(tev.render_checkerboard(nets.tnets, W_, H_, F_, nets.norm_s,
                                    nets.norm_t, rec=trec)),
        jev.render_checkerboard(nets.jnets, nets.params, W_, H_, F_,
                                nets.norm_s, nets.norm_t))


def _names(d: Path) -> set:
    return {p.name for p in d.iterdir()}


@pytest.mark.parametrize('full', [False, True])
def test_evaluate_model_writes_the_jax_files(nets, tmp_path, full):
    """The same file names (videos as .gif where imageio cannot write
    mp4, in both packages), the same PSNR (relative 1e-6) and the atlas
    texture images within one 8-bit level."""
    kw = dict(data=nets.clip, full=full, texture_res=64)
    ref = jev.evaluate_model(nets.jnets, nets.params, nets.clip['video'], W_,
                             H_, F_, nets.norm_s, nets.norm_t,
                             save_dir=str(tmp_path / 'jax'), **kw)
    out = tev.evaluate_model(nets.tnets, nets.clip['video'], W_, H_, F_,
                             nets.norm_s, nets.norm_t,
                             save_dir=str(tmp_path / 'port'), **kw)
    np.testing.assert_allclose(out, ref, rtol=1e-6)
    names = _names(tmp_path / 'port')
    assert names == _names(tmp_path / 'jax')
    assert len(names) == (22 if full else 7)
    pngs = ['atlas_fg.png'] + (['texture_edit2.png'] if full else [])
    for name in pngs:
        a, b = (np.asarray(Image.open(tmp_path / d / name)).astype(int)
                for d in ('port', 'jax'))
        assert a.shape == b.shape and np.abs(a - b).max() <= 1


# ----------------------------------------------------------- checkpoints
def _template(models):
    """The JAX package's loader template: each net's init at key 0."""
    jn = {n: j_imlp_from_opt(o) for n, o in models.items()}
    return {n: jax.jit(net.init)(jax.random.PRNGKey(0),
                                 jnp.zeros((1, net.input_dim)))
            for n, net in jn.items()}


def _leaves(tree):
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def test_port_checkpoint_is_read_by_the_jax_loader(tmp_path):
    """Every leaf the JAX package's `.pth` loader returns equals the port's
    weight (Dense kernels transposed), none is the template's own; and the
    port reads its file back bit for bit."""
    from train_atlas import load_atlas_checkpoint as j_load
    port = build_atlas_nets(MODELS, device='cpu', seed=5)
    path = str(tmp_path / 'models_6.pth')
    save_atlas_checkpoint(path, port)
    template = _template(MODELS)
    loaded = j_load(path, template)
    got, tpl = _leaves(loaded), _leaves(template)
    assert set(got) == set(tpl)
    assert len(got) == sum(len(net.state_dict()) for net in port.values())
    for key, v in got.items():
        net, _, *layer, leaf = key.split('/')
        name = '.'.join(layer + ['weight' if leaf == 'kernel' else leaf])
        t = port[net].state_dict()[name]
        t = t.numpy().T if leaf == 'kernel' else t.numpy()
        np.testing.assert_array_equal(v, t, err_msg=key)
        assert not np.array_equal(v, tpl[key]) or not v.any(), key
    again = build_atlas_nets(MODELS, device='cpu', seed=6)
    load_atlas_checkpoint(path, again)
    for n in port:
        for k, v in port[n].state_dict().items():
            assert torch.equal(v, again[n].state_dict()[k]), (n, k)


def test_jax_params_carried_to_pth_are_read_by_the_port(nets, tmp_path):
    """A JAX param tree trained by one inverse step, carried to a `.pth`
    ({net: state_dict} with the port's layer names, and the flat reference
    layout) through the bridge: the port reads both, equal to every leaf;
    the JAX loader reads the flat one back to the same tree. A missing or
    unused key raises."""
    from train_atlas import load_atlas_checkpoint as j_load
    jt = JAtlasTrainer(nets=nets.jnets, data={k: jnp.asarray(v) for k, v in
                                              _full_clip().items()},
                       train_opt={'sample_batch_size': 64},
                       larger_dim=W_, num_frames=F_)
    start = jax.tree.map(jnp.copy, nets.params)   # the step donates them
    trained, _, _ = jt.inverse_step(start, jt.init_opt_state(start),
                                    jax.random.PRNGKey(7))
    assert not np.array_equal(
        _leaves(trained['FG_UV_Mapping_Inverse'])['params/hidden_0/kernel'],
        _leaves(nets.params['FG_UV_Mapping_Inverse'])[
            'params/hidden_0/kernel'])
    nested = {n: jax_params_to_state_dict(trained[n]) for n in trained}
    torch.save(nested, tmp_path / 'nested.pth')
    port = build_atlas_nets(MODELS, device='cpu', seed=9)
    load_atlas_checkpoint(str(tmp_path / 'nested.pth'), port)
    for n, sd in nested.items():
        for k, v in sd.items():
            assert torch.equal(port[n].state_dict()[k], v), (n, k)
    torch.save(atlas_state_dict(port), tmp_path / 'flat.pth')
    again = j_load(str(tmp_path / 'flat.pth'), _template(MODELS))
    got, want = _leaves(again), _leaves(trained)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    del nested['F_Alpha']['hidden_0.bias']
    nested['F_Alpha']['hidden_9.bias'] = torch.zeros(1)
    torch.save(nested, tmp_path / 'bad.pth')
    with pytest.raises(KeyError, match='missing F_Alpha.hidden_0.bias'):
        load_atlas_checkpoint(str(tmp_path / 'bad.pth'), port)


def _full_clip():
    c = _clip()
    rs = np.random.RandomState(8)
    c.update(dx=np.zeros_like(c['video']), dy=np.zeros_like(c['video']),
             flows_rev=(rs.randn(F_, H_, W_, 2) * 0.8).astype(np.float32),
             flow_masks_rev=np.ones((F_, H_, W_), np.float32))
    return c


# ------------------------------------------------------------- the CLIs
def _write_png(path: Path, arr) -> None:
    Image.fromarray((np.clip(arr, 0, 1) * 255).round().astype(
        np.uint8)).save(path)


def _write_clip(d: Path, f: int = 4, h: int = 30, w: int = 40) -> None:
    """Frames of a gradient and a disk moving 2 px a frame, its masks."""
    ys, xs = np.mgrid[0:h, 0:w]
    for sub in ('frames', 'masks'):
        (d / sub).mkdir(parents=True, exist_ok=True)
    for i in range(f):
        img = np.stack([xs / w, ys / h, 0.5 + 0.3 * np.sin(xs * 0.7
                                                           - 0.5 * i)], -1)
        m = (xs - 12 - 2 * i) ** 2 + (ys - 15) ** 2 < 40
        img[m] = [0.9, 0.1, 0.2]
        _write_png(d / 'frames' / f'{i:05d}.png', img)
        _write_png(d / 'masks' / f'{i:05d}.png', m.astype(float))


def test_load_input_data_matches_jax(tmp_path):
    """Frames, masks and flow files written at 40x30, loaded at 32x24 by
    both packages (PIL resizes, the flow's consistency masks in float64):
    every array equal."""
    _write_clip(tmp_path)
    rs = np.random.RandomState(10)
    (tmp_path / 'flows').mkdir()
    for i in range(3):
        fwd = rs.randn(30, 40, 2).astype(np.float32)
        bwd = (-fwd + rs.randn(30, 40, 2) * 0.4).astype(np.float32)
        np.save(tmp_path / 'flows' / f'{i:05d}.npy', np.stack([fwd, bwd]))
    opt = {'frame_path': str(tmp_path / 'frames'),
           'mask_path': str(tmp_path / 'masks'),
           'flow_path': str(tmp_path / 'flows'), 'res_x': 32, 'res_y': 24,
           'max_frames': 72, 'filter_optical_flow': True}
    ref, out = j_load_input_data(opt), load_input_data(opt)
    assert set(out) == set(ref)
    for k, v in ref.items():
        assert out[k].shape == v.shape and out[k].dtype == v.dtype, k
        np.testing.assert_array_equal(out[k], v, err_msg=k)
    assert 0 < ref['flow_masks'][:3].mean() < 1 and ref['mask'].any()


CONFIG = """\
name: tiny_atlas
manual_seed: 0
mixed_precision: 'no'
datasets:
  frame_path: {d}/frames
  mask_path: {d}/masks
  flow_path: {d}/flows
  annotation_path: {d}/annotation/00000.json
  res_x: {res_x}
  res_y: {res_y}
  max_frames: 72
  filter_optical_flow: true
  sample_batch_size: 256
models:
{models}
train:
  optimizer: {{ type: Adam, lr: !!float 1e-3 }}
  total_iter: {iters}
  pretrain_UV_mapping_iter: 1
  pretrain_alpha_iter: 3
  pretrain_global_rigidity_iter: 2
  uv_mapping_scale: 0.8
  derivative_amount: 1
  global_derivative_amount: 4
  loss_cfg:
    reconstruction_loss: {{ rgb_loss_weight: 5000.0,
                           gradient_loss_weight: 1000.0,
                           alpha_loss_weight: 2000.0 }}
    sparsity_loss: {{ sparsity_loss_weight: 1000.0 }}
    rigidity_loss: {{ rigidity_loss_weight: 1.0,
                     global_rigidity_fg_loss_weight: 5.0,
                     global_rigidity_bg_loss_weight: 50.0 }}
    flow_loss: {{ flow_loss_weight: 5.0, alpha_flow_loss_weight: 49.0 }}
val:
  val_freq: {iters}
  full_eval: {full}
logger:
  print_freq: 2
  save_checkpoint_freq: 3
"""


def _models_yaml():
    out = []
    for n, o in MODELS.items():
        items = ', '.join(f'{k}: {json.dumps(v)}' for k, v in o.items())
        out.append(f'  {n}: {{ {items} }}')
    return '\n'.join(out)


def _atlas_chain(d: Path, res_x=32, res_y=24, iters=6, full='true'):
    """Flows (the extract_flow CLI, LK), then the train CLI on the config
    above: its result and the config's path."""
    extract_flow.cli(['--frame_dir', str(d / 'frames'), '--out_dir',
                      str(d / 'flows'), '--method', 'lk', '--device', 'cpu'])
    yml = d / 'tiny_atlas.yml'
    yml.write_text(CONFIG.format(d=d, res_x=res_x, res_y=res_y, iters=iters,
                                 full=full, models=_models_yaml()))
    out = train_atlas.train(str(d), types.SimpleNamespace(
        opt=str(yml), device='cpu', shard=None))
    return out, yml


@pytest.fixture(scope='module')
def chain(tmp_path_factory):
    d = tmp_path_factory.mktemp('atlas')
    _write_clip(d)
    out, yml = _atlas_chain(d)
    return d, out, yml


def test_train_cli_tree_cadence_and_losses(chain):
    """The experiment tree (the config copy, models_3.pth and models_6.pth,
    the full validation's files under visualization/Iter_6), the log's
    lines at the JAX CLI's cadence, and the logged losses bit-equal to an
    AtlasTrainer driven directly from the same seed on the same data."""
    d, out, yml = chain
    exp = d / 'experiments' / 'tiny_atlas'
    assert _names(exp / 'models') == {'models_3.pth', 'models_6.pth'}
    assert (exp / 'tiny_atlas.yml').exists()
    assert len(_names(exp / 'visualization' / 'Iter_6')) == 22
    log = next(exp.glob('train_tiny_atlas_*.log')).read_text()
    for line, n in (('pretrained FG_UV_Mapping, final loss', 1),
                    ('pretrained BG_UV_Mapping, final loss', 1),
                    ('[Iter:', 3), ('Validation Reconstruction PSNR:', 1),
                    ('inverse pred:', 1), ('Save models to', 2)):
        assert log.count(line) == n, line
    assert sorted(out['logged']) == [2, 4, 6]
    assert set(out['logged'][2]) >= {'total_loss', 'fg_inv_loss',
                                     'flow_alpha_loss'}

    opt = out['opt']
    data = load_input_data({**opt['datasets']})
    direct = AtlasTrainer(build_atlas_nets(opt['models'], device='cpu',
                                           seed=0), data,
                          out['trainer'].train_opt, larger_dim=32,
                          num_frames=4, device='cpu')
    gen = torch.Generator().manual_seed(0)
    for name in ('FG_UV_Mapping', 'BG_UV_Mapping'):
        direct.pretrain_mapping(name, gen, 1)
    direct.init_opt_state()
    for it in range(1, 7):
        ld = direct.step(it, gen)
        ld['fg_inv_loss'] = direct.inverse_step(gen)
        if it in out['logged']:
            assert {k: float(v) for k, v in ld.items()} == out['logged'][it]


def _points(d: Path):
    """A keyframe file of two named points on the disk, their drag by
    (+4, +2) px in duck.json, and a TAP.pth of three tracks."""
    ann = d / 'annotation'
    ann.mkdir(exist_ok=True)
    src = {'head': [12, 9], 'body': [11, 11], 'tail': [13, 12]}
    dst = {'head': [14, 13], 'body': [13, 15]}
    (ann / '00000.json').write_text(json.dumps(src))
    (ann / 'duck.json').write_text(json.dumps(dst))
    tracks = np.zeros((4, 3, 2), np.float32)
    for p, (y, x) in enumerate(src.values()):
        tracks[:, p] = [[x + 1.6 * t, y] for t in range(4)]
    torch.save({'pred_tracks': torch.from_numpy(tracks),
                'point_embedding': torch.randn(3, 12),
                'point_name2id': {n: i for i, n in enumerate(src)}},
               ann / 'TAP.pth')
    return ann


def test_propagate_cli_matches_jax(chain):
    """The port's CLI and the JAX package's process_displacement_
    propagation on the port's checkpoint and TAP file: the same keys and
    names, the undragged track kept, and every dragged coordinate within
    one pixel of the JAX package's (tracks are rounded pixels: fp32
    rounding may put a coordinate on the other side of a half), with the
    same frames visible."""
    from propagate_point_displacement import \
        process_displacement_propagation
    d, out, yml = chain
    ann = _points(d)
    args = [str(yml), out['checkpoints'][6], str(ann / 'TAP.pth'),
            str(ann / '00000.json'), str(ann / 'duck.json')]
    path = ppd.main(['--atlas_config_path', args[0], '--atlas_model_path',
                     args[1], '--source_tap_path', args[2],
                     '--source_point_path', args[3], '--target_point_path',
                     args[4], '--device', 'cpu'])
    assert Path(path) == ann / 'TAP_duck.pth'
    port = load_tap_file(path)
    ref = process_displacement_propagation(*args)
    source = load_tap_file(str(ann / 'TAP.pth'))
    assert sorted(port) == sorted(ref) == sorted(source)
    assert port['point_name2id'] == ref['point_name2id']
    np.testing.assert_array_equal(port['pred_tracks'][:, 2],
                                  source['pred_tracks'][:, 2])
    a, b = port['pred_tracks'], np.asarray(ref['pred_tracks'])
    np.testing.assert_array_equal(a < 0, b < 0)
    assert np.abs(a - b).max() <= 1.0
    assert not np.array_equal(a[:, :2], source['pred_tracks'][:, :2])


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_tap_cpu_witness_reads_what_it_is_given(chain):
    """chip_smoke.py's atlas_recipe holds the card's propagated tracks
    against a propagation through the nets moved to the CPU: here, on the
    chain's checkpoint (F_Alpha's output bias raised so the dragged points
    are visible in every frame), the CPU's own tracks read 0 px and no
    hidden frame; a coordinate moved by 3 px reads 3 px, and a frame
    hidden on one side only counts, both failing 'TAP vs CPU'."""
    from videoswap_torch.utils.config import load_config
    cs = _chip_smoke()
    d, out, yml = chain
    ann = _points(d)
    cfg = load_config(str(yml))
    tnets = build_atlas_nets(cfg['models'], device='cpu')
    load_atlas_checkpoint(out['checkpoints'][6], tnets)
    last = [m for m in tnets['F_Alpha'].modules()
            if isinstance(m, torch.nn.Linear)][-1]
    with torch.no_grad():
        last.bias += 5.0
    frames, larger = ppd.clip_size(cfg['datasets'])

    def norm_s(v):
        return v / (larger / 2.0) - 1.0

    def norm_t(v):
        return v / (frames / 2.0) - 1.0
    src = json.loads((ann / '00000.json').read_text())
    dst = json.loads((ann / 'duck.json').read_text())
    source = load_tap_file(str(ann / 'TAP.pth'))
    from videoswap_torch.atlas.propagate import (bind_nets,
                                                 propagate_point_sequence)
    tracks = propagate_point_sequence(
        src, dst, 0, source['pred_tracks'], source['point_name2id'],
        *bind_nets(tnets), larger, frames, norm_s, norm_t)
    assert (tracks >= 0).all()

    def fails(w):
        return cs.tap_fails({'differs_from_direct': False, 'keys': True,
                             'names': True, 'shapes': True,
                             'finite_or_hidden': True,
                             'undragged_kept': True, 'cpu': w})
    w = cs.tap_cpu_witness(tnets, src, dst, source, tracks, larger, frames,
                           norm_s, norm_t)
    assert w['max_px'] == 0 and w['hidden_differs'] == 0
    assert min(w['alpha_margin'].values()) > 0.4
    assert fails(w) == []
    moved = tracks.copy()
    moved[2, source['point_name2id']['head'], 0] += 3
    w = cs.tap_cpu_witness(tnets, src, dst, source, moved, larger, frames,
                           norm_s, norm_t)
    assert w['max_px'] == 3 and fails(w) == ['TAP vs CPU']
    hidden = tracks.copy()
    hidden[1, source['point_name2id']['body']] = -1
    w = cs.tap_cpu_witness(tnets, src, dst, source, hidden, larger, frames,
                           norm_s, norm_t)
    assert (w['hidden_differs'], w['hidden_differs_at_margin']) == (1, 0)
    assert fails(w) == ['TAP vs CPU']


ATLAS_RECIPE_PLANTS = {
    'propagate_ignores_drag': ('videoswap_torch.propagate_point_displacement',
                               'propagate_point_sequence'),
    'card_drag_doubled': ('videoswap_torch.propagate_point_displacement',
                          'bind_nets'),
    'checkpoint_before_training': ('videoswap_torch.train_atlas',
                                   'save_atlas_checkpoint'),
    'backward_flow_negated': ('videoswap_torch.extract_flow',
                              'compute_bidirectional_flow'),
    'cli_skips_inverse_step': ('videoswap_torch.atlas.trainer',
                               'AtlasTrainer.run_steps'),
    'box_filter_tf32': ('videoswap_torch.preprocess.matching_flow',
                        'box_filter'),
}


@pytest.mark.parametrize('fault', sorted(ATLAS_RECIPE_PLANTS))
def test_atlas_recipe_fault_plants_reach_the_cli_path(fault):
    """scripts/fault_control.py's atlas-recipe faults replace the name the
    CLIs' path looks up while planted, and put it back after."""
    import importlib
    import sys
    sys.modules.setdefault('chip_smoke', _chip_smoke())
    spec = importlib.util.spec_from_file_location(
        'fault_control', ROOT / 'scripts' / 'fault_control.py')
    fc = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(fc)
    assert set(fc.ATLAS_RECIPE_FAULTS) == {'sound'} | set(ATLAS_RECIPE_PLANTS)
    module, name = ATLAS_RECIPE_PLANTS[fault]
    obj = importlib.import_module(module)
    *owner, attr = name.split('.')
    for o in owner:
        obj = getattr(obj, o)
    sound = getattr(obj, attr)
    with fc.ATLAS_RECIPE_FAULTS[fault][0]():
        assert getattr(obj, attr) is not sound
    assert getattr(obj, attr) is sound


def test_propagated_tap_drives_a_swap(tmp_path, monkeypatch):
    """The chain's hand-off: an atlas trained on a swap clip's frames (at
    the swap's 96x64), a drag of two of its TAP file's points propagated to
    TAP_duck.pth, and that file a swap's `tap_path` in a 2-step run of the
    port's test CLI: the swap reads it, and its frames are written."""
    import test_torch_cli as tc

    from videoswap_torch.builders import build_models
    from videoswap_torch.data.frame_point_dataset import \
        SingleVideoPointDataset
    cs = _chip_smoke()
    built = build_models({'models': tc.MODELS_OPT}, device='cpu', seed=11)
    cs.write_experiment_tree(built, tmp_path,
                             {'edlora_hermione.pth': cs.BLEND_CONCEPTS},
                             dtype=torch.float32)
    cs.write_clip(tmp_path, 4, 72, {'TAP.pth': (tc.H, tc.W)}, emb=12)
    (tmp_path / 'masks').mkdir()
    for i in range(4):
        _write_png(tmp_path / 'masks' / f'{i:05d}.png', np.zeros((72, 72)))
    out, yml = _atlas_chain(tmp_path, res_x=tc.W, res_y=tc.H, iters=2,
                            full='false')
    tap = load_tap_file(str(tmp_path / 'TAP.pth'))
    names = list(tap['point_name2id'])[:2]
    src = {n: [float(tap['pred_tracks'][0, tap['point_name2id'][n], 1]),
               float(tap['pred_tracks'][0, tap['point_name2id'][n], 0])]
           for n in names}
    ann = tmp_path / 'annotation'
    ann.mkdir()
    (ann / '00000.json').write_text(json.dumps(src))
    (ann / 'duck.json').write_text(json.dumps(
        {n: [y + 3, x + 5] for n, (y, x) in src.items()}))
    duck = ppd.main(['--atlas_config_path', str(yml), '--atlas_model_path',
                     out['checkpoints'][2], '--source_tap_path',
                     str(tmp_path / 'TAP.pth'), '--source_point_path',
                     str(ann / '00000.json'), '--target_point_path',
                     str(ann / 'duck.json'), '--device', 'cpu'])
    edited = load_tap_file(duck)['pred_tracks']
    assert not np.array_equal(edited, tap['pred_tracks'])

    text = tc.CONFIG.format(tree=tmp_path, root=ROOT, frames=2, h=tc.H,
                            w=tc.W, clip_frames=4)
    text = text.replace('        tap_path: {}/TAP_other.pth'.format(tmp_path),
                        f'        tap_path: {duck}')
    text = text.replace('num_inference_steps: 3', 'num_inference_steps: 2')
    swap_yml = tmp_path / 'swap.yml'
    swap_yml.write_text(text)
    read = []
    original = SingleVideoPointDataset.get_conditions

    def spy(self, tap_path=None):
        read.append(tap_path)
        return original(self, tap_path)
    monkeypatch.setattr(SingleVideoPointDataset, 'get_conditions', spy)
    from videoswap_torch.test import test
    res = test(str(tmp_path), str(swap_yml), device='cpu')
    assert duck in read
    frames = res['results']['man_to_hermione']
    assert np.asarray(frames).shape[0] == 2
    assert (Path(res['opt']['path']['visualization']) / 'man_to_hermione'
            ).exists() or any(Path(res['opt']['path']['exp_root']).rglob(
                '*man_to_hermione*'))

