"""The port's CoTracker v1 against the JAX package's on the CPU, fp32, with
the same weights: chip_smoke.py's seeded synthetic checkpoint (the default
initialisation conditioned to a contraction; chip_smoke.py says why: at the
default initialisation fp32 rounding alone moves a window's tracks by
pixels), loaded strictly by the port and through the JAX converter. The
key set, the encoder, one core iteration and the predictor (sliding
windows and backward tracking) on a short clip; the predictor's frames
resized to 96x128 on both sides instead of 384x512 (INTERP_SHAPE), for the
CPU's time. The JAX predictor runs once, in a module-scoped fixture.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.preprocess import cotracker_native as J
from videoswap_torch.preprocess import cotracker_native as T

ROOT = Path(__file__).resolve().parents[1]
SMALL = (96, 128)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _video():
    rs = np.random.RandomState(3)
    base = rs.rand(48, 64, 3) * 255
    frames = [np.roll(base, (i, 2 * i), axis=(0, 1)) for i in range(10)]
    return np.stack(frames).astype(np.float32)            # (T, H, W, 3)


QUERIES = np.array([[[4.0, 20.0, 30.0], [4.0, 50.0, 20.0],
                     [0.0, 10.0, 10.0]]], np.float32)


@pytest.fixture(scope='module')
def pair():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    state = _chip_smoke().synthetic_cotracker_state()
    model = T.CoTrackerCore().eval()
    model.load_state_dict(state, strict=True)
    shapes = J._template_shapes(J.CoTrackerCore())
    template = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    params = {'params': J.convert_cotracker(dict(state),
                                            template['params'])}
    yield state, model, params, shapes
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def predicted(pair):
    """Both predictors at 2 iterations a window (the JAX package's own test
    of its predictor does so, for the compile's time)."""
    state, _, params, _ = pair
    video = _video()
    model = T.CoTrackerCore(iters=2).eval()
    model.load_state_dict(state, strict=True)
    jpred = J.NativeCoTrackerPredictor(params)
    jpred.model = J.CoTrackerCore(iters=2)
    jpred._enc = jax.jit(lambda p, f: jpred.model.apply(
        p, f, method=J.CoTrackerCore.encode))
    jpred._iter = jax.jit(lambda p, *a: jpred.model.apply(p, *a))
    j_shape, t_shape = J.INTERP_SHAPE, T.INTERP_SHAPE
    J.INTERP_SHAPE = T.INTERP_SHAPE = SMALL
    try:
        ref = jpred(video, QUERIES)
        out = T.NativeCoTrackerPredictor(model)(video, QUERIES)
    finally:
        J.INTERP_SHAPE, T.INTERP_SHAPE = j_shape, t_shape
    return ref, out


def test_checkpoint_key_set_is_the_jax_packages(pair, monkeypatch):
    """The JAX key list read off the fixture's template (the same
    eval_shape, traced once)."""
    state, _, _, shapes = pair
    monkeypatch.setattr(J, '_template_shapes', lambda model: shapes)
    assert T.expected_checkpoint_keys() == sorted(
        J.expected_checkpoint_keys()) == sorted(state)
    for k in ('fnet.layer4.0.downsample.0.weight', 'fnet.conv3.bias',
              'updateformer.time_blocks.5.attn.qkv.bias',
              'updateformer.space_blocks.0.mlp.fc2.weight',
              'norm.weight', 'ffeat_updater.0.weight',
              'vis_predictor.0.bias'):
        assert k in state, k


def test_encoder_matches_jax(pair):
    _, model, params, _ = pair
    frames = np.random.RandomState(1).rand(2, 48, 64, 3).astype(
        np.float32) * 2 - 1
    ref = np.asarray(jax.jit(lambda p, f: J.CoTrackerCore().apply(
        p, f, method=J.CoTrackerCore.encode))(params, jnp.asarray(frames)))
    with torch.no_grad():
        out = model.encode(torch.from_numpy(frames)).numpy()
    assert out.shape == ref.shape == (2, 12, 16, 128)
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_core_iteration_matches_jax(pair):
    """One window's refinement at one iteration: the correlation pyramid's
    samples, the 456-wide input, the time and space transformer, the
    feature and visibility heads."""
    state, _, params, _ = pair
    model = T.CoTrackerCore(iters=1).eval()
    model.load_state_dict(state, strict=True)
    rs = np.random.RandomState(2)
    s, hh, ww, n = T.WINDOW, 24, 32, 3
    args = (rs.randn(s, hh, ww, 128).astype(np.float32),
            (rs.rand(s, n, 2) * [ww * 4 - 8, hh * 4 - 8] + 4).astype(
                np.float32),
            rs.randn(n, 128).astype(np.float32),
            np.full((s, n), 10.0, np.float32), np.ones((s, n), np.float32))
    ref = jax.jit(J.CoTrackerCore(iters=1).apply)(
        params, *map(jnp.asarray, args))
    with torch.no_grad():
        out = model(*map(torch.from_numpy, args))
    for name, a, b in zip(('coords', 'vis', 'feats'), out, ref):
        b = np.asarray(b)
        assert np.abs(a.numpy() - b).max() <= 1e-4 * max(1.0, np.abs(
            b).max()), name


def test_predictor_matches_jax(predicted):
    """Three points, two queried at frame 4 (frames 0-3 from the backward
    run on the reversed video) and one at frame 0, over 10 frames (two
    forward windows): tracks within 0.01 px; visibility within 1e-3, since
    its logits carry the transformer's fp32 rounding (fp32 against float64
    6.4e-4 after one window of this checkpoint)."""
    (ref_t, ref_v), (out_t, out_v) = predicted
    assert out_t.shape == ref_t.shape == (1, 10, 3, 2)
    assert out_v.shape == ref_v.shape == (1, 10, 3)
    assert np.abs(out_t - ref_t).max() <= 0.01
    assert np.abs(out_v - ref_v).max() <= 1e-3
    assert (np.abs(out_t).sum(-1) > 0).all()


def test_from_checkpoint_is_strict(pair, tmp_path, monkeypatch):
    """The published file wrapped as {'model': ...} with 'module.'
    prefixes loads as it is; a key short raises; find_cotracker_checkpoint
    reads $VS_COTRACKER_CKPT first."""
    state, _, _, _ = pair
    path = tmp_path / 'cotracker_stride_4_wind_8.pth'
    torch.save({'model': {f'module.{k}': v for k, v in state.items()}}, path)
    pred = T.NativeCoTrackerPredictor.from_checkpoint(str(path), 'cpu')
    for k, v in pred.model.state_dict().items():
        assert torch.equal(v, state[k]), k
    torch.save({k: v for k, v in state.items() if k != 'norm.bias'}, path)
    with pytest.raises(RuntimeError, match='norm.bias'):
        T.NativeCoTrackerPredictor.from_checkpoint(str(path), 'cpu')
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('VS_COTRACKER_CKPT', str(path))
    assert T.find_cotracker_checkpoint() == J.find_cotracker_checkpoint() \
        == str(path)
    monkeypatch.setenv('VS_COTRACKER_CKPT', '')
    assert T.find_cotracker_checkpoint() is None
