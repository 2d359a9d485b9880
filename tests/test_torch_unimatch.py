"""The port's UniMatch (GMFlow scale2 + regrefine6) against the JAX
package's on the CPU, fp32, with the same weights: chip_smoke.py's seeded
synthetic checkpoint, loaded strictly by the port and through the JAX
converter. The key set, the shared helpers CoTracker also uses, the model
(2 refinements, as the JAX package's own test runs it), the wrapper's
protocol (a landscape frame pair and a portrait one, whose transpose
branch keeps the reference's unswapped components), and `extract_flow
--method unimatch` and `--method auto` with the checkpoint on disk (6
refinements) against the JAX package's `compute_bidirectional_flow`. The
model's test and both of the wrapper's run the JAX model at the one padded
shape, 64x96, through one JAX wrapper, which compiles it once.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_cotracker import _chip_smoke
from videoswap_tpu.preprocess import flow as jflow
from videoswap_tpu.preprocess import unimatch as J
from videoswap_torch import extract_flow
from videoswap_torch.preprocess import flow as tflow
from videoswap_torch.preprocess import unimatch as T


def _template(model):
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)),
                            jnp.zeros((1, 64, 64, 3)))
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)


@pytest.fixture(scope='module')
def pair():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    ckpt = _chip_smoke().synthetic_unimatch_state()
    model = T.UniMatchFlow(num_reg_refine=2).eval()
    model.load_state_dict(ckpt['model'], strict=True)
    params = J.convert_unimatch(
        ckpt, _template(J.UniMatchFlow(num_reg_refine=2))['params'])
    yield ckpt, model, J.UniMatchWrapper(params, num_reg_refine=2), params
    torch.set_num_threads(n)


def _scale(ref):
    return max(1.0, float(np.abs(ref).max()))


def test_checkpoint_key_set_is_the_jax_packages(pair):
    ckpt = pair[0]
    assert T.expected_checkpoint_keys() == sorted(
        J.expected_checkpoint_keys()) == sorted(ckpt['model'])
    for k in ('backbone.trident_conv.weight',
              'backbone.layer2.0.downsample.0.weight',
              'transformer.layers.5.cross_attn_ffn.mlp.0.weight',
              'feature_flow_attn.k_proj.bias', 'refine.gru.convq2.weight',
              'refine.flow_head.conv2.bias', 'refine.mask.2.weight',
              'refine_proj.weight'):
        assert k in ckpt['model'], k


def test_helpers_match_jax():
    rs = np.random.RandomState(0)
    img = rs.rand(2, 10, 12, 3).astype(np.float32)
    x = rs.rand(2, 5, 7).astype(np.float32) * 14 - 1   # some outside
    y = rs.rand(2, 5, 7).astype(np.float32) * 12 - 1
    ref = np.asarray(jax.jit(J.grid_sample)(jnp.asarray(img),
                                            jnp.asarray(x), jnp.asarray(y)))
    out = T.grid_sample(*map(torch.from_numpy, (img, x, y))).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    for hw in ((17, 21), (4, 5), (1, 3)):
        ref = np.asarray(jax.jit(J.resize_ac, static_argnums=(1, 2))(
            jnp.asarray(img), *hw))
        out = T.resize_ac(torch.from_numpy(img), *hw).numpy()
        assert np.abs(out - ref).max() <= 1e-6
    np.testing.assert_allclose(
        T.instance_norm(torch.from_numpy(img)).numpy(),
        np.asarray(jax.jit(J.instance_norm)(jnp.asarray(img))), atol=1e-5)
    np.testing.assert_array_equal(T.coords_grid(2, 3, 4).numpy(),
                                  np.asarray(J.coords_grid(2, 3, 4)))
    np.testing.assert_allclose(
        T.position_embedding_sine(4, 6).numpy(),
        np.asarray(jax.jit(J.position_embedding_sine,
                           static_argnums=(0, 1))(4, 6)), atol=1e-6)


def test_model_matches_jax(pair):
    """Backbone, swin transformer with the shift masks, global and local
    correlation softmaxes, propagation, 2 refinements, convex upsampling."""
    _, model, jwrap, params = pair
    rs = np.random.RandomState(3)
    img0 = rs.rand(1, 64, 96, 3).astype(np.float32) * 255
    img1 = np.clip(img0 + rs.randn(1, 64, 96, 3).astype(np.float32) * 20,
                   0, 255)
    ref = np.asarray(jwrap._fn((64, 96))(params, jnp.asarray(img0),
                                         jnp.asarray(img1)))
    with torch.no_grad():
        out = model(torch.from_numpy(img0), torch.from_numpy(img1)).numpy()
    assert out.shape == ref.shape == (2, 64, 96, 2)
    assert np.abs(out - ref).max() <= 1e-4 * _scale(ref)


@pytest.mark.parametrize('hw', [(50, 70), (70, 50)])
def test_wrapper_matches_jax(pair, hw):
    """Sizes resized to multiples of 32 and back with the components
    rescaled; the portrait pair through the transpose branch."""
    _, model, jwrap, _ = pair
    rs = np.random.RandomState(5)
    img0 = (rs.rand(*hw, 3) * 255).astype(np.float32)
    img1 = np.roll(img0, 2, axis=1)
    ref = jwrap.compute_flow(img0, img1)
    out = T.UniMatchWrapper(model).compute_flow(img0, img1)
    assert out.shape == ref.shape == (2,) + hw + (2,)
    assert out.dtype == np.float32
    assert np.abs(out - ref).max() <= 1e-4 * _scale(ref)


def test_extract_flow_runs_unimatch(pair, tmp_path, monkeypatch):
    """`extract_flow --method unimatch`, and `--method auto` with the
    checkpoint on disk ($VS_UNIMATCH_CKPT), write the JAX package's flows
    (6 refinements) for a pair."""
    from tests.test_torch_flow import _texture, _write_frames
    ckpt = pair[0]
    path = tmp_path / 'gmflow-scale2-regrefine6-mixdata.pth'
    torch.save(ckpt, path)
    monkeypatch.setenv('VS_UNIMATCH_CKPT', str(path))
    ys, xs = np.mgrid[0:40, 0:56].astype(np.float64)
    _write_frames(tmp_path / 'f', [_texture(xs - 2 * i, ys - i)
                                   for i in range(2)])
    frames = [extract_flow.read_frame(p)
              for p in sorted((tmp_path / 'f').iterdir())]
    ref = [jflow.compute_bidirectional_flow(*frames, method='unimatch')]
    for method in ('unimatch', 'auto'):
        out_dir = tmp_path / method
        written = extract_flow.cli(['--frame_dir', str(tmp_path / 'f'),
                                    '--out_dir', str(out_dir), '--method',
                                    method, '--device', 'cpu'])
        assert [os.path.basename(p) for p in written] == ['00000.npy']
        for p, r in zip(written, ref):
            out = np.load(p)
            assert out.shape == (2, 40, 56, 2) and out.dtype == np.float32
            assert np.abs(out - r).max() <= 1e-4 * _scale(r)
    assert tflow.resolve_method('auto') == 'unimatch'
