"""The port's DIFT features against the JAX package on the CPU, fp32: the
U-Net's `up_block_1` tap (videoswap_tpu sows it into its 'features'
collection), `SDFeaturizer.forward` given the JAX package's noise draw,
`_resize_feat`, `dift_query` (at the target pixel alone where it is given
one), and `matching_flow.dift_features`.

A tiny U-Net with its motion modules on, the ensemble of 2 on the frame
axis, a tiny VAE and CLIP text model, seeded random weights carried from
the JAX tree by `jax_params_to_state_dict`; a 72x104 frame, whose latent
(9x13) makes every U-Net level ragged. The JAX featurizer runs once, in a
module-scoped fixture.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.models import (AnimateDiffUNet3DModel as JUNet,
                                  UNet3DConfig as JUNetConfig)
from videoswap_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_tpu.preprocess import dift as jdift
from videoswap_tpu.preprocess import matching_flow as jmf
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch.models import AnimateDiffUNet3DModel, UNet3DConfig
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.preprocess import dift as tdift
from videoswap_torch.preprocess import matching_flow as tmf
from videoswap_torch.schedulers import make_schedule
from videoswap_torch.utils.tokenizer import HashTokenizer

UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=24, norm_num_groups=8, motion_heads=4)
CLIP_KW = dict(vocab_size=49408, hidden_size=24, num_layers=1, num_heads=4,
               intermediate_size=32)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)
ENSEMBLE = 2
H, W = 72, 104
PROMPT = 'photo of a swan'


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


def _frame(seed):
    rs = np.random.RandomState(seed)
    return (rs.rand(H, W, 3) * 2 - 1).astype(np.float32)


@pytest.fixture(scope='module')
def models():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    key = jax.random.PRNGKey(0)
    junet = JUNet(cfg=JUNetConfig(**UNET_KW), attn_impl='flash')
    jvae = JVAE(**VAE_KW)
    jclip = JCLIP(cfg=JCLIPConfig(**CLIP_KW))
    shapes = {
        'unet': jax.eval_shape(junet.init, key,
                               jnp.zeros((1, ENSEMBLE, 8, 8, 4)),
                               jnp.array([0]), jnp.zeros((1, 77, 24))),
        'vae': jax.eval_shape(jvae.init, key, jnp.zeros((1, 32, 32, 3))),
        'text_encoder': jax.eval_shape(jclip.init, key,
                                       jnp.zeros((1, 77), jnp.int32)),
    }
    params = {name: _random_params(s, i + 3)
              for i, (name, s) in enumerate(shapes.items())}
    mods = {'unet': AnimateDiffUNet3DModel(UNet3DConfig(**UNET_KW)),
            'vae': AutoencoderKL(**VAE_KW),
            'text_encoder': CLIPTextModel(CLIPTextConfig(**CLIP_KW))}
    for name, m in mods.items():
        m.load_state_dict(jax_params_to_state_dict(params[name]), strict=True)
        m.eval()
    jfeat = jdift.SDFeaturizer(
        unet=junet, vae=jvae, text_encoder=jclip, tokenizer=JHashTokenizer(),
        sched=j_make_schedule(), params=params, ensemble_size=ENSEMBLE)
    tfeat = tdift.SDFeaturizer(
        unet=mods['unet'], vae=mods['vae'],
        text_encoder=mods['text_encoder'], tokenizer=HashTokenizer(),
        sched=make_schedule(), ensemble_size=ENSEMBLE)
    yield jfeat, tfeat, params
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def jax_features(models):
    """The JAX featurizer on two frames (PRNGKey(0) at each call, its
    default), and the draw it added, made again outside its jit."""
    jfeat, tfeat, _ = models
    shape = tfeat.noise_shape((H, W))
    noise = np.array(jax.random.normal(jax.random.PRNGKey(0), shape,
                                       jnp.float32))
    return ([jfeat.forward(_frame(s), PROMPT) for s in (0, 1)],
            torch.from_numpy(noise))


def test_up_block_1_tap_matches_jax(models):
    """The tap the port's forward returns, early exit included, against the
    JAX U-Net's sown `up_block_1`, on the same noisy latents, timestep and
    text; and the early exit's tap equals the tap of a forward through
    every up block."""
    jfeat, tfeat, params = models
    rs = np.random.RandomState(5)
    x = rs.randn(1, ENSEMBLE, 9, 13, 4).astype(np.float32)
    text = rs.randn(1, 77, 24).astype(np.float32)
    apply = jax.jit(lambda p, a, c: jfeat.unet.apply(
        p, a, jnp.asarray([261]), c, mutable=['features'])[1]['features'])
    ref = apply(params['unet'], jnp.asarray(x), jnp.asarray(text))
    ref = np.asarray(ref['up_block_1'][0]
                     if isinstance(ref['up_block_1'], tuple)
                     else ref['up_block_1'])
    with torch.no_grad():
        args = (torch.from_numpy(x), torch.tensor([261]),
                torch.from_numpy(text))
        early = tfeat.unet(*args, features=['up_block_1'])
        full = tfeat.unet(*args, features=['up_block_1', 'up_block_3'])
    assert list(early) == ['up_block_1']
    tap = early['up_block_1'].numpy()
    assert tap.shape == ref.shape == (1, ENSEMBLE, 5, 7, 32)
    scale = np.abs(ref).max()
    assert np.abs(tap - ref).max() <= 1e-4 * scale
    np.testing.assert_array_equal(tap, full['up_block_1'].numpy())
    assert full['up_block_3'].shape == (1, ENSEMBLE, 9, 13, 16)
    with pytest.raises(ValueError, match='up_block_9'):
        tfeat.unet(*args, features=['up_block_9'])


def test_featurizer_matches_jax_given_its_draw(models, jax_features):
    """SDFeaturizer.forward with the JAX package's draw against the JAX
    featurizer: the VAE posterior's mean, the ensemble on the frame axis,
    add_noise at t = 261, the text, the ensemble mean of the tap."""
    _, tfeat, _ = models
    refs, noise = jax_features
    for seed, ref in zip((0, 1), refs):
        out = tfeat.forward(_frame(seed), PROMPT, noise=noise).numpy()
        assert out.shape == ref.shape == (5, 7, 32)
        assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def test_featurizer_draws_the_same_noise_at_every_call(models, monkeypatch):
    """Without a draw given, every call adds the same one (a generator
    seeded anew at each call, as the JAX package's PRNGKey(0)); another
    seed gives other features."""
    _, tfeat, _ = models
    a = tfeat.forward(_frame(0), PROMPT)
    tfeat.forward(_frame(1), PROMPT)
    np.testing.assert_array_equal(a.numpy(),
                                  tfeat.forward(_frame(0), PROMPT).numpy())
    gen = torch.Generator().manual_seed(tdift.NOISE_SEED)
    own = torch.randn(tfeat.noise_shape((H, W)), generator=gen)
    np.testing.assert_array_equal(
        a.numpy(), tfeat.forward(_frame(0), PROMPT, noise=own).numpy())
    monkeypatch.setattr(tdift, 'NOISE_SEED', 1)
    assert np.abs(tfeat.forward(_frame(0), PROMPT).numpy()
                  - a.numpy()).max() > 1e-3


@pytest.mark.parametrize('hw', [(72, 104), (3, 4)])
def test_resize_feat_matches_jax(hw):
    """Up (the DIFT maps' way) and down (antialiased), and the port's
    pixel-only resize (`feature_at`) against the full map."""
    feat = np.random.RandomState(2).randn(5, 7, 16).astype(np.float32)
    ref = np.asarray(jdift._resize_feat(feat, *hw))
    out = tdift._resize_feat(feat, *hw).numpy()
    assert out.shape == ref.shape == hw + (16,)
    assert np.abs(out - ref).max() <= 1e-5
    ys = np.array([0, hw[0] - 1, hw[0] // 2])
    xs = np.array([hw[1] - 1, 0, hw[1] // 3])
    at = tdift.feature_at(feat, hw, ys, xs).numpy()
    assert np.abs(at - ref[ys, xs]).max() <= 1e-5


def test_dift_query_matches_jax():
    """The best match, the cosine and the target's vector without a target
    pixel; with one (rounded and clipped as the reference does), the cosine
    and the vector there, read at the two pixels alone (no match searched)."""
    rs = np.random.RandomState(3)
    src = rs.randn(5, 7, 32).astype(np.float32)
    tgt = (src + 0.3 * rs.randn(5, 7, 32)).astype(np.float32)
    hw = (72, 104)
    for query, target in (((30.4, 20.6), None), ((10.5, 70.2), (50.5, 12.5)),
                          ((-3.0, 80.0), (120.0, -2.0))):
        ref = jdift.dift_query(src, hw, query, tgt, hw, target_xy=target)
        out = tdift.dift_query(src, hw, query, tgt, hw, target_xy=target)
        assert out[0] == (ref[0] if target is None else None)
        assert abs(out[1] - ref[1]) <= 1e-5
        np.testing.assert_allclose(out[2], ref[2], atol=1e-5)


def test_dift_features_matches_jax(models, jax_features):
    """matching_flow.dift_features: a [0, 255] frame scaled to [-1, 1] on
    both sides (the port given the JAX package's draw)."""
    jfeat, tfeat, _ = models
    _, noise = jax_features
    frame = (_frame(0) + 1) * 127.5
    ref = jmf.dift_features(jfeat, frame)
    real = tfeat.forward
    tfeat.forward = lambda img, prompt: real(img, prompt, noise=noise)
    try:
        out = tmf.dift_features(tfeat, frame).numpy()
    finally:
        del tfeat.forward
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
