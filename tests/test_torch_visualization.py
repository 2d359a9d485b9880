"""Parity of the port's attention-map dumps (videoswap_torch/p2p/
visualization.py, `VideoSwapPipeline._dump_attention_maps`,
`sample(return_attn_sums=)`, `validation`'s `visualize_attention`) with the
JAX package, fp32 on the CPU, at a tiny 2D U-Net (8, 8, 16, 16) with 2
heads on 2 frames of 64x64 (256x256 for the blended swap), numpy-seeded
weights in both packages.

Checked: `aggregate_attention` on the same stores (with and without a step
axis; 1e-6); the dump's aggregated maps for both store paths against the
JAX package's (the maps its `show_cross_attention` is given, aggregated
alike): the edit's summed maps divided by the step count, and the one
U-Net pass on the encoded result at t = 261 (1e-4); then the port's
`validation` with `visualize_attention` on both paths: the heatmap strip
written under `<swap>_attention/`, the summed path fed the maps
`sample(return_attn_sums=True)` returns, and the dumped maps probabilities
(each token row sums to 1).
"""

import math
from unittest import mock

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
from videoswap_tpu.p2p import visualization as jvis
from videoswap_tpu.pipelines import VideoSwapPipeline as JPipeline
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch.builders import build_models
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.p2p import visualization as tvis
from videoswap_torch.pipelines import VideoSwapPipeline
from videoswap_torch.utils.tokenizer import HashTokenizer

F, SIZE, STEPS = 2, 64, 5
BLEND_SIZE = 256        # the blend sites share one map size from 256^2
HID = 16
UNET_KW = dict(block_out_channels=(8, 8, 16, 16), attention_head_dim=2,
               cross_attention_dim=HID, norm_num_groups=4,
               use_motion_module=False)
VAE_KW = dict(block_out_channels=(4, 4, 8, 8), norm_groups=4)
CLIP_KW = dict(hidden_size=HID, num_layers=1, num_heads=2,
               intermediate_size=16)
NAMES = ('unet', 'vae', 'text_encoder')
PROMPT = 'a man is walking on the grass'


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


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


@pytest.fixture(scope='module')
def pipes():
    key = jax.random.PRNGKey(0)
    jm = {'unet': JUNet(cfg=JUNetConfig(**UNET_KW)), 'vae': JVAE(**VAE_KW),
          'text_encoder': JCLIP(cfg=JCLIPConfig(**CLIP_KW))}
    shapes = {
        'unet': jax.eval_shape(jm['unet'].init, key,
                               jnp.zeros((1, F, 8, 8, 4)), jnp.array([0]),
                               jnp.zeros((1, 77, HID))),
        'vae': jax.eval_shape(jm['vae'].init, key,
                              jnp.zeros((1, SIZE, SIZE, 3))),
        'text_encoder': jax.eval_shape(jm['text_encoder'].init, key,
                                       jnp.zeros((1, 77), jnp.int32))}
    params = {n: _random_params(shapes[n], i) for i, n in enumerate(NAMES)}
    jpipe = JPipeline(tokenizer=JHashTokenizer(), sched=j_make_schedule(),
                      params=params, **jm)
    built = build_models({'models': {'unet': {'unet_cfg': UNET_KW},
                                     'vae_cfg': VAE_KW,
                                     'text_encoder_cfg': CLIP_KW}},
                         device='cpu')
    for n in NAMES:
        built[n].load_state_dict(jax_params_to_state_dict(params[n]),
                                 strict=True)
    built['adapter'] = None
    return jpipe, VideoSwapPipeline(**built)


def _store(rs, steps=None):
    """Random softmax maps at 8x8, 4x4 and 2x2 tokens, (F, heads, S, 77),
    under the U-Net's site names, optionally with a step axis."""
    out = {}
    for name, s in (('down_cross_0', 64), ('down_cross_2', 16),
                    ('up_cross_3', 16), ('up_cross_6', 64),
                    ('mid_cross_0', 4), ('down_self_2', 16)):
        t = 77 if 'cross' in name else s
        lead = (steps,) if steps else ()
        x = rs.randn(*lead, F, 2, s, t).astype(np.float32)
        out[name] = np.exp(x) / np.exp(x).sum(-1, keepdims=True)
    return out


@pytest.mark.parametrize('steps', [None, 3])
def test_aggregate_attention_matches_jax(steps):
    store = _store(np.random.RandomState(1), steps)
    for res, places, kind, frame in ((4, ('up', 'down'), 'cross', 0),
                                     (8, ('up', 'down'), 'cross', 1),
                                     (2, ('mid',), 'cross', 0),
                                     (4, ('down',), 'self', 1)):
        ref = jvis.aggregate_attention(store, res, res, places, kind, frame)
        ours = tvis.aggregate_attention(
            {k: torch.from_numpy(v) for k, v in store.items()}, res, res,
            places, kind, frame)
        np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)


def test_show_functions_write_their_images(tmp_path):
    store = _store(np.random.RandomState(2))
    images = tvis.show_cross_attention(HashTokenizer(), PROMPT, store, 4, 4,
                                       str(tmp_path))
    assert len(images) == len(PROMPT.split(' ')) + 2
    assert (tmp_path / 'cross_attention.png').is_file()
    tvis.show_self_attention_comp(store, 4, 4, str(tmp_path), max_com=3)
    assert len(list(tmp_path.glob('self_svd_*.png'))) == 3


def _frames(seed, size=SIZE):
    return np.random.RandomState(seed).randint(0, 256, (F, size, size, 3),
                                               dtype=np.uint8)


def _jax_dump(jpipe, frames, save_dir, **kw):
    """The JAX package's dump, and the maps its show_cross_attention is
    given, aggregated as the port aggregates them."""
    from PIL import Image
    seen = {}
    real = jvis.show_cross_attention

    def spy(tokenizer, prompt, store, ry, rx, out_dir, **k):
        seen['agg'] = jvis.aggregate_attention(jax.device_get(store), ry, rx)
        return real(tokenizer, prompt, store, ry, rx, out_dir, **k)

    with mock.patch.object(jvis, 'show_cross_attention', spy):
        jpipe._dump_attention_maps(PROMPT, [Image.fromarray(f)
                                            for f in frames],
                                   'swap', str(save_dir), **kw)
    return seen['agg']


def test_dump_of_summed_maps_matches_jax(pipes, tmp_path):
    jpipe, tpipe = pipes
    rs = np.random.RandomState(3)
    sums = {k: v * STEPS for k, v in _store(rs).items() if 'cross' in k}
    ref = _jax_dump(jpipe, _frames(4), tmp_path / 'jax',
                    attn_sums={k: jnp.asarray(v) for k, v in sums.items()},
                    num_steps=STEPS)
    ours = tpipe._dump_attention_maps(
        PROMPT, _frames(4), 'swap', str(tmp_path / 'port'),
        attn_sums={k: torch.from_numpy(v) for k, v in sums.items()},
        num_steps=STEPS)
    assert ours.shape == (4, 4, 77)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-7)
    assert (tmp_path / 'port' / 'swap_attention' /
            'cross_attention.png').is_file()


def test_dump_of_one_pass_matches_jax(pipes, tmp_path):
    """Without stores: one U-Net pass on the encoded frames at t = 261."""
    jpipe, tpipe = pipes
    ref = _jax_dump(jpipe, _frames(5), tmp_path / 'jax')
    ours = tpipe._dump_attention_maps(PROMPT, _frames(5), 'swap',
                                      str(tmp_path / 'port'))
    assert ours.shape == (4, 4, 77)
    np.testing.assert_allclose(ours, ref, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(ours.sum(-1), 1.0, rtol=0, atol=1e-5)


@pytest.mark.parametrize('use_blend', [True, False])
def test_validation_dumps_attention(pipes, tmp_path, use_blend):
    """`validation` with visualize_attention: the strip under
    `<swap>_attention/`; with use_blend the dump gets the edit's summed
    maps, those of `sample(return_attn_sums=True)`, and shows their mean
    over the steps: probabilities whose rows sum to 1."""
    _, tpipe = pipes
    cfg = {'use_invertion_latents': True, 'use_blend': use_blend,
           'guidance_scale': 7.5, 'num_inference_steps': STEPS,
           'visualize_attention': True,
           'editing_prompts': {'swap': {'replace': 'man -> dog'}}}
    seen = {}
    real_dump, real_sample = tpipe._dump_attention_maps, tpipe.sample

    def dump(*a, **kw):
        seen['sums'] = kw.get('attn_sums')
        seen['maps'] = real_dump(*a, **kw)
        return seen['maps']

    def sample(*a, **kw):
        out = real_sample(*a, **kw)
        if kw.get('return_attn_sums'):
            seen['returned'] = out[1]
        return out

    video = _frames(6, BLEND_SIZE)
    with mock.patch.object(tpipe, '_dump_attention_maps', dump), \
            mock.patch.object(tpipe, 'sample', sample):
        out = tpipe.validation(video, None, PROMPT, cfg,
                               save_dir=str(tmp_path), output_type='uint8')
    assert out['swap'].shape == (F, BLEND_SIZE, BLEND_SIZE, 3)
    assert (tmp_path / 'swap_attention' / 'cross_attention.png').is_file()
    if use_blend:
        assert seen['sums'] is seen['returned'] and seen['sums']
        assert all(v.shape[-1] == 77 for v in seen['sums'].values())
    else:
        assert seen['sums'] is None and 'returned' not in seen
    np.testing.assert_allclose(seen['maps'].sum(-1), 1.0, rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match='latent'):
        tpipe.validation(video, None, PROMPT, cfg, save_dir=str(tmp_path),
                         output_type='latent')
