"""Parity of the port's `VideoSwapPipeline.sample` with the JAX package at a
tiny config: 256x256 (so CFG-prefix dedup applies), 2 frames, 3 DDIM steps,
CFG 7.5 with a negative prompt, point adapter gated to the first half of
the steps. Both pipelines start from the same numpy latents and load the
same seeded random weights (JAX tree -> `jax_params_to_state_dict`), and
run in fp32 on the CPU. Also: the port imports and runs with JAX blocked,
and refuses what it does not port yet.
"""

import math
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.models import (AdapterConfig as JAdapterConfig,
                                  AnimateDiffUNet3DModel as JUNet,
                                  SparsePointAdapter as JAdapter,
                                  UNet3DConfig as JUNetConfig)
from videoswap_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_tpu.pipelines import VideoSwapPipeline as JPipeline
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                    SparsePointAdapter, UNet3DConfig)
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.pipelines import VideoSwapPipeline
from videoswap_torch.schedulers import make_schedule
from videoswap_torch.utils.tokenizer import HashTokenizer

torch.backends.cudnn.allow_tf32 = False


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    # the suite runs several pytest workers on one host, and JAX's CPU
    # backend has a pool of its own: a small torch pool keeps the workers
    # from oversubscribing the cores
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

ROOT = Path(__file__).resolve().parents[1]
UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=24, norm_num_groups=8, motion_heads=4)
CLIP_KW = dict(vocab_size=49408, hidden_size=24, num_layers=1, num_heads=4,
               intermediate_size=32)
ADAPTER_KW = dict(embedding_channels=12, channels=(16, 32, 32, 32),
                  mid_dim=8)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)
F, SIZE, STEPS = 2, 256, 3


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
    junet = JUNet(cfg=JUNetConfig(**UNET_KW), attn_impl='flash')
    jvae = JVAE(**VAE_KW)
    jclip = JCLIP(cfg=JCLIPConfig(**CLIP_KW))
    jad = JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))
    h8 = SIZE // 8
    shapes = {
        'unet': jax.eval_shape(junet.init, key, jnp.zeros((1, F, h8, h8, 4)),
                               jnp.array([0]), jnp.zeros((1, 77, 24))),
        'vae': jax.eval_shape(jvae.init, key, jnp.zeros((1, 32, 32, 3))),
        'text_encoder': jax.eval_shape(jclip.init, key,
                                       jnp.zeros((1, 77), jnp.int32)),
        'adapter': jax.eval_shape(
            lambda k, t, e: jad.init(k, t, (SIZE, SIZE), e), key,
            jnp.zeros((F, 3, 2)), jnp.zeros((3, 12))),
    }
    params = {name: _random_params(s, i)
              for i, (name, s) in enumerate(shapes.items())}
    jpipe = JPipeline(unet=junet, vae=jvae, text_encoder=jclip,
                      tokenizer=JHashTokenizer(), sched=j_make_schedule(),
                      adapter=jad, params=params)
    mods = {
        'unet': AnimateDiffUNet3DModel(UNet3DConfig(**UNET_KW)),
        'vae': AutoencoderKL(**VAE_KW),
        'text_encoder': CLIPTextModel(CLIPTextConfig(**CLIP_KW)),
        'adapter': SparsePointAdapter(AdapterConfig(**ADAPTER_KW)),
    }
    for name, m in mods.items():
        m.load_state_dict(jax_params_to_state_dict(params[name]), strict=True)
        m.eval()
    tpipe = VideoSwapPipeline(tokenizer=HashTokenizer(),
                              sched=make_schedule(), **mods)
    return jpipe, tpipe


def _kwargs():
    rs = np.random.RandomState(0)
    conditions = {
        'pred_tracks': (rs.rand(F, 3, 2) * SIZE).astype(np.float32),
        'point_embedding': rs.randn(3, 12).astype(np.float32),
        'index_list': [0, 2],
    }
    conditions['pred_tracks'][1, 1] = -1.0            # invisible point
    return dict(prompt='a white dog on a wooden floor', video_length=F,
                height=SIZE, width=SIZE, num_inference_steps=STEPS,
                guidance_scale=7.5, negative_prompt='low quality',
                conditions=conditions, t2i_guidance_scale=0.5,
                t2i_start=0.0, t2i_end=0.5)


def _latents():
    return np.random.RandomState(1).randn(1, F, SIZE // 8, SIZE // 8,
                                          4).astype(np.float32)


@pytest.mark.parametrize('output_type', ['latent', 'np'])
def test_sample_matches_jax(pipes, output_type):
    jpipe, tpipe = pipes
    lat0 = _latents()
    ref = np.asarray(jpipe.sample(latents=jnp.asarray(lat0), loop='python',
                                  output_type=output_type, **_kwargs()))
    out = tpipe.sample(latents=torch.from_numpy(lat0),
                       output_type=output_type, **_kwargs())
    if output_type == 'latent':
        out = out.numpy()
        assert out.shape == lat0.shape
        # fp32 through 3 steps of a random-weight U-Net, sums in another
        # order: agreement to 1e-4 of the latents' scale
        scale = max(1.0, float(np.abs(ref).max()))
        assert float(np.abs(out - ref).max()) <= 1e-4 * scale
        return
    assert out.shape == (1, F, SIZE, SIZE, 3)
    to_u8 = (lambda v: np.round((v + 1.0) * 127.5).astype(np.int32))
    diff = np.abs(to_u8(out) - to_u8(ref))
    # both quantise the same fp32 decode up to reduction-order noise: a
    # uint8 level flips only where a value sits next to a rounding edge
    assert float((diff > 0).mean()) <= 1e-3
    assert int(diff.max()) <= 1


def test_adapter_window_and_points_change_the_result(pipes):
    _, tpipe = pipes
    lat0 = torch.from_numpy(_latents())
    kw = _kwargs()
    a = tpipe.sample(latents=lat0, output_type='latent', **kw)
    kw_none = dict(kw, conditions=None)
    b = tpipe.sample(latents=lat0, output_type='latent', **kw_none)
    assert float((a - b).abs().max()) > 1e-6
    kw_late = dict(kw, t2i_start=0.9, t2i_end=1.0)   # gate opens at step 2.7
    c = tpipe.sample(latents=lat0, output_type='latent', **kw_late)
    np.testing.assert_allclose(c.numpy(), b.numpy(), rtol=0, atol=0)


def test_rescale_noise_cfg_matches_jax():
    from videoswap_tpu.pipelines.videoswap_pipeline import \
        rescale_noise_cfg as j_rescale
    from videoswap_torch.pipelines import rescale_noise_cfg
    rs = np.random.RandomState(2)
    cfg, text = (rs.randn(1, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    ref = j_rescale(jnp.asarray(cfg), jnp.asarray(text), 0.7)
    out = rescale_noise_cfg(torch.from_numpy(cfg), torch.from_numpy(text),
                            0.7)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sample_refuses_what_is_not_ported(pipes):
    _, tpipe = pipes
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tpipe.sample('a cat', F, 64, 64, num_inference_steps=1,
                     edit_bundle=object())
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        tpipe.sample('a cat', F, 64, 64, num_inference_steps=1,
                     sampler='dpmpp_2m')


def test_port_runs_with_jax_blocked():
    """The port imports nothing of JAX, flax or videoswap_tpu: with both
    blocked, import the package, build the tiny pipeline and sample, then
    build the models through `builders` and take a training step."""
    code = textwrap.dedent(f'''
        import sys
        sys.modules['jax'] = None
        sys.modules['flax'] = None
        sys.path.insert(0, {str(ROOT)!r})
        import torch
        import videoswap_torch
        from videoswap_torch.models import (AdapterConfig,
            AnimateDiffUNet3DModel, SparsePointAdapter, UNet3DConfig)
        from videoswap_torch.models.clip_text import (CLIPTextConfig,
            CLIPTextModel)
        from videoswap_torch.models.vae import AutoencoderKL
        from videoswap_torch.pipelines import VideoSwapPipeline
        from videoswap_torch.schedulers import make_schedule
        from videoswap_torch.utils.init import init_weights
        from videoswap_torch.utils.tokenizer import HashTokenizer
        mods = dict(
            unet=AnimateDiffUNet3DModel(UNet3DConfig(**{UNET_KW!r})),
            vae=AutoencoderKL(**{VAE_KW!r}),
            text_encoder=CLIPTextModel(CLIPTextConfig(**{CLIP_KW!r})),
            adapter=SparsePointAdapter(AdapterConfig(**{ADAPTER_KW!r})))
        g = torch.Generator().manual_seed(0)
        for m in mods.values():
            init_weights(m, g)
        pipe = VideoSwapPipeline(tokenizer=HashTokenizer(),
                                 sched=make_schedule(), **mods)
        out = pipe.sample('a cat', 2, 64, 64, num_inference_steps=1,
                          output_type='np', generator=g)
        assert out.shape == (1, 2, 64, 64, 3), out.shape
        from videoswap_torch.builders import build_models
        from videoswap_torch.pipelines import VideoSwapTrainer
        built = build_models(
            {{'unet': {{'unet_cfg': {UNET_KW!r}}}, 'vae_cfg': {VAE_KW!r},
             'text_encoder_cfg': {CLIP_KW!r},
             'adapter': {{'adapter_cfg': {ADAPTER_KW!r}}}}}, device='cpu')
        trainer = VideoSwapTrainer(
            tune_cfg={{'drop_rate': 0.2, 'min_timestep': 0.5}}, **built)
        batch = {{'pixels': torch.rand(1, 2, 64, 64, 3) * 2 - 1,
                 'input_ids': torch.zeros(1, 77, dtype=torch.long),
                 'pred_tracks': torch.rand(2, 3, 2) * 64,
                 'point_embedding': torch.randn(3, 12)}}
        loss = trainer.step(batch, g)
        assert torch.isfinite(loss), loss
        loaded = [m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'flax', 'videoswap_tpu')
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print('ok')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=300, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')
