"""Parity of the port's blended production path with the JAX package, on
the CPU in fp32, at a tiny config: `invert` (latents and attention stores)
and `validation` at 256x256 (the smallest blend geometry), 2 frames, 5 DDIM
steps (the fewest that open the latent-blend window), CFG 7.5, the point
adapter, cross and self replacement 0.5 with latent blending, and one swap
carrying a synthetic ED-LoRA file (a concept embedding, and a rank-2 LoRA
on every eligible U-Net and text-encoder weight), in both recompute-self
tiers. Both pipelines load the same numpy weights.

The U-Net has no motion modules: the attention control never reaches them,
their parity is held by test_torch_fused_temporal.py and
test_torch_models.py, and without them the JAX reference compiles in half
the time. The JAX package's validation runs once (one jitted step a
program, VS_LOOP=python), in the recompute tier, the production tier at
512^2 and the one with the more machinery; its inversion stores every
controlled site (a superset of what the tier reads: the maps do not depend
on what is stored), so that the port's inversion is held to it site by
site. Both of the port's tiers are held to that one result: the JAX
package's own tests hold its two tiers to each other
(tests/test_p2p_integration.py), and the port's two tiers agree to 1e-5.

Limits: the inversion's latents to 1e-4 of their scale and its maps to
1e-4 (fp32, sums in other orders). The uint8 frames at the end: reduction-
order noise through 5 steps of CFG 7.5 flips a value next to a rounding
edge by a level; at most 1% of the values may differ, none by more than 2
levels.
"""

import math

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
from videoswap_tpu.p2p import AttnCtrl as JAttnCtrl
from videoswap_tpu.pipelines import VideoSwapPipeline as JPipeline
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch.edlora import _TEXT_LORA, _UNET_LORA, _eligible
from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                    SparsePointAdapter, UNet3DConfig)
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.converters import (clip_key_map,
                                               jax_params_to_state_dict)
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.p2p import AttnCtrl
from videoswap_torch.pipelines import VideoSwapPipeline
from videoswap_torch.schedulers import make_schedule
from videoswap_torch.utils.tokenizer import HashTokenizer

HID = 16
# at (8, 8, 16, 16) with 2 heads the random U-Net is chaotic: fp32
# rounding grew to 1e-3 over 5 inversion steps
UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=HID, norm_num_groups=8,
               use_motion_module=False)
CLIP_KW = dict(hidden_size=HID, num_layers=1, num_heads=2,
               intermediate_size=16)
ADAPTER_KW = dict(embedding_channels=12, channels=(16, 32, 32, 32),
                  mid_dim=8)
VAE_KW = dict(block_out_channels=(4, 4, 8, 8), norm_groups=4)
F, SIZE, STEPS = 2, 256, 5
PROMPT = 'a cat walking on the floor'


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

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _lora_file(path, unet_sd, text_sd):
    """A synthetic ED-LoRA checkpoint: concept 'catA1' (16 layer
    embeddings) and a rank-2 LoRA on every eligible weight."""
    rs = np.random.RandomState(7)

    def loras(sd, names, key_map=None):
        out = {}
        for k, w in sd.items():
            if _eligible(k, names):
                k = key_map(k) if key_map else k
                o, i, *kern = w.shape
                for part, shape in (('down', (2, i, *kern)),
                                    ('up', (o, 2, *kern))):
                    out[k.replace('.weight', f'.lora_{part}.weight')] = \
                        torch.from_numpy(
                            (0.1 * rs.randn(*shape)).astype(np.float32))
        return out

    torch.save({'params': {
        'new_concept_embedding': {'catA1': torch.from_numpy(
            rs.randn(16, HID).astype(np.float32))},
        'unet': loras(unet_sd, _UNET_LORA),
        'text_encoder': loras(text_sd, _TEXT_LORA, clip_key_map)}}, path)


@pytest.fixture(scope='module')
def pipes(tmp_path_factory):
    key = jax.random.PRNGKey(0)
    junet = JUNet(cfg=JUNetConfig(**UNET_KW))
    jvae = JVAE(**VAE_KW)
    jclip = JCLIP(cfg=JCLIPConfig(**CLIP_KW))
    jad = JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))
    h8 = SIZE // 8
    shapes = {
        'unet': jax.eval_shape(junet.init, key, jnp.zeros((1, F, h8, h8, 4)),
                               jnp.array([0]), jnp.zeros((1, 77, HID))),
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
    lora = tmp_path_factory.mktemp('edlora') / 'edlora_catA1.pth'
    _lora_file(lora, mods['unet'].state_dict(),
               mods['text_encoder'].state_dict())
    return jpipe, tpipe, str(lora)


def _inputs():
    rs = np.random.RandomState(3)
    video = (rs.rand(1, F, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)
    conditions = {'pred_tracks': (rs.rand(F, 3, 2) * SIZE).astype(np.float32),
                  'point_embedding': rs.randn(3, 12).astype(np.float32)}
    return video, conditions


def _editing_config(lora, recompute):
    blend_cfg = {'cross_replace_steps': 0.5, 'self_replace_steps': 0.5}
    return {
        'use_invertion_latents': True, 'use_blend': True,
        'num_inference_steps': STEPS, 'guidance_scale': 7.5,
        'negative_prompt': 'low quality', 'recompute_self_stores': recompute,
        't2i_guidance_scale': 0.5, 't2i_start': 0.0, 't2i_end': 0.3,
        'editing_prompts': {
            'cat_to_concept': {'replace': 'cat -> catA1',
                               'lora_path': f'{lora}---0.7',
                               'blend_cfg': dict(blend_cfg),
                               't2i_guidance_scale': 0.4}}}


@pytest.fixture(scope='module')
def jax_runs(pipes):
    """The JAX package's validation (recompute tier), its inversion storing
    every controlled site, and that inversion."""
    jpipe, _, lora = pipes
    video, conditions = _inputs()
    mp = pytest.MonkeyPatch()
    mp.setenv('VS_LOOP', 'python')
    real_invert, kept = jpipe.invert, {}

    def invert(*args, **kwargs):
        kwargs['store_ctrl'] = JAttnCtrl('store')
        kept['out'] = real_invert(*args, **kwargs)
        return kept['out']

    mp.setattr(jpipe, 'invert', invert)
    try:
        frames = {k: np.stack([np.asarray(f) for f in v])
                  for k, v in jpipe.validation(
                      video, conditions, PROMPT,
                      _editing_config(lora, True)).items()}
    finally:
        mp.undo()
    return frames, kept['out']


def test_invert_matches_jax(pipes, jax_runs):
    _, tpipe, _ = pipes
    jlat, jper = jax_runs[1]
    video, _ = _inputs()
    lat, per = tpipe.invert(video, PROMPT, STEPS,
                            store_ctrl=AttnCtrl('store'))
    scale = float(np.abs(np.asarray(jper['latents'])).max())
    for a, b in ((lat, jlat), (per['latents'], jper['latents']),
                 (per['z0'], jper['z0']), (per['src_text'], jper['src_text'])):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-4 * scale)
    np.testing.assert_array_equal(per['ts'].numpy(), np.asarray(jper['ts']))
    assert sorted(per['attn']) == sorted(jper['attn'])
    assert any('self' in k for k in per['attn'])
    for k, a in per['attn'].items():
        assert a.shape[0] == STEPS
        np.testing.assert_allclose(a.numpy(), np.asarray(jper['attn'][k]),
                                   rtol=0, atol=1e-4)


@pytest.fixture(scope='module')
def port_runs(pipes):
    _, tpipe, lora = pipes
    video, conditions = _inputs()
    before = {k: v.clone() for k, v in tpipe.unet.state_dict().items()}
    text_before = {k: v.clone()
                   for k, v in tpipe.text_encoder.state_dict().items()}
    steps = {False: [], True: []}
    out = {tier: tpipe.validation(
        video, conditions, PROMPT, _editing_config(lora, tier),
        output_type='np',
        callback=lambda stage, i, t, lat, tier=tier: steps[tier].append(
            (stage, i)))
        for tier in (False, True)}
    restored = (all(torch.equal(before[k], v)
                    for k, v in tpipe.unet.state_dict().items())
                and all(torch.equal(text_before[k], v)
                        for k, v in tpipe.text_encoder.state_dict().items())
                and tpipe.new_concept_cfg is None
                and tpipe.extra_token_embeds is None)
    return out, restored, steps


@pytest.mark.parametrize('recompute', [False, True])
def test_validation_matches_jax(jax_runs, port_runs, recompute):
    out, restored, _ = port_runs
    # the ED-LoRA swap put the weights and the text state back
    assert restored
    ref = jax_runs[0]
    assert sorted(out[recompute]) == sorted(ref)
    for key, video_np in out[recompute].items():
        assert video_np.shape == (1, F, SIZE, SIZE, 3)
        frames = np.round((video_np[0] + 1.0) * 127.5).astype(np.int32)
        diff = np.abs(frames - ref[key].astype(np.int32))
        assert float((diff > 0).mean()) <= 1e-2, (key, (diff > 0).mean())
        assert int(diff.max()) <= 2, (key, diff.max())


def test_recompute_tier_equals_stored_tier(port_runs):
    out, _, steps = port_runs
    # the callback saw every inversion step, then every step of each swap
    for tier in (False, True):
        assert steps[tier] == [(stage, i) for stage in ['invert', *out[tier]]
                               for i in range(STEPS)]
    for key, video_np in out[False].items():
        np.testing.assert_allclose(out[True][key], video_np, rtol=0,
                                   atol=1e-5)
