"""The sharded swap of the port against the JAX package's single-device
results, on the CPU in fp32: one spawned gloo world of five ranks. Four run
the port's `sample` at the meshes (1,2,1), (1,1,2) and (1,2,2), the blended
`validation` (256x256, 2 frames, 5 DDIM steps, the fewest that open the
latent blend, `use_blend` with cross and self replacement) at (1,2,2) and
(2,1,2), and the 32-frame windowed U-Net (window 8, stride 4) with its
frames over sp = 2, each mesh on a sub-group of the world; the fifth runs
each of them unsharded. The JAX package computes each reference once (one
jitted step a program, VS_LOOP=python) while the world runs.

The models are tests/test_multichip_blend.py's tiny ones with the U-Net
widened as tests/test_torch_blend.py widens it, to (16, 32, 32, 32) with 4
heads (with motion modules): at (8, 8, 16, 16) with 2 heads the random
U-Net is chaotic (the port's unsharded frames already differed from the
JAX package's in 5.5% of the values after the 5 steps); numpy weights
carried across by the port's converters.

Limits: latents and the windowed forward within 1e-4 of their scale of the
JAX package's and 1e-5 of the port's unsharded (fp32, sums in other
orders); the blended swap's uint8 frames as the port's other blended tests
(at most 1% of the values off, none by more than 2 levels), against both.
"""

import numpy as np
import pytest
from torch.multiprocessing import get_context

import jax
import jax.numpy as jnp
from tests.fixtures import sharded_cases
from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from tests.fixtures.torch_world import start_world
from tests.test_torch_blend import _random_params
from videoswap_torch.models.converters import jax_params_to_state_dict
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

HID = 16
UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=HID, norm_num_groups=8, motion_heads=2)
LONG_KW = dict(UNET_KW, motion_window=8, motion_window_stride=4)
CLIP_KW = dict(hidden_size=HID, num_layers=1, num_heads=2,
               intermediate_size=16)
ADAPTER_KW = dict(embedding_channels=8, channels=(16, 32, 32, 32),
                  mid_dim=4)
VAE_KW = dict(block_out_channels=(4, 4, 8, 8), norm_groups=4)
F, SIZE, SAMPLE_STEPS, BLEND_STEPS, LONG_F = 2, 256, 2, 5, 32
PROMPT = 'a cat on the floor'
SWAP = 'swap'
EDITING = {
    'use_invertion_latents': True, 'use_blend': True,
    'num_inference_steps': BLEND_STEPS, 'guidance_scale': 7.5,
    't2i_guidance_scale': 0.5, 't2i_start': 0.0, 't2i_end': 0.5,
    'editing_prompts': {SWAP: {'replace': 'cat -> fluffy dog',
                               'blend_cfg': {'cross_replace_steps': 0.7,
                                             'self_replace_steps': 0.7,
                                             'blend_th': 0.3}}}}
SAMPLE_KW = dict(prompt='a white dog on a wooden floor', video_length=F,
                 height=SIZE, width=SIZE, num_inference_steps=SAMPLE_STEPS,
                 guidance_scale=7.5, negative_prompt='low quality',
                 t2i_guidance_scale=0.5, t2i_end=0.5)
ALL = [0, 1, 2, 3]
MESHES = [('sample', (1, 2, 1), [0, 1]), ('sample', (1, 1, 2), [2, 3]),
          ('unet_long', (1, 2, 1), [0, 1]), ('sample', (1, 2, 2), ALL),
          ('validation', (1, 2, 2), ALL), ('validation', (2, 1, 2), ALL)]
PORT_RANK = 4          # the world's fifth rank runs the port unsharded


def _inputs():
    rs = np.random.RandomState(3)
    video = (rs.rand(1, F, SIZE, SIZE, 3) * 2 - 1).astype(np.float32)
    conditions = {
        'pred_tracks': np.array([[[40.0, 50.0], [120.0, 160.0]],
                                 [[44.0, 52.0], [118.0, 158.0]]],
                                np.float32),
        'point_embedding': rs.randn(2, 8).astype(np.float32),
        'point_name2id': {'head': 0, 'body': 1}, 'index_list': None}
    latents = rs.randn(1, F, SIZE // 8, SIZE // 8, 4).astype(np.float32)
    long = (rs.randn(1, LONG_F, 8, 8, 4).astype(np.float32),
            np.array([500]), rs.randn(1, 77, HID).astype(np.float32))
    return video, conditions, latents, long


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """{'jax', 'port', 'sharded'}: each of sample / validation / unet_long
    (the sharded ones by mesh shape). The world starts first and takes its
    spec through a queue; the JAX package runs while it works."""
    specq = get_context('spawn').Queue()
    world = start_world(PORT_RANK + 1, sharded_cases.swap_worker, (specq,),
                        tmp_path_factory.mktemp('swap_world'))
    key = jax.random.PRNGKey(0)
    junet, jvae = JUNet(cfg=JUNetConfig(**UNET_KW)), JVAE(**VAE_KW)
    jclip, jad = JCLIP(cfg=JCLIPConfig(**CLIP_KW)), JAdapter(
        cfg=JAdapterConfig(**ADAPTER_KW))
    h8 = SIZE // 8
    shapes = {
        'unet': jax.eval_shape(junet.init, key, jnp.zeros((1, F, h8, h8, 4)),
                               jnp.array([0]), jnp.zeros((1, 77, HID))),
        'vae': jax.eval_shape(jvae.init, key, jnp.zeros((1, 32, 32, 3))),
        'text_encoder': jax.eval_shape(jclip.init, key,
                                       jnp.zeros((1, 77), jnp.int32)),
        'adapter': jax.eval_shape(
            lambda k, t, e: jad.init(k, t, (SIZE, SIZE), e), key,
            jnp.zeros((F, 2, 2)), jnp.zeros((2, 8)))}
    params = {name: _random_params(s, i)
              for i, (name, s) in enumerate(shapes.items())}
    sd = {name: {k: v.numpy() for k, v in
                 jax_params_to_state_dict(params[name]).items()}
          for name in params}
    video, cond, lat0, long = _inputs()
    spec = {'unet_cfg': UNET_KW, 'long_unet_cfg': LONG_KW, 'sd': sd,
            'vae_kw': VAE_KW, 'clip_kw': CLIP_KW, 'adapter_kw': ADAPTER_KW,
            'video': video, 'conditions': cond, 'latents': lat0,
            'sample_kw': SAMPLE_KW, 'prompt': PROMPT, 'editing': EDITING,
            'swap': SWAP, 'long_inputs': long, 'meshes': MESHES,
            'port_rank': PORT_RANK}
    for _ in range(PORT_RANK + 1):
        specq.put(spec)

    # the JAX package, single device, while the world runs
    jpipe = JPipeline(unet=junet, vae=jvae, text_encoder=jclip,
                      tokenizer=JHashTokenizer(), sched=j_make_schedule(),
                      adapter=jad, params=params)
    mp = pytest.MonkeyPatch()
    mp.setenv('VS_LOOP', 'python')
    try:
        jax_out = {
            'sample': np.asarray(jpipe.sample(
                **SAMPLE_KW, latents=jnp.asarray(lat0), conditions=cond,
                loop='python', output_type='latent')),
            'validation': np.stack([np.asarray(f) for f in jpipe.validation(
                video, cond, PROMPT, EDITING)[SWAP]])}
    finally:
        mp.undo()
    jlong = JUNet(cfg=JUNetConfig(**LONG_KW))
    jax_out['unet_long'] = np.asarray(jax.jit(jlong.apply)(
        params['unet'], *(jnp.asarray(a) for a in long)))

    sharded = {}
    for r in world.results(timeout=600):
        sharded.update(r)
    return {'jax': jax_out, 'port': sharded.pop('port'), 'sharded': sharded}


def _uint8(video_np):
    return np.round((np.asarray(video_np)[0] + 1.0) * 127.5).astype(np.int32)


def _frames_close(a, b):
    diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return float((diff > 0).mean()) <= 1e-2 and int(diff.max()) <= 2, (
        float((diff > 0).mean()), int(diff.max()))


@pytest.mark.parametrize('kind, shape', [
    ('sample', (1, 2, 1)), ('sample', (1, 1, 2)), ('sample', (1, 2, 2)),
    ('unet_long', (1, 2, 1))])
def test_sharded_tensors_match_jax_and_the_unsharded_port(runs, kind,
                                                          shape):
    got = runs['sharded'][(kind, shape)]['out']
    ref, port = runs['jax'][kind], runs['port'][kind]
    assert got.shape == ref.shape == port.shape
    scale = float(np.abs(ref).max())
    np.testing.assert_allclose(port, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-4 * scale)
    np.testing.assert_allclose(got, port, rtol=0, atol=1e-5 * scale)
    moved = runs['sharded'][(kind, shape)]['moved']
    assert moved['all_gather'] > 0                 # eps gathered
    if shape[2] > 1:
        assert moved['all_reduce'] > 0             # tp partial sums
    if kind == 'unet_long':
        assert moved['all_to_all'] > 0             # frames -> locations


@pytest.mark.parametrize('shape', [(1, 2, 2), (2, 1, 2)])
def test_sharded_blended_swap_matches_jax_and_the_unsharded_port(runs,
                                                                 shape):
    got = _uint8(runs['sharded'][('validation', shape)]['out'])
    ref = runs['jax']['validation'].astype(np.int32)
    port = _uint8(runs['port']['validation'])
    assert got.shape == ref.shape == (F, SIZE, SIZE, 3)
    for a, b in ((port, ref), (got, ref), (got, port)):
        ok, reading = _frames_close(a, b)
        assert ok, reading
    moved = runs['sharded'][('validation', shape)]['moved']
    assert moved['all_reduce'] > 0 and moved['all_gather'] > 0
