"""Parity of the port's models (videoswap_torch/models) with the JAX package
at tiny configs: the weight bridge, ResnetBlock3D, Transformer3DModel (with
CFG-prefix expansion), VanillaTemporalModule, the full U-Net (adapter
residuals, cfg_prefix_dedup), CLIP text, the point adapter, the VAE, the
DDIM schedule and the tokenizer.

Each JAX model is initialised, its parameters replaced by seeded random
values (so that zero-initialised layers such as the motion proj_out take
part), converted with `jax_params_to_state_dict` and loaded with
`strict=True`. Both sides then run in fp32 on the CPU on the same numpy
inputs.
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
from videoswap_tpu.models.attention_blocks import \
    Transformer3DModel as JTransformer3D
from videoswap_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from videoswap_tpu.models.motion_module import \
    VanillaTemporalModule as JMotion
from videoswap_tpu.models.resnet3d import ResnetBlock3D as JResnet
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_tpu import schedulers as jsched
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch import schedulers as tsched
from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                    SparsePointAdapter, UNet3DConfig)
from videoswap_torch.models.attention_blocks import Transformer3DModel
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.converters import (flax_path_to_torch_key,
                                               jax_params_to_state_dict)
from videoswap_torch.models.motion_module import VanillaTemporalModule
from videoswap_torch.models.resnet3d import ResnetBlock3D
from videoswap_torch.models.vae import AutoencoderKL
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

UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=24, norm_num_groups=8, motion_heads=4)
CLIP_KW = dict(vocab_size=49408, hidden_size=24, num_layers=2, num_heads=4,
               intermediate_size=32)
ADAPTER_KW = dict(embedding_channels=12, channels=(16, 32, 32, 32),
                  mid_dim=8)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)


def init_shapes(module, *args, **kwargs):
    """The module's parameter shapes, traced without running the init."""
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), *args,
                          **kwargs)


def randomize(variables, seed):
    """{'params': tree} with seeded random values in place of every
    parameter (only shapes are read): kernels N(0, 1/fan_in), scales
    1 + N(0, 0.1), biases N(0, 0.1), embedding tables N(0, 0.02)."""
    rs = np.random.RandomState(seed)

    def leaf(path, x):
        name = str(getattr(path[-1], 'key', path[-1]))
        shape = x.shape
        if name == 'kernel':
            v = rs.randn(*shape) / math.sqrt(np.prod(shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rs.randn(*shape)
        elif name == 'bias':
            v = 0.1 * rs.randn(*shape)
        else:
            v = 0.02 * rs.randn(*shape)
        return v.astype(np.float32)

    return {'params': jax.tree_util.tree_map_with_path(
        leaf, variables['params'])}


def port(module, params):
    """Load JAX params into a torch module, strictly."""
    sd = jax_params_to_state_dict(params)
    n_leaves = len(jax.tree_util.tree_leaves(params['params']))
    assert len(sd) == n_leaves, 'two flax paths mapped to one key'
    result = module.load_state_dict(sd, strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    return module.eval()


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


def assert_close(out, ref, tol):
    """max |out - ref| <= tol * max(1, max |ref|)."""
    out = out.detach().numpy() if isinstance(out, torch.Tensor) else out
    ref = np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = max(1.0, float(np.abs(ref).max()))
    err = float(np.abs(out - ref).max())
    assert err <= tol * scale, f'max abs err {err:.3e} > {tol * scale:.3e}'


# fp32 on both sides through tens of layers, with sums in another order:
# a few fp32 ulps per op, amplified by random weights
TOL = 1e-4


# ----------------------------------------------------------- weight bridge
@pytest.mark.parametrize('path,key', [
    (('down_blocks_0', 'resnets_1', 'conv1', 'conv2d', 'kernel'),
     'down_blocks.0.resnets.1.conv1.weight'),
    (('time_embedding', 'linear_1', 'kernel'),
     'time_embedding.linear_1.weight'),
    (('attn1', 'to_out_0', 'bias'), 'attn1.to_out.0.bias'),
    (('ff', 'net_0_proj', 'kernel'), 'ff.net.0.proj.weight'),
    (('encoder', 'down_blocks_0_resnets_1', 'norm1', 'scale'),
     'encoder.down_blocks.0.resnets.1.norm1.weight'),
    (('token_embedding',), 'token_embedding.weight'),
    (('model_list_2_mlp_0', 'kernel'), 'model_list.2.mlp.0.weight'),
])
def test_flax_path_to_torch_key(path, key):
    assert flax_path_to_torch_key(path) == key


def test_bridge_transposes_by_rank():
    params = {'params': {
        'd': {'kernel': np.arange(6, dtype=np.float32).reshape(2, 3)},
        'c': {'conv2d': {'kernel': np.zeros((3, 3, 4, 5), np.float32)}},
        'n': {'scale': np.ones(7, np.float32)}}}
    sd = jax_params_to_state_dict(params)
    assert sd['d.weight'].shape == (3, 2)
    assert sd['d.weight'][2, 1] == 5.0
    assert sd['c.weight'].shape == (5, 4, 3, 3)
    assert sd['n.weight'].shape == (7,)


@pytest.fixture(scope='module')
def unet_pair():
    cfg = JUNetConfig(**UNET_KW)
    junet = JUNet(cfg=cfg, attn_impl='flash')
    params = randomize(init_shapes(junet, jnp.zeros((1, 2, 32, 32, 4)),
                                   jnp.array([0]), jnp.zeros((1, 77, 24))),
                       1)
    tunet = port(AnimateDiffUNet3DModel(UNet3DConfig(**UNET_KW)), params)
    return junet, params, tunet


def test_bridge_loads_every_model_strictly(unet_pair):
    """U-Net (above), VAE, CLIP text and adapter: strict load, every
    parameter of the JAX tree used once."""
    vae = randomize(init_shapes(JVAE(**VAE_KW), jnp.zeros((1, 32, 32, 3))),
                    0)
    port(AutoencoderKL(**VAE_KW), vae)
    clip = randomize(init_shapes(JCLIP(cfg=JCLIPConfig(**CLIP_KW)),
                                 jnp.zeros((1, 77), jnp.int32)), 0)
    port(CLIPTextModel(CLIPTextConfig(**CLIP_KW)), clip)
    jad = JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))
    ad = randomize(jax.eval_shape(
        lambda k, t, e: jad.init(k, t, (64, 64), e), jax.random.PRNGKey(0),
        jnp.zeros((2, 3, 2)), jnp.zeros((3, 12))), 0)
    port(SparsePointAdapter(AdapterConfig(**ADAPTER_KW)), ad)
    _, params, tunet = unet_pair
    n_torch = sum(1 for _ in tunet.parameters())
    assert n_torch == len(jax.tree_util.tree_leaves(params['params']))


# ----------------------------------------------------------------- modules
@pytest.mark.parametrize('cin,cout', [(16, 32), (32, 32)])
def test_resnet_block_parity(cin, cout):
    rs = np.random.RandomState(cin)
    x = rs.randn(2, 3, 8, 8, cin).astype(np.float32)
    temb = rs.randn(2, 64).astype(np.float32)
    jm = JResnet(out_channels=cout, eps=1e-5, groups=8)
    params = randomize(init_shapes(jm, x, temb), 2)
    tm = port(ResnetBlock3D(cin, cout, 64, eps=1e-5, groups=8), params)
    with torch.no_grad():
        out = tm(_t(x), _t(temb))
    assert_close(out, jax.jit(jm.apply)(params, x, temb), TOL)


@pytest.mark.parametrize('cfg_expand', [False, True])
def test_transformer3d_parity(cfg_expand):
    """Per-frame GroupNorm, self/cross attention through the flash route
    (plain version on the CPU), GEGLU FFN; with cfg_expand the shared CFG
    half is doubled before the cross-attention."""
    rs = np.random.RandomState(3)
    b = 1 if cfg_expand else 2
    x = rs.randn(b, 2, 8, 8, 32).astype(np.float32)
    text = rs.randn(2, 77, 24).astype(np.float32)
    jm = JTransformer3D(heads=4, dim_head=8, cross_attention_dim=24,
                        num_layers=1, place='down', attn_index=0,
                        cross_layer_idx=0, norm_groups=8, attn_impl='flash',
                        cfg_expand=cfg_expand)
    params = randomize(init_shapes(jm, x, text), 4)
    tm = port(Transformer3DModel(32, 4, 8, 24, norm_groups=8), params)
    with torch.no_grad():
        out = tm(_t(x), _t(text), cfg_expand=cfg_expand)
    assert out.shape[0] == 2
    assert_close(out, jax.jit(jm.apply)(params, x, text), TOL)


@pytest.mark.parametrize('frames', [16, 24])
def test_motion_module_parity(frames):
    """Per-frame GroupNorm, PE (max_len 24), two frame-axis attentions
    through the temporal route, GEGLU FFN, random (non-zero) proj_out."""
    x = np.random.RandomState(frames).randn(2, frames, 4, 4, 32).astype(
        np.float32)
    jm = JMotion(heads=4, norm_groups=8)
    params = randomize(init_shapes(jm, x), 5)
    tm = port(VanillaTemporalModule(32, heads=4, norm_groups=8), params)
    with torch.no_grad():
        out = tm(_t(x))
    assert_close(out, jax.jit(jm.apply)(params, x), TOL)


def _unet_inputs(batch, seed):
    rs = np.random.RandomState(seed)
    x = rs.randn(batch, 2, 32, 32, 4).astype(np.float32)
    text = rs.randn(2, 77, 24).astype(np.float32)
    res = [rs.randn(2, 2, 32 // r, 32 // r, c).astype(np.float32) * 0.3
           for r, c in zip((1, 2, 4, 8), (16, 32, 32, 32))]
    return x, text, res


@pytest.mark.parametrize('dedup', [True, False])
def test_unet_parity(unet_pair, dedup):
    """Full U-Net at 256x256 (32x32 latents, so cfg_prefix_dedup applies),
    2 frames, CFG batch, adapter residuals on every level."""
    junet, params, tunet = unet_pair
    x, text, res = _unet_inputs(1 if dedup else 2, 6)
    apply = jax.jit(junet.apply, static_argnames=('cfg_prefix_dedup',))
    ref = apply(params, x, jnp.array([501]), text,
                adapter_residuals=[jnp.asarray(r) for r in res],
                cfg_prefix_dedup=dedup)
    with torch.no_grad():
        out = tunet(_t(x), torch.tensor([501]), _t(text),
                    [_t(r) for r in res], cfg_prefix_dedup=dedup)
    assert_close(out, ref, TOL)


def test_unet_dedup_equals_duplicated_batch(unet_pair):
    _, _, tunet = unet_pair
    x, text, res = _unet_inputs(1, 7)
    with torch.no_grad():
        a = tunet(_t(x), torch.tensor([21]), _t(text), [_t(r) for r in res],
                  cfg_prefix_dedup=True)
        b = tunet(_t(np.concatenate([x, x])), torch.tensor([21]), _t(text),
                  [_t(r) for r in res])
    assert_close(a, b.numpy(), 1e-5)


def test_clip_text_parity():
    cfg = JCLIPConfig(**CLIP_KW)
    ids = JHashTokenizer()(['a cat on the floor', 'worst quality'],
                           padding='max_length', max_length=77).input_ids
    extra = np.random.RandomState(8).randn(2, 24).astype(np.float32)
    ids[0, 3] = 49408 + 1                      # an ED-LoRA concept row
    jm = JCLIP(cfg=cfg)
    params = randomize(init_shapes(jm, jnp.zeros((1, 77), jnp.int32)), 9)
    tm = port(CLIPTextModel(CLIPTextConfig(**CLIP_KW)), params)
    with torch.no_grad():
        out = tm(torch.from_numpy(ids), _t(extra))
    assert_close(out, jax.jit(jm.apply)(params, ids, extra_token_embeds=extra),
                 TOL)


def test_adapter_parity():
    rs = np.random.RandomState(10)
    tracks = (rs.rand(3, 5, 2) * [128, 64]).astype(np.float32)
    tracks[1, 2] = -1.0                        # invisible in frame 1
    tracks[0, 0] = [127.9, 0.2]                # corners clipped at the edge
    emb = rs.randn(5, 12).astype(np.float32)
    mask = np.array([True, True, False, True, True])
    jm = JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))
    params = randomize(jax.eval_shape(
        lambda k, t, e: jm.init(k, t, (128, 64), e), jax.random.PRNGKey(0),
        tracks, emb), 11)
    tm = port(SparsePointAdapter(AdapterConfig(**ADAPTER_KW)), params)
    ref = jm.apply(params, tracks, (128, 64), emb, point_mask=mask)
    with torch.no_grad():
        out = tm(_t(tracks), (128, 64), _t(emb),
                 point_mask=torch.from_numpy(mask))
    assert len(out) == len(ref) == 4
    for o, r in zip(out, ref):
        assert_close(o, r, 1e-5)


@pytest.fixture(scope='module')
def vae_pair():
    jm = JVAE(**VAE_KW)
    params = randomize(init_shapes(jm, jnp.zeros((1, 32, 32, 3))), 12)
    return jm, params, port(AutoencoderKL(**VAE_KW), params)


def test_vae_decode_video_parity(vae_pair):
    jm, params, tm = vae_pair
    z = np.random.RandomState(13).randn(1, 2, 8, 8, 4).astype(np.float32)
    ref = jax.jit(lambda p, z: jm.apply(p, z, method=JVAE.decode_video))(
        params, z)
    with torch.no_grad():
        out = tm.decode_video(_t(z))
    assert out.shape == (1, 2, 64, 64, 3)
    assert_close(out, ref, TOL)


def test_vae_encode_video_parity(vae_pair):
    jm, params, tm = vae_pair
    video = np.random.RandomState(14).rand(1, 2, 64, 64, 3).astype(
        np.float32) * 2 - 1
    ref = jax.jit(lambda p, v: jm.apply(p, v, method=JVAE.encode_video))(
        params, video)
    with torch.no_grad():
        out = tm.encode_video(_t(video))
    assert out.shape == (1, 2, 8, 8, 4)
    assert_close(out, ref, TOL)


# ------------------------------------------------- schedule and tokenizer
@pytest.mark.parametrize('steps', [50, 3])
def test_ddim_parity(steps):
    js, ts_ = jsched.make_schedule(), tsched.make_schedule()
    np.testing.assert_array_equal(
        jsched.ddim_timesteps(1000, steps), tsched.ddim_timesteps(1000, steps))
    np.testing.assert_array_equal(
        jsched.ddim_inverse_timesteps(1000, steps),
        tsched.ddim_inverse_timesteps(1000, steps))
    np.testing.assert_allclose(ts_.alphas_cumprod.numpy(),
                               np.asarray(js.alphas_cumprod), rtol=1e-7)
    rs = np.random.RandomState(steps)
    x, eps = (rs.randn(1, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    for t in tsched.ddim_timesteps(1000, steps):
        ref = jsched.ddim_step(js, jnp.asarray(eps), int(t), jnp.asarray(x),
                               steps)
        out = tsched.ddim_step(ts_, _t(eps), int(t), _t(x), steps)
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                                   atol=1e-5)
        inv = tsched.ddim_inverse_step(ts_, _t(eps), int(t), out, steps)
        ref_inv = jsched.ddim_inverse_step(js, jnp.asarray(eps), int(t),
                                           ref, steps)
        np.testing.assert_allclose(inv.numpy(), np.asarray(ref_inv),
                                   rtol=1e-5, atol=1e-5)


def test_ddim_inverse_step_undoes_step():
    """The repo's invariant: inverse_step(step(x)) == x with the same eps."""
    sched = tsched.make_schedule()
    rs = np.random.RandomState(0)
    x, eps = (_t(rs.randn(1, 2, 4, 4, 4)) for _ in range(2))
    for t in tsched.ddim_timesteps(1000, 10):
        back = tsched.ddim_inverse_step(
            sched, eps, int(t), tsched.ddim_step(sched, eps, int(t), x, 10),
            10)
        np.testing.assert_allclose(back.numpy(), x.numpy(), rtol=1e-4,
                                   atol=1e-4)


def test_tokenizer_ids_match():
    jt, tt = JHashTokenizer(), HashTokenizer()
    jt.add_tokens(['<catA1>']), tt.add_tokens(['<catA1>'])
    text = ['a <catA1> with a Red bell, sitting!', '']
    np.testing.assert_array_equal(
        jt(text, max_length=77).input_ids, tt(text, max_length=77).input_ids)


def test_registries_are_separate():
    from videoswap_tpu.utils.registry import MODEL_REGISTRY as JREG
    from videoswap_torch.utils.registry import MODEL_REGISTRY as TREG
    assert TREG.get('AnimateDiffUNet3DModel') is AnimateDiffUNet3DModel
    assert JREG.get('AnimateDiffUNet3DModel') is JUNet
