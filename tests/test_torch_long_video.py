"""Parity of the port's long-video path with the JAX package, on the CPU in
fp32, at the tiny shapes of tests/test_long_video.py: `window_index`, the
sliding-window TemporalTransformerBlock and VanillaTemporalModule, the
tiny U-Net at 32 frames with an 8-frame window, and the swap CLI on the
long-video config of tests/test_cli_e2e.py::test_long_video_cli (8 frames,
a 4-frame position table, a 4-frame window at stride 2).

Each JAX model's parameters are seeded random values (only their shapes are
traced), converted with `jax_params_to_state_dict` and loaded strictly, as
in test_torch_models.py. Limits: a block 2e-5 (fp32, the windows' sum in
another order), a module and the U-Net 1e-4 of the output's scale (tens of
fp32 layers); the CLI's uint8 frames against the JAX pipeline's
`validation` on the same frames, points and weights: at most 1% of the
values may differ, none by more than 2 levels (test_torch_blend.py's bound:
reduction-order noise through CFG 7.5 flips a value next to a rounding
edge).
"""

import importlib.util
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from tests.test_torch_models import (assert_close, init_shapes, port,
                                     randomize)
from videoswap_tpu.models import AnimateDiffUNet3DModel as JUNet
from videoswap_tpu.models import UNet3DConfig as JUNetConfig
from videoswap_tpu.models.motion_module import \
    TemporalTransformerBlock as JBlock
from videoswap_tpu.models.motion_module import \
    VanillaTemporalModule as JMotion
from videoswap_tpu.models.motion_module import window_index as j_window_index
from videoswap_torch.models import AnimateDiffUNet3DModel, UNet3DConfig
from videoswap_torch.models.motion_module import (TemporalTransformerBlock,
                                                  VanillaTemporalModule,
                                                  use_fused, window_index)

ROOT = Path(__file__).resolve().parents[1]
DIM, HEADS = 16, 4


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())


# ------------------------------------------------------------ window_index
@pytest.mark.parametrize('f,w,s', [(32, 16, 8), (30, 16, 8), (32, 16, 6),
                                   (9, 6, 3), (12, 6, 6), (8, 8, 4),
                                   (17, 5, 1)])
def test_window_index_matches_jax(f, w, s):
    idx = window_index(f, w, s)
    np.testing.assert_array_equal(idx, j_window_index(f, w, s))
    assert idx.dtype == np.int32
    assert idx[-1, -1] == f - 1


@pytest.mark.parametrize('f,w,s', [(8, 9, 2), (8, 4, 5), (8, 4, 0)],
                         ids=['window_past_f', 'stride_past_window',
                              'stride_0'])
def test_window_index_refuses_as_jax(f, w, s):
    with pytest.raises(AssertionError) as ref:
        j_window_index(f, w, s)
    with pytest.raises(AssertionError) as ours:
        window_index(f, w, s)
    if str(ref.value):
        assert str(ours.value) == str(ref.value)


# ------------------------------------------------------------------ block
@pytest.fixture(scope='module')
def block_params():
    x = np.zeros((3, 12, DIM), np.float32)
    return {n: randomize(init_shapes(JBlock(dim=DIM, heads=HEADS,
                                            num_attention_blocks=n), x), 7)
            for n in (1, 2)}


def _blocks(params, window, stride, n=2):
    jm = JBlock(dim=DIM, heads=HEADS, max_len=24, num_attention_blocks=n,
                window=window, stride=stride)
    tm = port(TemporalTransformerBlock(DIM, HEADS, max_len=24,
                                       num_attention_blocks=n, window=window,
                                       stride=stride), params[n])
    return jm, tm


@pytest.mark.parametrize('f,w,s,n', [(12, 6, 6, 2), (9, 6, 3, 1),
                                     (9, 6, 3, 2), (10, 6, 3, 2),
                                     (13, 6, None, 2)],
                         ids=['non_overlapping', 'overlapping_one_sublayer',
                              'overlapping', 'flush_window',
                              'default_stride'])
def test_windowed_block_matches_jax(block_params, f, w, s, n):
    x = np.random.RandomState(f).randn(3, f, DIM).astype(np.float32)
    jm, tm = _blocks(block_params, w, s, n)
    with torch.no_grad():
        out = tm(_t(x))
    ref = jax.jit(jm.apply)(block_params[n], x)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=2e-5,
                               atol=2e-5)


def test_window_covering_the_clip_is_the_plain_block(block_params):
    """window >= f takes the plain full-attention path bit for bit."""
    x = _t(np.random.RandomState(1).randn(3, 8, DIM))
    _, windowed = _blocks(block_params, 8, 4)
    _, plain = _blocks(block_params, None, None)
    with torch.no_grad():
        assert torch.equal(windowed(x), plain(x))


def test_nonoverlapping_windows_equal_the_chunked_plain_block(block_params):
    """stride == window: the windowed block is the plain block run on each
    chunk (LN and the FFN are per frame), the identity chip_smoke.py holds
    on the card."""
    f, w = 12, 6
    x = _t(np.random.RandomState(2).randn(3, f, DIM))
    _, windowed = _blocks(block_params, w, w)
    _, plain = _blocks(block_params, None, None)
    with torch.no_grad():
        chunked = torch.cat([plain(x[:, s:s + w]) for s in range(0, f, w)],
                            dim=1)
        np.testing.assert_allclose(windowed(x).numpy(), chunked.numpy(),
                                   rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize('f,window', [(32, None), (32, 30)],
                         ids=['no_window', 'window_past_the_table'])
def test_too_long_raises_naming_long_video_cfg(block_params, f, window):
    _, tm = _blocks(block_params, window, None)
    with pytest.raises(ValueError, match='long_video_cfg'):
        tm(torch.zeros((2, f, DIM)))


# ------------------------------------------------------------ motion module
@pytest.mark.parametrize('frames,window,expected', [
    (32, 16, False), (16, 16, True), (16, None, True), (20, 16, False),
    (32, None, False)])
def test_fused_gate_sends_windowed_modules_layerwise(frames, window,
                                                     expected):
    """The JAX gate's window clause: a module that windows runs layer-wise
    on the card (a stand-in for a CUDA tensor: only `is_cuda` is read)."""
    on_card = types.SimpleNamespace(is_cuda=True)
    assert use_fused(on_card, 320, frames, 1, 24, window) is expected


@pytest.mark.parametrize('frames', [10, 4])
def test_windowed_motion_module_matches_jax(frames):
    """Per-frame GroupNorm, proj_in, the windowed block (window 4, stride
    3: a flush window at 10 frames; none at 4, where it is the plain
    module), proj_out, residual."""
    x = np.random.RandomState(frames).randn(2, frames, 4, 4, 32).astype(
        np.float32)
    jm = JMotion(heads=4, norm_groups=8, window=4, stride=3)
    params = randomize(init_shapes(JMotion(heads=4, norm_groups=8), x), 5)
    tm = port(VanillaTemporalModule(32, heads=4, norm_groups=8, window=4,
                                    stride=3), params)
    with torch.no_grad():
        out = tm(_t(x))
    assert_close(out, jax.jit(jm.apply)(params, x), 1e-4)


# ------------------------------------------------------------------ U-Net
TINY = dict(block_out_channels=(8, 8, 16, 16), attention_head_dim=2,
            cross_attention_dim=16, norm_num_groups=4, motion_heads=2)


def test_tiny_unet_at_32_frames_matches_jax():
    """tests/test_long_video.py's U-Net: 32 frames, an 8-frame window at
    stride 4, beyond the 24-frame table at every motion module."""
    cfg = dict(TINY, motion_window=8, motion_window_stride=4)
    junet = JUNet(cfg=JUNetConfig(**cfg))
    rs = np.random.RandomState(3)
    x = rs.randn(1, 32, 8, 8, 4).astype(np.float32)
    text = rs.randn(1, 77, 16).astype(np.float32)
    params = randomize(init_shapes(junet, x[:, :2], jnp.array([0]), text), 4)
    tunet = port(AnimateDiffUNet3DModel(UNet3DConfig(**cfg)), params)
    ref = jax.jit(junet.apply)(params, x, jnp.array([500]), text)
    with torch.no_grad():
        out = tunet(_t(x), torch.tensor([500]), _t(text))
    assert out.shape == (1, 32, 8, 8, 4)
    assert_close(out, ref, 1e-4)


def test_short_unet_state_dict_loads_into_the_long_video_unet():
    """The window adds no parameter: a 16-frame U-Net's weights load
    strictly into the long-video one."""
    short = AnimateDiffUNet3DModel(UNet3DConfig(**TINY))
    long = AnimateDiffUNet3DModel(UNet3DConfig(
        **TINY, motion_window=8, motion_window_stride=4))
    result = long.load_state_dict(short.state_dict(), strict=True)
    assert not result.missing_keys and not result.unexpected_keys
    assert sorted(short.state_dict()) == sorted(long.state_dict())


# -------------------------------------------------------------- swap CLI
# tests/test_cli_e2e.py's TINY_MODELS and test_long_video_cli's changes
CLI_UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
                cross_attention_dim=24, norm_num_groups=8, motion_heads=4,
                motion_max_len=4, motion_window=4, motion_window_stride=2)
CLI_MODELS = {
    'unet': {'unet_cfg': {k: list(v) if isinstance(v, tuple) else v
                          for k, v in CLI_UNET.items()}},
    'adapter': {'adapter_cfg': {'embedding_channels': 12,
                                'channels': [16, 32, 32, 32], 'mid_dim': 8}},
    'vae_cfg': {'block_out_channels': [8, 8, 16, 16], 'norm_groups': 8},
    'text_encoder_cfg': {'hidden_size': 24, 'num_layers': 1, 'num_heads': 4,
                         'intermediate_size': 32},
}
CLI_FRAMES, CLI_SIZE = 8, 64
CLI_CONFIG = """\
name: smoke_long
manual_seed: 7
mixed_precision: 'no'
datasets:
  type: SingleVideoPointDataset
  path: {data}/frames
  tap_path: {data}/TAP.pth
  prompt: a cat walking on a gradient floor
  num_frames: 8
  total_frames: 8
  video_transform:
    - {{ type: Resize, size: 64 }}
    - {{ type: ToTensor }}
    - {{ type: Normalize, mean: [ 0.5 ], std: [ 0.5 ] }}
  batch_size_per_gpu: 1
models:
  unet:
    motion_module_path: {tree}/mm_sd_v14.ckpt
    unet_cfg: {unet}
  adapter:
    adapter_cfg: {{ embedding_channels: 12, channels: [16, 32, 32, 32],
                   mid_dim: 8 }}
  vae_cfg: {{ block_out_channels: [8, 8, 16, 16], norm_groups: 8 }}
  text_encoder_cfg: {{ hidden_size: 24, num_layers: 1, num_heads: 4,
                      intermediate_size: 32 }}
path:
  pretrained_model_path: {tree}/pretrained
  pretrained_adapter_path: {tree}/adapter.pth
val:
  save_type: frame
  editing_config:
    use_invertion_latents: true
    use_blend: false
    num_inference_steps: 2
    guidance_scale: 7.5
    t2i_guidance_scale: 0.5
    t2i_start: 0.0
    t2i_end: 0.5
    editing_prompts:
      cat2dog:
        replace: cat -> dog
"""


def _chip_smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _jax_models_and_params():
    from videoswap_tpu.models import AdapterConfig as JAdapterConfig
    from videoswap_tpu.models import SparsePointAdapter as JAdapter
    from videoswap_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
    from videoswap_tpu.models.clip_text import CLIPTextModel as JCLIP
    from videoswap_tpu.models.vae import AutoencoderKL as JVAE
    key = jax.random.PRNGKey(0)
    opt = CLI_MODELS
    mods = {
        'unet': JUNet(cfg=JUNetConfig(**CLI_UNET)),
        'vae': JVAE(**{k: tuple(v) if isinstance(v, list) else v
                       for k, v in opt['vae_cfg'].items()}),
        'text_encoder': JCLIP(cfg=JCLIPConfig(**opt['text_encoder_cfg'])),
        'adapter': JAdapter(cfg=JAdapterConfig(
            embedding_channels=12, channels=(16, 32, 32, 32), mid_dim=8))}
    h8 = CLI_SIZE // 8
    shapes = {
        'unet': jax.eval_shape(mods['unet'].init, key,
                               jnp.zeros((1, 2, h8, h8, 4)), jnp.array([0]),
                               jnp.zeros((1, 77, 24))),
        'vae': jax.eval_shape(mods['vae'].init, key,
                              jnp.zeros((1, 32, 32, 3))),
        'text_encoder': jax.eval_shape(mods['text_encoder'].init, key,
                                       jnp.zeros((1, 77), jnp.int32)),
        'adapter': jax.eval_shape(
            lambda k, t, e: mods['adapter'].init(k, t, (CLI_SIZE, CLI_SIZE),
                                                 e),
            key, jnp.zeros((2, 3, 2)), jnp.zeros((3, 12)))}
    params = {name: randomize(s, 10 + i)
              for i, (name, s) in enumerate(shapes.items())}
    return mods, params


@pytest.fixture(scope='module')
def cli_runs(tmp_path_factory):
    """The port's swap CLI on the long-video config, on a tree written from
    the JAX parameters, and the JAX pipeline's `validation` with those
    parameters on the CLI dataset's frames and points."""
    from scripts.make_smoke_dataset import make
    from videoswap_tpu.pipelines import VideoSwapPipeline as JPipeline
    from videoswap_tpu.schedulers import make_schedule as j_make_schedule
    from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
    from videoswap_torch.builders import build_models
    from videoswap_torch.models.converters import jax_params_to_state_dict
    from videoswap_torch.test import test
    root = tmp_path_factory.mktemp('long_cli')
    data, tree = root / 'data', root / 'tree'
    make(str(data), frames=CLI_FRAMES, size=CLI_SIZE)
    mods, params = _jax_models_and_params()
    built = build_models({'models': CLI_MODELS}, device='cpu')
    for name in mods:
        built[name].load_state_dict(jax_params_to_state_dict(params[name]),
                                    strict=True)
    cs = _chip_smoke()
    cs.write_experiment_tree(built, tree, {}, dtype=torch.float32)
    # the hash tokenizer on both sides (no tokenizer directory)
    for f in (tree / 'pretrained' / 'tokenizer').iterdir():
        f.unlink()
    (tree / 'pretrained' / 'tokenizer').rmdir()
    unet = '{ ' + ', '.join(f'{k}: {list(v) if isinstance(v, tuple) else v}'
                            for k, v in CLI_UNET.items()) + ' }'
    yml = root / 'smoke_long.yml'
    yml.write_text(CLI_CONFIG.format(data=data, tree=tree, unet=unet))
    out = test(str(root), str(yml), device='cpu')
    ds = out['dataset']
    jpipe = JPipeline(tokenizer=JHashTokenizer(), sched=j_make_schedule(),
                      params=params, **mods)
    mp = pytest.MonkeyPatch()
    mp.setenv('VS_LOOP', 'python')
    from PIL import Image
    try:
        # the JAX package's dataset gives PIL frames
        ref = {k: np.stack([np.asarray(f) for f in v])
               for k, v in jpipe.validation(
                   [Image.fromarray(f) for f in ds.get_frames()],
                   ds.get_conditions(), ds.prompt,
                   out['opt']['val']['editing_config']).items()}
    finally:
        mp.undo()
    return out, ref


def test_long_video_cli_matches_jax(cli_runs):
    out, ref = cli_runs
    assert out['pipeline'].unet.cfg.motion_window == 4
    assert sorted(out['results']) == sorted(ref) == ['cat2dog']
    frames = out['results']['cat2dog']
    assert frames.shape == (CLI_FRAMES, CLI_SIZE, CLI_SIZE, 3)
    diff = np.abs(frames.astype(np.int32) - ref['cat2dog'].astype(np.int32))
    assert float((diff > 0).mean()) <= 1e-2, (diff > 0).mean()
    assert int(diff.max()) <= 2, diff.max()
    files = list((Path(out['opt']['path']['visualization']) / 'cat2dog')
                 .rglob('*.png'))
    assert len(files) == CLI_FRAMES
