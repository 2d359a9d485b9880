"""Config and checkpoint loading of the port (videoswap_torch/builders.py,
models/converters.py) against the JAX package's:

- the production key sets of tests/fixtures/sd15_keys.py (the SD-1.5
  U-Net with AnimateDiff's motion modules, the VAE in both attention
  layouts) and transformers' CLIP-L/14 text encoder against the port's
  SD-1.5-width models built on the `meta` device (no memory): 0 missing,
  0 unused, every shape equal;
- `unet_config_from_opt` and `adapter_config_from_opt` equal to the JAX
  package's on every shipped swap config, and with a pretrained
  directory's unet/config.json;
- at tiny widths, an experiment tree written by the test under the
  published file and key names (chip_smoke.write_experiment_tree), loaded by
  both packages: every weight the same, and the same U-Net output within
  1e-4 of its scale (fp32 on the CPU); a named file that is missing
  raises, a missing pretrained directory leaves the weights random.
"""

import glob
import importlib.util
import json
import os
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fixtures.sd15_keys import (mm_sd_v14_state_shapes,
                                sd15_unet_state_shapes, sd_vae_state_shapes)
from videoswap_tpu import builders as jbuilders
from videoswap_tpu.models import AnimateDiffUNet3DModel as JUNet
from videoswap_tpu.models import SparsePointAdapter as JAdapter
from videoswap_tpu.models import UNet3DConfig as JUNetConfig
from videoswap_tpu.models import AdapterConfig as JAdapterConfig
from videoswap_tpu.models import converters as jconv
from videoswap_tpu.models.clip_text import CLIPTextConfig as JCLIPConfig
from videoswap_tpu.models.clip_text import CLIPTextModel as JCLIP
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_torch import builders
from videoswap_torch.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                    SparsePointAdapter, UNet3DConfig,
                                    converters)
from videoswap_torch.models.clip_text import CLIPTextConfig, CLIPTextModel
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.utils.config import load_config

ROOT = Path(__file__).resolve().parents[1]
SWAP_CONFIGS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    str(ROOT / 'options' / '*_videoswap' / '**' / '*.yml'), recursive=True))


def _meta(shapes: dict) -> dict:
    return {k: torch.empty(s, device='meta') for k, s in shapes.items()}


@pytest.fixture(scope='module')
def sd15_models():
    with torch.device('meta'):
        return {'unet': AnimateDiffUNet3DModel(UNet3DConfig()),
                'vae': AutoencoderKL(),
                'text_encoder': CLIPTextModel(CLIPTextConfig())}


def _assert_complete(module, sd, key_map=None):
    missing, unused = converters.load_normalized(module, sd, key_map)
    assert not missing, missing[:10]
    assert not unused, unused[:10]


def test_unet_and_mm_sd_v14_keys_load_complete(sd15_models):
    """SD-1.5's 2-D U-Net with mm_sd_v14 merged in (the sinusoidal
    `pos_encoder.pe` tables are not parameters: ignored); the 2-D weights
    alone leave exactly the motion modules missing."""
    unet = sd15_models['unet']
    sd2d = _meta(sd15_unet_state_shapes())
    _assert_complete(unet, converters.merge_motion_module(
        sd2d, _meta(mm_sd_v14_state_shapes())))
    missing, unused = converters.load_normalized(unet, sd2d)
    assert not unused and missing
    assert all('.motion_modules.' in k for k in missing)


@pytest.mark.parametrize('legacy', [False, True])
def test_vae_keys_load_complete_in_both_layouts(sd15_models, legacy):
    _assert_complete(sd15_models['vae'], converters.normalize_vae_keys(
        _meta(sd_vae_state_shapes(legacy_attention=legacy))))


def test_clip_text_keys_load_complete(sd15_models):
    """transformers' own key list at the SD-1.5 text encoder's config, with
    the position-id buffer old exports carry."""
    from transformers import CLIPTextConfig as HFConfig
    from transformers import CLIPTextModel as HFModel
    with torch.device('meta'):
        hf = HFModel(HFConfig(vocab_size=49408, hidden_size=768,
                              intermediate_size=3072, num_hidden_layers=12,
                              num_attention_heads=12,
                              max_position_embeddings=77,
                              hidden_act='quick_gelu'))
    sd = dict(hf.state_dict())
    sd['text_model.embeddings.position_ids'] = torch.empty(
        (1, 77), device='meta')
    _assert_complete(sd15_models['text_encoder'], sd,
                     converters.clip_key_unmap)


def test_a_shape_that_differs_raises(sd15_models):
    sd = _meta(sd15_unet_state_shapes())
    sd['conv_in.weight'] = torch.empty((320, 8, 3, 3), device='meta')
    with pytest.raises(ValueError, match='conv_in.weight'):
        converters.load_normalized(sd15_models['unet'], sd)


def _same_fields(port_cfg, jax_cfg):
    ref = {k: v for k, v in jax_cfg._asdict().items() if k != 'sample_size'}
    assert port_cfg._asdict() == ref


@pytest.mark.parametrize('part', range(4))
def test_configs_from_opt_equal_jax(part):
    """Every shipped swap config (a quarter a case), as given (no
    pretrained directory there)."""
    for path in SWAP_CONFIGS[part::4]:
        models = load_config(str(ROOT / path)).get('models', {})
        _same_fields(
            builders.unet_config_from_opt(models.get('unet', {}), str(ROOT),
                                          None),
            jbuilders.unet_config_from_opt(models.get('unet', {}), str(ROOT),
                                           None))
        _same_fields(
            builders.adapter_config_from_opt(models.get('adapter', {}),
                                             str(ROOT)),
            jbuilders.adapter_config_from_opt(models.get('adapter', {}),
                                              str(ROOT)))


def test_unet_config_reads_the_pretrained_config_json(tmp_path):
    (tmp_path / 'unet').mkdir()
    (tmp_path / 'unet' / 'config.json').write_text(json.dumps({
        'block_out_channels': [64, 128, 256, 256], 'layers_per_block': 1,
        'attention_head_dim': 4, 'cross_attention_dim': 512,
        'norm_num_groups': 16, 'sample_size': 32}))
    opt = {'inference_config_path': 'options/model_cfg/inference.yml',
           'unet_cfg': {'motion_heads': 2}}
    cfg = builders.unet_config_from_opt(opt, str(ROOT), str(tmp_path))
    _same_fields(cfg, jbuilders.unet_config_from_opt(opt, str(ROOT),
                                                     str(tmp_path)))
    assert cfg.block_out_channels == (64, 128, 256, 256)
    assert cfg.motion_heads == 2


def test_schedule_from_the_inference_config():
    sched = builders.schedule_from_opt(
        {'inference_config_path': 'options/model_cfg/inference.yml'},
        str(ROOT))
    ref = jbuilders.make_schedule(**load_config(str(
        ROOT / 'options/model_cfg/inference.yml'))['noise_scheduler_kwargs'])
    np.testing.assert_array_equal(sched.alphas_cumprod.numpy(),
                                  np.asarray(ref.alphas_cumprod))


# ------------------------------------------------------- a tiny written tree
UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=24, norm_num_groups=8, motion_heads=4)
CLIP_KW = dict(hidden_size=24, num_layers=1, num_heads=4,
               intermediate_size=32)
ADAPTER_KW = dict(embedding_channels=12, channels=(16, 32, 32, 32),
                  mid_dim=8)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)


def _opt(tree):
    return {'models': {
        'unet': {'inference_config_path': 'options/model_cfg/inference.yml',
                 'motion_module_path': str(tree / 'mm_sd_v14.ckpt'),
                 'unet_cfg': {k: list(v) if isinstance(v, tuple) else v
                              for k, v in UNET_KW.items()}},
        'adapter': {'adapter_cfg': {k: list(v) if isinstance(v, tuple)
                                    else v for k, v in ADAPTER_KW.items()}},
        'vae_cfg': {k: list(v) if isinstance(v, tuple) else v
                    for k, v in VAE_KW.items()},
        'text_encoder_cfg': dict(CLIP_KW)},
        'path': {'pretrained_model_path': str(tree / 'pretrained'),
                 'pretrained_adapter_path': str(tree / 'adapter.pth')}}


@pytest.fixture(scope='module')
def tree(tmp_path_factory):
    """(tree, the written tensors, the port's models loaded from it, their
    load report)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)      # beside the other test workers
    try:
        spec = importlib.util.spec_from_file_location(
            'chip_smoke', ROOT / 'chip_smoke.py')
        cs = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(cs)
        root = tmp_path_factory.mktemp('tree')
        opt = _opt(root)
        models = {k: v for k, v in opt['models'].items()}
        models['unet'] = {k: v for k, v in models['unet'].items()
                          if k != 'motion_module_path'}
        written = cs.write_experiment_tree(
            builders.build_models({'models': models}, str(ROOT),
                                  device='cpu', seed=7), root, {})
        report = {}
        loaded = builders.build_models(opt, str(ROOT), device='cpu', seed=8,
                                       load_report=report)
        yield root, written, loaded, report, cs
    finally:
        torch.set_num_threads(n)


def test_port_loads_every_tensor_as_written(tree):
    _, written, loaded, report, cs = tree
    errs = cs.load_errors(loaded, written, report)
    assert sorted(errs) == ['adapter', 'text_encoder', 'unet', 'vae']
    assert not cs.load_fails(errs), errs


def _jax_params(module, *args):
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)
    return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                        shapes)['params']


@pytest.fixture(scope='module')
def jax_loaded(tree):
    """The tree through the JAX package's readers and converters."""
    root, _, _, _, _ = tree
    pre = root / 'pretrained'
    junet = JUNet(cfg=JUNetConfig(**UNET_KW), attn_impl='flash')
    sd = jconv.load_torch_file(str(pre / 'unet/diffusion_pytorch_model.bin'))
    sd.update(jconv.load_torch_file(str(root / 'mm_sd_v14.ckpt')))
    unet, missing, unused = jconv.convert_unet(sd, _jax_params(
        junet, jnp.zeros((1, 2, 8, 8, 4)), jnp.array([0]),
        jnp.zeros((1, 77, 24))))
    assert not missing and not unused
    jad = JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))
    return junet, {
        'unet': unet,
        'vae': jconv.convert_vae(jconv.load_torch_file(str(
            pre / 'vae/diffusion_pytorch_model.bin')), _jax_params(
                JVAE(**VAE_KW), jnp.zeros((1, 32, 32, 3)))),
        'text_encoder': jconv.convert_text_encoder(
            jconv.load_torch_file(str(pre / 'text_encoder/pytorch_model.bin')),
            _jax_params(JCLIP(cfg=JCLIPConfig(**CLIP_KW)),
                        jnp.zeros((1, 77), jnp.int32))),
        'adapter': jbuilders.load_adapter_checkpoint(
            str(root / 'adapter.pth'), jax.tree.map(
                lambda s: jnp.zeros(s.shape, s.dtype), jax.eval_shape(
                    lambda k, t, e: jad.init(k, t, (64, 64), e),
                    jax.random.PRNGKey(0), jnp.zeros((2, 3, 2)),
                    jnp.zeros((3, 12))))['params']),
    }


@pytest.mark.parametrize('name', ['unet', 'vae', 'text_encoder', 'adapter'])
def test_both_packages_load_the_same_weights(tree, jax_loaded, name):
    _, _, loaded, _, _ = tree
    ref = jax_params_to_state_dict(jax_loaded[1][name])
    own = loaded[name].state_dict()
    assert sorted(ref) == sorted(own)
    for k, v in ref.items():
        np.testing.assert_array_equal(own[k].numpy(), v.numpy(), err_msg=k)


def test_loaded_unet_output_equals_jax(tree, jax_loaded):
    _, _, loaded, _, _ = tree
    junet, params = jax_loaded
    rs = np.random.RandomState(4)
    x = rs.randn(2, 2, 8, 8, 4).astype(np.float32)
    text = rs.randn(2, 77, 24).astype(np.float32)
    ref = np.asarray(jax.jit(junet.apply)({'params': params['unet']},
                                          jnp.asarray(x), jnp.array([501]),
                                          jnp.asarray(text)))
    with torch.no_grad():
        out = loaded['unet'](torch.from_numpy(x), torch.tensor([501]),
                             torch.from_numpy(text)).numpy()
    assert float(np.abs(out - ref).max()) <= 1e-4 * max(
        1.0, float(np.abs(ref).max()))


def test_named_files_that_are_missing_raise(tree, tmp_path):
    root = tree[0]
    opt = _opt(root)
    opt['models']['unet']['motion_module_path'] = str(tmp_path / 'no.ckpt')
    with pytest.raises(FileNotFoundError, match='motion_module_path'):
        builders.build_models(opt, str(ROOT), device='cpu')
    opt = _opt(root)
    opt['path']['pretrained_adapter_path'] = str(tmp_path / 'no.pth')
    with pytest.raises(FileNotFoundError, match='pretrained_adapter_path'):
        builders.build_models(opt, str(ROOT), device='cpu')


def test_a_missing_pretrained_directory_leaves_random_weights(tmp_path):
    opt = {'models': _opt(tmp_path)['models'],
           'path': {'pretrained_model_path': str(tmp_path / 'none')}}
    del opt['models']['unet']['motion_module_path']
    report = {}
    built = builders.build_models(opt, str(ROOT), device='cpu', seed=3,
                                  load_report=report)
    again = builders.build_models({'models': opt['models']}, str(ROOT),
                                  device='cpu', seed=3)
    assert report == {}
    assert type(built['tokenizer']).__name__ == 'HashTokenizer'
    for a, b in zip(built['unet'].parameters(), again['unet'].parameters()):
        assert torch.equal(a, b)
