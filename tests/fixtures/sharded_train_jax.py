"""The JAX package's single-device references of
tests/test_torch_sharded_train.py, and the inputs both sides share.

The `*_inputs` / `*_params` functions make the configs' numpy weights
(shapes by `jax.eval_shape`, values from numpy seeds), batches and the JAX
draws, the same in every process; the `*_reference` functions run the JAX
package's step on them. The test module calls the first in its own process
and runs the second in processes of its own, side by side, while the
port's world runs.

Configs: the adapter step at `__graft_entry__.dryrun_multichip`'s models
and trainer config (4 frames, 64x64, 3 points) at B = 2 (cached VAE
moments) and B = 1 (pixels); ED-LoRA at tests/test_edlora_shard.py's (two
steps, rank 2, clipped at 1); the atlas at tests/test_atlas.py's
`atlas_setup` (one main step, one inverse step).
"""

from __future__ import annotations

import functools
import math

import numpy as np

import jax
import jax.numpy as jnp

# ---------------------------------------------------------------- adapter
ADAPTER_UNET = dict(block_out_channels=(16, 32, 32, 32),
                    attention_head_dim=4, cross_attention_dim=24,
                    norm_num_groups=8, motion_heads=4)
ADAPTER_VAE = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)
ADAPTER_CLIP = dict(vocab_size=1000, hidden_size=24, num_layers=1,
                    num_heads=4, intermediate_size=32)
ADAPTER_AD = dict(embedding_channels=12, channels=(16, 32, 32, 32),
                  mid_dim=8)
ADAPTER_TUNE = {'drop_rate': 0.2, 'min_timestep': 0.5, 'loss_type': 'global'}
ADAPTER_LR = 1e-3
F, SIZE, P = 4, 64, 3
ADAPTER_NAMES = ('unet', 'vae', 'text_encoder', 'adapter')


def random_params(shapes, seed: int) -> dict:
    """numpy fp32 weights on flax's scales for a params shape tree."""
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


def adapter_modules():
    from videoswap_tpu.models import (AdapterConfig, AnimateDiffUNet3DModel,
                                      SparsePointAdapter, UNet3DConfig)
    from videoswap_tpu.models.clip_text import CLIPTextConfig, CLIPTextModel
    from videoswap_tpu.models.vae import AutoencoderKL
    return {'unet': AnimateDiffUNet3DModel(cfg=UNet3DConfig(**ADAPTER_UNET)),
            'vae': AutoencoderKL(**ADAPTER_VAE),
            'text_encoder': CLIPTextModel(cfg=CLIPTextConfig(**ADAPTER_CLIP)),
            'adapter': SparsePointAdapter(cfg=AdapterConfig(**ADAPTER_AD))}


@functools.lru_cache(maxsize=None)
def adapter_params() -> dict:
    mods = adapter_modules()
    k = jax.random.PRNGKey(0)
    h8 = SIZE // 8
    shapes = {
        'unet': jax.eval_shape(mods['unet'].init, k,
                               jnp.zeros((1, F, h8, h8, 4)), jnp.array([0]),
                               jnp.zeros((1, 77, 24))),
        'vae': jax.eval_shape(mods['vae'].init, k,
                              jnp.zeros((1, SIZE, SIZE, 3))),
        'text_encoder': jax.eval_shape(mods['text_encoder'].init, k,
                                       jnp.zeros((1, 77), jnp.int32)),
        'adapter': jax.eval_shape(
            lambda k_, t, e: mods['adapter'].init(k_, t, (SIZE, SIZE), e),
            k, jnp.zeros((F, P, 2)), jnp.zeros((P, 12)))}
    return {n: random_params(shapes[n], i)
            for i, n in enumerate(ADAPTER_NAMES)}


def adapter_batch(b: int) -> dict:
    """dryrun_multichip's batch at B = b: pixels at B = 1, the VAE's
    moments (what the train CLI caches) at B = 2."""
    rs = np.random.RandomState(b)
    out = {'input_ids': rs.randint(0, 1000, (b, 77)).astype(np.int32),
           'pred_tracks': (rs.rand(F, P, 2) * 48).astype(np.float32),
           'point_embedding': rs.randn(P, 12).astype(np.float32)}
    if b == 1:
        out['pixels'] = (rs.rand(b, F, SIZE, SIZE, 3) * 2 - 1).astype(
            np.float32)
    else:
        h8 = SIZE // 8
        out['latent_mean'] = rs.randn(b, F, h8, h8, 4).astype(np.float32)
        out['latent_logvar'] = (rs.randn(b, F, h8, h8, 4) * 0.3
                                - 2.0).astype(np.float32)
    return out


def adapter_draws(b: int, seed: int = 1) -> dict:
    """The draws of the JAX trainer's build_loss_fn at key `seed`, made as
    it makes them."""
    from videoswap_tpu.pipelines.trainer import sample_biased_timestep
    k_vae, k_t, k_noise, k_drop = jax.random.split(jax.random.PRNGKey(seed),
                                                   4)
    shape = (b, F, SIZE // 8, SIZE // 8, 4)
    return {
        'vae_eps': np.array(jax.random.normal(
            k_vae, (b * F,) + shape[2:])).reshape(shape),
        't': np.array(sample_biased_timestep(
            k_t, ADAPTER_TUNE['min_timestep'], 1000)),
        'noise': np.array(jax.random.normal(k_noise, shape)),
        'keep': np.array(jax.random.uniform(k_drop, (P,))
                         > ADAPTER_TUNE['drop_rate'])}


def adapter_reference(b: int, seed: int = 1) -> dict:
    """The JAX trainer's single-device loss and adapter gradient (flax
    tree) for `adapter_batch(b)` at key `seed`, on `adapter_params()`.
    remat and the Pallas flash route off: the same gradient, a shorter
    trace."""
    from videoswap_tpu.pipelines import VideoSwapTrainer
    from videoswap_tpu.schedulers import make_schedule
    from videoswap_tpu.utils.tokenizer import HashTokenizer
    params = adapter_params()
    mods = adapter_modules()
    frozen = {n: jax.tree.map(jnp.asarray, params[n])
              for n in ('unet', 'vae', 'text_encoder')}
    trainer = VideoSwapTrainer(
        tokenizer=HashTokenizer(), sched=make_schedule(), params=frozen,
        tune_cfg=dict(ADAPTER_TUNE, remat=False, attn_impl='xla'),
        optimizer_cfg={'lr': ADAPTER_LR}, **mods)
    batch = {k: jnp.asarray(v) for k, v in adapter_batch(b).items()}
    loss, grads = jax.jit(jax.value_and_grad(trainer.build_loss_fn()))(
        jax.tree.map(jnp.asarray, params['adapter']['params']), frozen,
        batch, jax.random.PRNGKey(seed))
    return {'loss': float(loss), 'grads': jax.device_get(grads)}


# ---------------------------------------------------------------- ED-LoRA
EDLORA_HID = 24
EDLORA_UNET = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
                   cross_attention_dim=EDLORA_HID, norm_num_groups=8,
                   use_motion_module=False)
EDLORA_CLIP = dict(hidden_size=EDLORA_HID, num_layers=1, num_heads=4,
                   intermediate_size=32)
EDLORA_VAE = ADAPTER_VAE
EDLORA_OPT = {'emb_lr': 1e-2, 'lora_lr': 1e-3}
EDLORA_NAMES = ('unet', 'vae', 'text_encoder')


def edlora_modules():
    from videoswap_tpu.models import AnimateDiffUNet3DModel, UNet3DConfig
    from videoswap_tpu.models.clip_text import CLIPTextConfig, CLIPTextModel
    from videoswap_tpu.models.vae import AutoencoderKL
    return {'unet': AnimateDiffUNet3DModel(cfg=UNet3DConfig(**EDLORA_UNET)),
            'vae': AutoencoderKL(**EDLORA_VAE),
            'text_encoder': CLIPTextModel(cfg=CLIPTextConfig(**EDLORA_CLIP))}


@functools.lru_cache(maxsize=None)
def edlora_inputs() -> dict:
    """tests/test_edlora_shard.py's setup with numpy weights: the params,
    the concept's warm start, the batch, the LoRA init and the two steps'
    keys and draws."""
    from videoswap_tpu.edlora_train import (init_concept_embedding,
                                            register_concepts,
                                            tokenize_layer_prompts)
    from videoswap_tpu.pipelines.trainer import sample_biased_timestep
    from videoswap_tpu.utils.tokenizer import HashTokenizer
    mods = edlora_modules()
    k = jax.random.PRNGKey(0)
    shapes = {
        'unet': jax.eval_shape(mods['unet'].init, k,
                               jnp.zeros((1, 1, 8, 8, 4)), jnp.array([0]),
                               jnp.zeros((1, 77, EDLORA_HID))),
        'vae': jax.eval_shape(mods['vae'].init, k,
                              jnp.zeros((1, 64, 64, 3))),
        'text_encoder': jax.eval_shape(mods['text_encoder'].init, k,
                                       jnp.zeros((1, 77), jnp.int32))}
    params = {n: random_params(shapes[n], 10 + i)
              for i, n in enumerate(EDLORA_NAMES)}
    tokenizer = HashTokenizer()
    cfg = register_concepts(tokenizer, ['catA1'])
    emb0 = np.asarray(init_concept_embedding(
        jax.tree.map(jnp.asarray, params['text_encoder']['params']),
        tokenizer, 'cat'))
    ids = tokenize_layer_prompts(tokenizer, 'a photo of a catA1', cfg)
    pixels = np.asarray(jax.random.uniform(
        jax.random.PRNGKey(5), (1, 1, 64, 64, 3), minval=-1, maxval=1))
    trainer = edlora_trainer(params, mods)
    init = jax.device_get(trainer.init_train_params(
        jax.random.PRNGKey(1), {'catA1': jnp.asarray(emb0)}, rank=2))
    rng, keys = jax.random.PRNGKey(7), []
    for _ in range(2):
        rng, key = jax.random.split(rng)
        keys.append(key)
    draws = []
    for key in keys:
        k_vae, k_t, k_noise = jax.random.split(key, 3)
        shape = (1, 1, 8, 8, 4)
        draws.append({
            'vae_eps': np.array(jax.random.normal(
                k_vae, (1, 8, 8, 4))).reshape(shape),
            't': np.array(sample_biased_timestep(k_t, 0.0, 1000)),
            'noise': np.array(jax.random.normal(k_noise, shape))})
    return {'params': params, 'emb0': emb0,
            'batch': {'input_ids': np.asarray(ids, np.int32),
                      'pixels': pixels},
            'init': init, 'keys': [np.asarray(k) for k in keys],
            'draws': draws}


def edlora_trainer(params, mods=None):
    from videoswap_tpu.edlora_train import EDLoRATrainer, lora_sites
    from videoswap_tpu.schedulers import make_schedule
    mods = mods or edlora_modules()
    jparams = {n: jax.tree.map(jnp.asarray, params[n]) for n in EDLORA_NAMES}
    return EDLoRATrainer(
        unet=mods['unet'], text_encoder=mods['text_encoder'],
        vae=mods['vae'], sched=make_schedule(), params=jparams,
        unet_sites=lora_sites(jparams['unet']['params'], 'unet', 'attn'),
        text_sites=lora_sites(jparams['text_encoder']['params'],
                              'text_encoder', 'attn'),
        alpha=1.0, tune_cfg={'attn_impl': 'xla'},
        optimizer_cfg=EDLORA_OPT, max_grad_norm=1.0, return_grads=True)


def edlora_reference() -> dict:
    """The JAX test's two single-device steps on `edlora_inputs()`:
    losses, the last step's gradients and the train params after, as
    jax.tree.leaves."""
    inputs = edlora_inputs()
    trainer = edlora_trainer(inputs['params'])
    tp = jax.tree.map(jnp.asarray, inputs['init'])
    st = trainer.init_state(tp)
    batch = {k: jnp.asarray(v) for k, v in inputs['batch'].items()}
    losses, grads = [], None
    for key in inputs['keys']:
        tp, st, loss, grads = trainer.step(tp, st, batch, jnp.asarray(key))
        losses.append(float(loss))
    return {'losses': losses,
            'grads': [np.asarray(a) for a in
                      jax.tree.leaves(jax.device_get(grads))],
            'after': [np.asarray(a) for a in
                      jax.tree.leaves(jax.device_get(tp))]}


# ------------------------------------------------------------------ atlas

def atlas_inputs() -> dict:
    """tests/test_atlas.py's atlas_setup: the nets' configs and params
    (trainer.init_params at key 0), the clip, the train options and the
    draws of one main step and one inverse step (the keys of
    test_atlas_sharded_step_matches_single_device)."""
    from tests.test_atlas import TRAIN_OPT, _synthetic_data
    trainer = atlas_trainer()
    params = jax.device_get(trainer.init_params(jax.random.PRNGKey(0)))
    k1, k2 = jax.random.split(jax.random.PRNGKey(9))
    b = TRAIN_OPT['sample_batch_size']

    def draws(key):
        kx, ky, kf = jax.random.split(key, 3)
        return tuple(np.asarray(jax.random.randint(k, (b,), 0, hi))
                     for k, hi in ((kx, trainer.res_x), (ky, trainer.res_y),
                                   (kf, trainer.num_frames)))
    return {'params': params, 'data': _synthetic_data(),
            'train_opt': TRAIN_OPT, 'keys': [np.asarray(k1),
                                              np.asarray(k2)],
            'draws': [draws(k1), draws(k2)]}


ATLAS_NETS = {
    'FG_UV_Mapping': dict(input_dim=3, output_dim=2, hidden_dim=32,
                          mlp_layers=3),
    'BG_UV_Mapping': dict(input_dim=3, output_dim=2, hidden_dim=32,
                          mlp_layers=3),
    'F_Alpha': dict(input_dim=3, output_dim=1, hidden_dim=32, mlp_layers=3,
                    pe_type='encoding', pe_dim=2),
    'F_Atlas': dict(input_dim=2, output_dim=3, hidden_dim=32, mlp_layers=3,
                    pe_type='hash_encoding', hash_levels=4,
                    log2_hashmap_size=10),
    'FG_UV_Mapping_Inverse': dict(input_dim=3, output_dim=3, hidden_dim=32,
                                  mlp_layers=3),
}


def atlas_trainer():
    from tests.test_atlas import TRAIN_OPT, _synthetic_data
    from videoswap_tpu.atlas import IMLP
    from videoswap_tpu.atlas.trainer import AtlasTrainer
    data = {k: jnp.asarray(v) for k, v in _synthetic_data().items()}
    return AtlasTrainer(nets={n: IMLP(**kw) for n, kw in ATLAS_NETS.items()},
                        data=data, train_opt=TRAIN_OPT, larger_dim=16,
                        num_frames=4)


def atlas_reference(inputs: dict) -> dict:
    """test_atlas_sharded_step_matches_single_device's single-device
    steps: the loss terms, the inverse loss and the params after."""
    trainer = atlas_trainer()
    params = jax.tree.map(jnp.asarray, inputs['params'])
    opt = trainer.init_opt_state(params)
    p, opt, ld = trainer.step(params, opt, jnp.asarray(inputs['keys'][0]),
                              1)
    p, opt, inv = trainer.inverse_step(p, opt, jnp.asarray(inputs['keys'][1]))
    return {'losses': {k: float(v) for k, v in ld.items()},
            'inverse': float(inv), 'params': jax.device_get(p)}
