"""Parity of the port's adapter-training path with the JAX package at a tiny
config (the pipeline tests' model sizes, 64x64, 2 frames, 3 points):
`add_noise`/`get_velocity`, the v-prediction DDIM step, the adapter's loss
mask, the VAE moments path, the timestep sampler, and
`VideoSwapTrainer.loss_fn` with its adapter gradient against
`jax.value_and_grad(trainer.build_loss_fn())` on the same draws. Then two
checks of the port alone: gradient checkpointing leaves the gradient
unchanged, and `step` with a fixed draw lowers the loss. fp32 on the CPU,
apart from bf16 models training the adapter with fp32 weights.
"""

import math
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu import schedulers as jsched
from videoswap_tpu.models import (AdapterConfig as JAdapterConfig,
                                  AnimateDiffUNet3DModel as JUNet,
                                  SparsePointAdapter as JAdapter,
                                  UNet3DConfig as JUNetConfig)
from videoswap_tpu.models.adapter import local_loss_mask as j_local_loss_mask
from videoswap_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_tpu.pipelines import VideoSwapTrainer as JTrainer
from videoswap_tpu.pipelines.trainer import \
    sample_biased_timestep as j_sample_biased_timestep
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch import schedulers as tsched
from videoswap_torch.builders import build_models
from videoswap_torch.models.adapter import local_loss_mask
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.models.vae import AutoencoderKL
from videoswap_torch.ops import flash_attention as tfa
from videoswap_torch.pipelines import VideoSwapTrainer, sample_biased_timestep
from videoswap_torch.utils.init import init_weights

torch.backends.cuda.matmul.allow_tf32 = False


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
CLIP_KW = dict(vocab_size=49408, hidden_size=24, num_layers=1, num_heads=4,
               intermediate_size=32)
ADAPTER_KW = dict(embedding_channels=12, channels=(16, 32, 32, 32),
                  mid_dim=8)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)
MODELS_OPT = {'unet': {'unet_cfg': UNET_KW}, 'vae_cfg': VAE_KW,
              'text_encoder_cfg': CLIP_KW,
              'adapter': {'adapter_cfg': ADAPTER_KW}}
F, SIZE, P = 2, 64, 3
TUNE = {'drop_rate': 0.2, 'min_timestep': 0.5, 'loss_type': 'local'}


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _batch(seed=0):
    rs = np.random.RandomState(seed)
    h8 = SIZE // 8
    tracks = (rs.rand(F, P, 2) * SIZE).astype(np.float32)
    tracks[1, 2] = -1.0                               # invisible point
    return {
        'latent_mean': rs.randn(1, F, h8, h8, 4).astype(np.float32),
        'latent_logvar': (rs.randn(1, F, h8, h8, 4) * 0.3 - 2.0).astype(
            np.float32),
        'input_ids': JHashTokenizer()(['a cat walking'], padding='max_length',
                                      max_length=77).input_ids,
        'pred_tracks': tracks,
        'point_embedding': rs.randn(P, 12).astype(np.float32),
    }


# ------------------------------------------------------------- schedule
@pytest.mark.parametrize('pred', ['epsilon', 'v_prediction'])
def test_add_noise_velocity_and_step_match_jax(pred):
    js = jsched.make_schedule(prediction_type=pred)
    ts = tsched.make_schedule(prediction_type=pred)
    rs = np.random.RandomState(1)
    x, eps = (rs.randn(2, 2, 4, 4, 4).astype(np.float32) for _ in range(2))
    t = np.array([999, 37])
    for jf, tf in ((jsched.add_noise, tsched.add_noise),
                   (jsched.get_velocity, tsched.get_velocity)):
        ref = jf(js, jnp.asarray(x), jnp.asarray(eps), jnp.asarray(t))
        out = tf(ts, _t(x), _t(eps), torch.from_numpy(t))
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-6)
    ref = jsched.ddim_step(js, jnp.asarray(eps), 501, jnp.asarray(x), 20)
    out = tsched.ddim_step(ts, _t(eps), 501, _t(x), 20)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_sample_biased_timestep_range_matches_jax():
    """Same ranges as the JAX sampler: [min_t T, T) with largeT_prob 1,
    [0, min_t T) with 0, both halves with 0.5."""
    n = 200
    for prob, lo, hi in ((1.0, 300, 1000), (0.0, 0, 300), (0.5, 0, 1000)):
        g = torch.Generator().manual_seed(0)
        ours = np.array([int(sample_biased_timestep(g, 0.3, 1000, prob))
                         for _ in range(n)])
        keys = jax.random.split(jax.random.PRNGKey(0), n)
        ref = np.asarray(jax.vmap(lambda k: j_sample_biased_timestep(
            k, 0.3, 1000, prob))(keys))
        for t in (ours, ref):
            assert t.min() >= lo and t.max() < hi
        if prob == 0.5:
            assert 0.3 < (ours >= 300).mean() < 0.7
            assert 0.3 < (ref >= 300).mean() < 0.7


# ----------------------------------------------------- adapter and VAE
def test_local_loss_mask_matches_jax():
    rs = np.random.RandomState(2)
    tracks = (rs.rand(3, 6, 2) * [96, 64]).astype(np.float32)
    tracks[0, 0] = [0.5, 63.0]                        # boxes clipped at edges
    valid = rs.rand(3, 6) > 0.3
    ref = j_local_loss_mask(jnp.asarray(tracks), jnp.asarray(valid), 8, 12,
                            8, 2)
    out = local_loss_mask(_t(tracks), torch.from_numpy(valid), 8, 12, 8, 2)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
    assert 0 < float(out.sum()) < out.numel()


def test_vae_moments_path_matches_jax():
    """sample_video_from_moments against JAX's with the JAX draw fed as eps;
    encode_video_moments against the port's encode_video (whose JAX parity
    tests/test_torch_models.py holds): its mean, scaled, is the mode."""
    rs = np.random.RandomState(3)
    mean = rs.randn(1, 2, 4, 4, 4).astype(np.float32)
    logvar = (rs.randn(1, 2, 4, 4, 4) - 1.0).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    ref = JVAE(**VAE_KW).apply({'params': {}}, jnp.asarray(mean),
                               jnp.asarray(logvar), rng,
                               method=JVAE.sample_video_from_moments)
    eps = jax.random.normal(rng, (2, 4, 4, 4))
    vae = AutoencoderKL(**VAE_KW)
    init_weights(vae, torch.Generator().manual_seed(0))
    out = vae.sample_video_from_moments(_t(mean), _t(logvar), eps=_t(eps))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-6,
                               atol=1e-6)
    video = _t(rs.rand(1, 2, 32, 32, 3) * 2 - 1)
    with torch.no_grad():
        m, lv = vae.encode_video_moments(video)
        mode = vae.encode_video(video)
    assert m.shape == lv.shape == (1, 2, 4, 4, 4)
    np.testing.assert_allclose((m * vae.scaling_factor).numpy(),
                               mode.numpy(), rtol=1e-6, atol=1e-6)


# ------------------------------------------------------------- trainer
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
def trainers():
    key = jax.random.PRNGKey(0)
    mods = {'unet': JUNet(cfg=JUNetConfig(**UNET_KW)), 'vae': JVAE(**VAE_KW),
            'text_encoder': JCLIP(cfg=JCLIPConfig(**CLIP_KW)),
            'adapter': JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))}
    h8 = SIZE // 8
    shapes = {
        'unet': jax.eval_shape(mods['unet'].init, key,
                               jnp.zeros((1, F, h8, h8, 4)), jnp.array([0]),
                               jnp.zeros((1, 77, 24))),
        'vae': jax.eval_shape(mods['vae'].init, key,
                              jnp.zeros((1, 32, 32, 3))),
        'text_encoder': jax.eval_shape(mods['text_encoder'].init, key,
                                       jnp.zeros((1, 77), jnp.int32)),
        'adapter': jax.eval_shape(
            lambda k, t, e: mods['adapter'].init(k, t, (SIZE, SIZE), e),
            key, jnp.zeros((F, P, 2)), jnp.zeros((P, 12))),
    }
    params = {name: _random_params(s, i)
              for i, (name, s) in enumerate(shapes.items())}
    # remat off on the JAX side: the same gradient, a shorter compile
    jtrainer = JTrainer(tokenizer=JHashTokenizer(),
                        sched=jsched.make_schedule(),
                        params={n: params[n] for n in
                                ('unet', 'vae', 'text_encoder')},
                        tune_cfg=dict(TUNE, remat=False),
                        optimizer_cfg={'lr': 1e-3}, **mods)
    built = build_models({'models': MODELS_OPT}, device='cpu')
    for name in mods:
        built[name].load_state_dict(
            jax_params_to_state_dict(params[name]), strict=True)
    ttrainer = VideoSwapTrainer(tune_cfg=dict(TUNE),
                                optimizer_cfg={'lr': 1e-3}, **built)
    return jtrainer, params, ttrainer


def _jax_draws(rng, latent_shape, tune):
    """The draws of JAX's build_loss_fn, made as it makes them."""
    k_vae, k_t, k_noise, k_drop = jax.random.split(rng, 4)
    b, f = latent_shape[:2]
    return {
        'vae_eps': np.array(jax.random.normal(
            k_vae, (b * f,) + latent_shape[2:])).reshape(latent_shape),
        't': np.array(j_sample_biased_timestep(
            k_t, tune['min_timestep'], 1000)),
        'noise': np.array(jax.random.normal(k_noise, latent_shape)),
        'keep': np.array(jax.random.uniform(k_drop, (P,))
                         > tune['drop_rate']),
    }


def _adapter_grads(trainer):
    return {n: p.grad.clone() for n, p in trainer.adapter.named_parameters()}


def test_trainer_loss_and_grad_match_jax(trainers):
    """Loss and every adapter gradient against jax.value_and_grad of the
    JAX package's loss_fn, on the JAX draws (local loss mask, point
    dropout, cached VAE moments)."""
    jtrainer, params, ttrainer = trainers
    batch = _batch()
    rng = jax.random.PRNGKey(7)
    loss_fn = jtrainer.build_loss_fn()
    frozen = {n: params[n] for n in ('unet', 'vae', 'text_encoder')}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    ref_loss, ref_grads = jax.jit(jax.value_and_grad(loss_fn))(
        params['adapter']['params'], frozen, jbatch, rng)
    draws = _jax_draws(rng, batch['latent_mean'].shape, TUNE)

    ttrainer.adapter.zero_grad(set_to_none=True)
    loss = ttrainer.loss_fn({k: torch.from_numpy(np.asarray(v))
                             for k, v in batch.items()},
                            {k: torch.from_numpy(v) for k, v in
                             draws.items()})
    loss.backward()
    # fp32 through a random-weight U-Net forward and backward with sums in
    # another order: 1e-5 of the loss, 1e-4 of each gradient's largest entry
    assert abs(loss.item() - float(ref_loss)) <= 1e-5 * abs(float(ref_loss))
    ref = jax_params_to_state_dict({'params': ref_grads})
    grads = _adapter_grads(ttrainer)
    assert set(grads) == set(ref)
    for name, g in grads.items():
        r = ref[name].numpy()
        err = float(np.abs(g.numpy() - r).max())
        assert err <= 1e-4 * float(np.abs(r).max()), name


def test_trainer_pixels_path_equals_cached_moments(trainers):
    """Encoding the frames in the loss equals replaying their moments."""
    _, _, tr = trainers
    rs = np.random.RandomState(5)
    pixels = torch.from_numpy(rs.rand(1, F, SIZE, SIZE, 3).astype(
        np.float32) * 2 - 1)
    common = {k: torch.as_tensor(v) for k, v in _batch().items()
              if not k.startswith('latent_')}
    with torch.no_grad():
        mean, logvar = tr.vae.encode_video_moments(pixels)
        draws = tr.make_draws({'latent_mean': mean, **common},
                              torch.Generator().manual_seed(2))
        a = tr.loss_fn({**common, 'pixels': pixels}, draws)
        b = tr.loss_fn({**common, 'latent_mean': mean,
                        'latent_logvar': logvar}, draws)
    assert float(a) == float(b)


@pytest.fixture(scope='module')
def remat_case(trainers):
    """A batch, its draws and the adapter gradient without gradient
    checkpointing, shared by the remat modes' tests."""
    _, _, tr = trainers
    batch = {k: torch.as_tensor(v) for k, v in _batch(1).items()}
    draws = tr.make_draws(batch, torch.Generator().manual_seed(3))
    tr.unet.set_gradient_checkpointing(False)
    tr.adapter.zero_grad(set_to_none=True)
    tr.loss_fn(batch, draws).backward()
    grads = _adapter_grads(tr)
    tr.unet.set_gradient_checkpointing('edges')
    return batch, draws, grads


@pytest.mark.parametrize('mode', [True, 'edges', 'save_flash', 'edges_sf'])
def test_remat_gives_the_same_gradient(trainers, remat_case, mode):
    _, _, tr = trainers
    batch, draws, plain = remat_case
    tr.unet.set_gradient_checkpointing(mode)
    tr.adapter.zero_grad(set_to_none=True)
    tr.loss_fn(batch, draws).backward()
    grads = _adapter_grads(tr)
    tr.unet.set_gradient_checkpointing('edges')
    for name, g in plain.items():
        np.testing.assert_allclose(grads[name].numpy(), g.numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


@pytest.mark.parametrize('mode', [False, True, 'edges', 'save_flash',
                                  'edges_sf'])
def test_flash_forward_runs_once_a_site_when_saved(trainers, remat_case,
                                                   mode):
    """The flash forward's calls in a loss and its backward: once a site
    without recompute and under the save_flash policies; True adds one at
    every recomputed site (every block's but the level-0 down block's,
    which comes before the first adapter residual: nothing there needs a
    gradient), 'edges' one at the level-0 up block's."""
    _, _, tr = trainers
    batch, draws, _ = remat_case
    unet = tr.unet
    calls, marks = [0], {}

    def counting(*args, **kwargs):
        calls[0] += 1
        return plain(*args, **kwargs)

    def mark(name):
        return lambda *_: marks.setdefault(name, []).append(calls[0])

    plain = tfa.flash_attention_plain
    hooks = [unet.down_blocks[0].register_forward_pre_hook(mark('down0')),
             unet.down_blocks[0].register_forward_hook(mark('down0')),
             unet.up_blocks[-1].register_forward_pre_hook(mark('up0')),
             unet.up_blocks[-1].register_forward_hook(mark('up0'))]
    try:
        unet.set_gradient_checkpointing(mode)
        tr.adapter.zero_grad(set_to_none=True)
        with mock.patch.object(tfa, 'flash_attention_plain', counting):
            loss = tr.loss_fn(batch, draws)
            sites = calls[0]
            loss.backward()
    finally:
        for h in hooks:
            h.remove()
        unet.set_gradient_checkpointing('edges')
    down0 = marks['down0'][1] - marks['down0'][0]
    up0 = marks['up0'][1] - marks['up0'][0]
    assert sites > down0 > 0 and up0 > 0
    expected = {False: sites, True: 2 * sites - down0, 'edges': sites + up0,
                'save_flash': sites, 'edges_sf': sites}[mode]
    assert calls[0] == expected, (mode, calls[0], sites, down0, up0)


def test_step_with_a_fixed_draw_lowers_the_loss():
    """The analogue of the JAX package's trainer test: the same generator
    state every step re-evaluates the same timestep, noise and dropout, so
    AdamW on the adapter must lower the loss on that sample."""
    built = build_models({'models': MODELS_OPT}, device='cpu', seed=1)
    tr = VideoSwapTrainer(tune_cfg=dict(TUNE), optimizer_cfg={'lr': 1e-3},
                          max_grad_norm=1.0, **built)
    frozen = [p.clone() for p in tr.unet.parameters()]
    batch = {k: torch.as_tensor(v) for k, v in _batch(2).items()}
    losses = [float(tr.step(batch, torch.Generator().manual_seed(0)))
              for _ in range(4)]
    assert all(np.isfinite(losses))
    assert losses[-1] < losses[0], losses
    assert all(torch.equal(a, b) for a, b in zip(frozen,
                                                 tr.unet.parameters()))


@pytest.fixture(scope='module')
def bf16_trained():
    """bf16 models on the CPU, as the card runs them, after one AdamW step
    at the slice's lr: (trainer, adapter weights before the step)."""
    built = build_models({'models': MODELS_OPT}, device='cpu',
                         dtype=torch.bfloat16, seed=2)
    before = [p.detach().float().clone() for p in built['adapter'].parameters()]
    tr = VideoSwapTrainer(tune_cfg=dict(TUNE), optimizer_cfg={'lr': 1e-5},
                          **built)
    batch = {k: torch.as_tensor(v) for k, v in _batch(3).items()}
    loss = tr.step(batch, torch.Generator().manual_seed(4))
    assert math.isfinite(float(loss))
    return tr, before


def test_bf16_models_train_fp32_adapter_weights(bf16_trained):
    """The adapter's weights and AdamW state stay fp32 beside a bf16 U-Net,
    as the JAX package keeps flax's fp32 params: an update of lr 1e-5 moves
    every weight (in bf16 it would move almost none)."""
    tr, before = bf16_trained
    assert tr.unet.conv_in.weight.dtype == torch.bfloat16
    params = list(tr.adapter.parameters())
    assert all(p.dtype == torch.float32 for p in params)
    assert all(v.dtype == torch.float32
               for state in tr.optimizer.state.values()
               for k, v in state.items() if k != 'step')
    moved = torch.cat([(p.detach() != b).flatten()
                       for p, b in zip(params, before)])
    assert float(moved.float().mean()) >= 0.99
    # the first AdamW step moves each weight by lr * g / (|g| + eps) plus
    # the decay lr * 1e-2 * w, and the new weight is rounded to fp32 (half
    # a unit in the last place, <= 2^-24 |w|)
    for p, b in zip(params, before):
        change = (p.detach() - b).abs()
        assert bool((change <= 1e-5 * (1 + 1e-2 * b.abs())
                     + 2.0 ** -23 * b.abs()).all())
    assert max(float((p.detach() - b).abs().max())
               for p, b in zip(params, before)) >= 0.9e-5


def test_pipeline_serves_an_adapter_trained_in_fp32(bf16_trained):
    """The fp32 adapter's residuals are cast to the bf16 U-Net's dtype."""
    from videoswap_torch.pipelines import VideoSwapPipeline
    tr, _ = bf16_trained
    pipe = VideoSwapPipeline(unet=tr.unet, vae=tr.vae,
                             text_encoder=tr.text_encoder,
                             tokenizer=tr.tokenizer, sched=tr.sched,
                             adapter=tr.adapter)
    b = _batch(3)
    with torch.no_grad():
        out = pipe.sample('a cat walking', F, SIZE, SIZE,
                          num_inference_steps=1, guidance_scale=7.5,
                          output_type='latent',
                          conditions={'pred_tracks': b['pred_tracks'],
                                      'point_embedding': b['point_embedding'],
                                      'index_list': None})
    assert out.dtype == torch.bfloat16
    assert out.shape == (1, F, SIZE // 8, SIZE // 8, 4)
    assert bool(torch.isfinite(out).all())


def test_lr_schedules_match_optax():
    import optax
    cases = [(('constant', 1e-3, 100, 10), optax.linear_schedule(0, 1e-3, 10)),
             (('constant', 1e-3, 100), lambda _: 1e-3),
             (('linear', 1e-3, 100), optax.linear_schedule(1e-3, 0.0, 100)),
             (('cosine', 1e-3, 100), optax.cosine_decay_schedule(1e-3, 100))]
    for args, ref in cases:
        ours = VideoSwapTrainer.build_lr_schedule(*args)
        for step in (0, 5, 10, 50, 100, 150):
            assert math.isclose(ours(step), float(ref(step)), rel_tol=1e-6,
                                abs_tol=1e-12), (args, step)


def test_adamw_matches_optax_across_the_bridge():
    """Two `optax.adamw` updates of the adapter's params with seeded
    gradients, against the port's AdamW (the trainer's `init_state`) taking
    the second from optax's state after the first, carried across by
    `optax_adam_state_to_torch`: the weights and both moments within 1e-6
    relative L2 a tensor (fp32 rounding: the two order their arithmetic
    differently)."""
    import types

    import optax
    from videoswap_torch.models import AdapterConfig, SparsePointAdapter
    from videoswap_torch.models.converters import optax_adam_state_to_torch
    jadapter = JAdapter(cfg=JAdapterConfig(**ADAPTER_KW))
    shapes = jax.eval_shape(
        lambda k, t, e: jadapter.init(k, t, (SIZE, SIZE), e),
        jax.random.PRNGKey(0), jnp.zeros((F, P, 2)), jnp.zeros((P, 12)))
    params = [_random_params(shapes, 5)['params']]
    rs = np.random.RandomState(6)
    tx = optax.adamw(1e-3, b1=0.9, b2=0.999, weight_decay=0.01)
    states = [jax.jit(tx.init)(params[0])]
    grads = []

    @jax.jit
    def update(g, state, p):
        updates, state = tx.update(g, state, p)
        return optax.apply_updates(p, updates), state
    for _ in range(2):
        grads.append(jax.tree.map(
            lambda x: (1e-2 * rs.randn(*x.shape)).astype(np.float32),
            params[0]))
        p, state = update(grads[-1], states[-1], params[-1])
        states.append(state)
        params.append(p)

    adapter = SparsePointAdapter(AdapterConfig(**ADAPTER_KW))
    adapter.load_state_dict(jax_params_to_state_dict(params[1]), strict=True)
    opt = VideoSwapTrainer.init_state(types.SimpleNamespace(
        adapter=adapter, optimizer_cfg={'lr': 1e-3}))
    adam = states[1][0]
    optax_adam_state_to_torch(adam.mu, adam.nu, adam.count, adapter, opt)
    g = jax_params_to_state_dict(grads[1])
    for name, p in adapter.named_parameters():
        p.grad = g[name].clone()
    opt.step()

    def rel(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))
    want = {'weight': jax_params_to_state_dict(params[2]),
            'exp_avg': jax_params_to_state_dict(states[2][0].mu),
            'exp_avg_sq': jax_params_to_state_dict(states[2][0].nu)}
    for name, p in adapter.named_parameters():
        got = {'weight': p.detach(), **{k: opt.state[p][k] for k in
                                        ('exp_avg', 'exp_avg_sq')}}
        for k, v in got.items():
            assert rel(v, want[k][name]) <= 1e-6, (name, k)
        assert float(opt.state[p]['step']) == 2.0
