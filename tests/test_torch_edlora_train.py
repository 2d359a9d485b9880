"""Parity of the port's ED-LoRA training (videoswap_torch.edlora_train and
the `videoswap_torch.train_edlora` CLI) with the JAX package at
tests/test_edlora_train.py's widths (the smoke config's models: a 2D U-Net
(16, 32, 32, 32) with 4 heads, cross-attention width 24, one text layer),
fp32 on the CPU, from numpy-seeded weights loaded into both packages.

Checked: the LoRA site sets of both scopes, the init and the zero start,
the merge (with the 'full' scope's conv sites), concept registration, layer
prompts and the embedding warm start for both tokenizers, the AdamW groups
against optax on identical gradients with per-group clipping, and the two
CLIs on make_smoke_dataset's concept images: the JAX CLI runs once with
these weights, recording its LoRA init, its step keys, its losses and its
first step's gradients; the port's CLI runs with the same weights, init and
draws (the JAX keys' draws) and is held to them: the concept warm start,
the loss and both groups' gradients (relative 1e-4), every step's loss,
and each CLI's checkpoint read by the other package's consumer.
"""

import json
import math
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from videoswap_tpu import edlora as jedlora
from videoswap_tpu import edlora_train as jet
from videoswap_tpu.models import (AnimateDiffUNet3DModel as JUNet,
                                  UNet3DConfig as JUNetConfig)
from videoswap_tpu.models.clip_text import (CLIPTextConfig as JCLIPConfig,
                                            CLIPTextModel as JCLIP)
from videoswap_tpu.models.vae import AutoencoderKL as JVAE
from videoswap_tpu.pipelines import VideoSwapPipeline as JPipeline
from videoswap_tpu.pipelines.trainer import \
    sample_biased_timestep as j_sample_biased_timestep
from videoswap_tpu.schedulers import make_schedule as j_make_schedule
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch import edlora_train as et
from videoswap_torch import train_edlora as tcli
from videoswap_torch.builders import build_models
from videoswap_torch.edlora import load_edlora_into_pipeline
from videoswap_torch.models import converters
from videoswap_torch.models.converters import (edlora_train_params_from_jax,
                                               jax_params_to_state_dict)
from videoswap_torch.pipelines import VideoSwapPipeline
from videoswap_torch.utils.tokenizer import HashTokenizer

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / 'options' / 'smoke' / 'train_edlora_smoke.yml'
HID = 24
UNET_KW = dict(block_out_channels=(16, 32, 32, 32), attention_head_dim=4,
               cross_attention_dim=HID, norm_num_groups=8,
               use_motion_module=False)
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), norm_groups=8)
CLIP_KW = dict(hidden_size=HID, num_layers=1, num_heads=4,
               intermediate_size=32)
MODELS_OPT = {'unet': {'unet_cfg': UNET_KW}, 'vae_cfg': VAE_KW,
              'text_encoder_cfg': CLIP_KW}
NAMES = ('unet', 'vae', 'text_encoder')


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
def models():
    """The JAX modules and numpy-seeded params (shapes by eval_shape: no
    init compile), and the port's models holding the same weights."""
    key = jax.random.PRNGKey(0)
    jmods = {'unet': JUNet(cfg=JUNetConfig(**UNET_KW)), 'vae': JVAE(**VAE_KW),
             'text_encoder': JCLIP(cfg=JCLIPConfig(**CLIP_KW))}
    shapes = {
        'unet': jax.eval_shape(jmods['unet'].init, key,
                               jnp.zeros((1, 1, 8, 8, 4)), jnp.array([0]),
                               jnp.zeros((1, 77, HID))),
        'vae': jax.eval_shape(jmods['vae'].init, key,
                              jnp.zeros((1, 64, 64, 3))),
        'text_encoder': jax.eval_shape(jmods['text_encoder'].init, key,
                                       jnp.zeros((1, 77), jnp.int32))}
    params = {n: _random_params(shapes[n], i) for i, n in enumerate(NAMES)}
    sds = {n: jax_params_to_state_dict(params[n]) for n in NAMES}
    port = build_models({'models': MODELS_OPT}, device='cpu')
    for n in NAMES:
        port[n].load_state_dict(sds[n], strict=True)
    return dict(jmods=jmods, params=params, sds=sds, port=port)


def _jparams(models, name):
    return models['params'][name]['params']


# ------------------------------------------------------------------ sites
@pytest.mark.parametrize('scope', ['attn', 'full'])
@pytest.mark.parametrize('model_type', ['unet', 'text_encoder'])
def test_sites_match_jax(models, scope, model_type):
    ref = jet.lora_sites(_jparams(models, model_type), model_type, scope)
    ours = et.lora_sites(models['port'][model_type], model_type, scope)
    assert [(s.torch_key, s.is_conv) for s in ours] == sorted(
        (s.torch_key, s.is_conv) for s in ref)
    if model_type == 'unet':
        # 16 spatial transformers x 2 attentions x 4 projections; 'full'
        # adds the two FFN layers and the two 1x1 convs of each
        assert len(ours) == (128 if scope == 'attn' else 128 + 16 * 4)
        assert sum(s.is_conv for s in ours) == (0 if scope == 'attn'
                                                else 32)
    else:
        assert len(ours) == (4 if scope == 'attn' else 6)


def test_init_bounds_and_zero_start(models):
    """down ~ U(+-1/sqrt(I)), up zero: the merged weights are the base's
    bit for bit."""
    unet = models['port']['unet']
    sites = et.lora_sites(unet, 'unet', 'full')
    lora = et.init_lora_params(torch.Generator().manual_seed(0), unet, sites,
                               rank=2)
    frozen = dict(unet.named_parameters())
    for site in sites:
        p = lora[site.torch_key]
        w = frozen[site.name]
        assert p['down'].shape == (2, w.shape[1])
        assert p['up'].shape == (w.shape[0], 2)
        assert float(p['down'].abs().max()) <= w.shape[1] ** -0.5
        assert float(p['up'].abs().max()) == 0.0
    merged = et.merge_lora(frozen, lora, sites, alpha=0.7)
    for name, w in merged.items():
        assert torch.equal(w, frozen[name]), name


def test_merge_matches_jax(models):
    """The in-graph merge at alpha 0.7 on the same factors, 'full' scope
    (conv sites included), both models: fp32, 1e-6."""
    rs = np.random.RandomState(2)
    for name in ('unet', 'text_encoder'):
        base = _jparams(models, name)
        sites = jet.lora_sites(base, name, 'full')
        module = models['port'][name]
        shapes = {k: v.shape for k, v in module.state_dict().items()}
        lora = {}
        for s in sites:
            out_f, in_f = shapes[s.torch_key if name == 'unet' else
                                 converters.clip_key_unmap(s.torch_key)][:2]
            lora[s.torch_key] = {
                'down': rs.randn(2, in_f).astype(np.float32) * in_f ** -0.5,
                'up': rs.randn(out_f, 2).astype(np.float32) * 0.1}
        ref = jax_params_to_state_dict(jax.jit(
            lambda b, lo: jet.merge_lora(b, lo, sites, 0.7))(base, lora))
        tsites = et.lora_sites(module, name, 'full')
        tlora = edlora_train_params_from_jax(
            {'concept_emb': {}, 'unet_lora': lora, 'text_lora': {}}
        )['unet_lora']
        ours = et.merge_lora(dict(module.named_parameters()), tlora, tsites,
                             0.7)
        assert len(ours) == len(sites)
        for key, w in ours.items():
            np.testing.assert_allclose(w.detach().numpy(), ref[key].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


# ---------------------------------------------------------- concept tokens
def _clip_tokenizers(tmp_path):
    """Two CLIP BPE tokenizers (the port's) of one generated vocabulary:
    the JAX package's functions take any tokenizer, and the port's
    tokenizer is held to transformers' by tests/test_torch_tokenizer.py.
    (Given transformers' CLIPTokenizer itself, the JAX package's
    init_concept_embedding raises: it takes `input_ids[0]` of a lone
    string's encoding, which transformers returns unbatched.)"""
    import importlib.util

    from videoswap_torch.utils.tokenizer import load_tokenizer
    spec = importlib.util.spec_from_file_location('chip_smoke',
                                                  ROOT / 'chip_smoke.py')
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    tok_dir = tmp_path / 'tokenizer'
    tok_dir.mkdir()
    vocab, merges = cs.clip_vocab(['a photo of a kitten on the grass',
                                   'a cat and a dog'], size=1024, merges=40)
    (tok_dir / 'vocab.json').write_text(json.dumps(vocab))
    (tok_dir / 'merges.txt').write_text(merges)
    return load_tokenizer(str(tmp_path)), load_tokenizer(str(tmp_path))


@pytest.mark.parametrize('kind', ['hash', 'clip'])
def test_concept_tokens_match_jax(models, tmp_path, kind):
    """register_concepts, tokenize_layer_prompts and the embedding warm
    start (the mean of the init words' rows, the EOS padding and BOS out)
    give the JAX package's ids and rows, for the hash stand-in and CLIP's
    BPE tokenizer."""
    if kind == 'hash':
        jtok, ttok = JHashTokenizer(), HashTokenizer()
    else:
        jtok, ttok = _clip_tokenizers(tmp_path)
    names = ['catA1', 'dogB']
    jcfg, tcfg = (m.register_concepts(t, names)
                  for m, t in ((jet, jtok), (et, ttok)))
    assert tcfg == jcfg
    caption = 'a photo of a catA1 and a dogB on the grass'
    ids = et.tokenize_layer_prompts(ttok, caption, tcfg)
    assert ids.dtype == np.int32 and ids.shape == (16, 77)
    np.testing.assert_array_equal(
        ids, jet.tokenize_layer_prompts(jtok, caption, jcfg))
    assert ids[3].tolist().count(tcfg['catA1']['concept_token_ids'][3]) == 1
    for init in ('cat', 'kitten dog'):
        ours = et.init_concept_embedding(models['port']['text_encoder'],
                                         ttok, init)
        ref = jet.init_concept_embedding(_jparams(models, 'text_encoder'),
                                         jtok, init)
        assert ours.dtype == torch.float32 and ours.shape == (16, HID)
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-6,
                                   atol=1e-7)


# --------------------------------------------------------------- optimizer
def _tree(rs, scale=1.0):
    return {'concept_emb': {'catA1': rs.randn(16, HID) * scale,
                            'dogB': rs.randn(16, HID) * scale},
            'unet_lora': {f'u{i}.weight': {'down': rs.randn(2, 8) * scale,
                                           'up': rs.randn(16, 2) * scale}
                          for i in range(3)},
            'text_lora': {'t.weight': {'down': rs.randn(2, HID) * scale,
                                       'up': rs.randn(HID, 2) * scale}}}


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_optimizer_matches_optax_on_identical_gradients(models):
    """Two AdamW steps on the same gradients, each group clipped by its own
    global norm (both groups above max_grad_norm, by other factors at the
    two steps): the port's update against the JAX trainer's optax
    transform, 1e-6. A single clip over every parameter lands elsewhere."""
    rs = np.random.RandomState(3)
    params = _f32(_tree(rs, 0.1))
    grads = [_f32(_tree(rs, s)) for s in (1.0, 0.2)]
    for g, f in zip(grads, (3.0, 0.5)):        # the groups' norms move apart
        g['concept_emb'] = jax.tree.map(lambda a: a * f, g['concept_emb'])
    ocfg = {'emb_lr': 1e-2, 'lora_lr': 1e-3, 'weight_decay': 0.05}
    jm, port = models['jmods'], models['port']
    jtr = jet.EDLoRATrainer(unet=jm['unet'], text_encoder=jm['text_encoder'],
                            vae=jm['vae'], sched=j_make_schedule(),
                            params={}, unet_sites=(), text_sites=(),
                            optimizer_cfg=ocfg, max_grad_norm=1.0)
    jparams = jax.tree.map(jnp.asarray, params)
    state = jtr.tx.init(jparams)
    update = jax.jit(jtr.tx.update)        # one compile, not one an op
    for g in grads:
        upd, state = update(jax.tree.map(jnp.asarray, g), state, jparams)
        jparams = optax.apply_updates(jparams, upd)
    ref = np.concatenate([np.ravel(a) for a in
                          jax.tree.leaves(jax.device_get(jparams))])

    def run(clip_each_group):
        tr = et.EDLoRATrainer(unet=port['unet'],
                              text_encoder=port['text_encoder'],
                              vae=port['vae'], sched=port['sched'],
                              unet_sites=(), text_sites=(),
                              optimizer_cfg=ocfg, max_grad_norm=1.0)
        tp = edlora_train_params_from_jax(params)
        groups = et.param_groups(tp)
        for t in groups['emb'] + groups['lora']:
            t.requires_grad_(True)
        opt = tr.init_state(tp)
        for g in grads:
            tg = et.param_groups(edlora_train_params_from_jax(g))
            for k in ('emb', 'lora'):
                for p, gp in zip(groups[k], tg[k]):
                    p.grad = gp
            if clip_each_group:
                tr.update(opt)
            else:
                et.clip_by_global_norm_(
                    [p.grad for p in groups['emb'] + groups['lora']], 1.0)
                opt.step()
        # jax.tree.leaves' order: sorted dict keys at every level
        leaves = jax.tree.leaves(jax.tree.map(
            lambda t: t.detach().numpy(), tp))
        return np.concatenate([np.ravel(a) for a in leaves])

    np.testing.assert_allclose(run(True), ref, rtol=0, atol=1e-6)
    assert np.abs(run(False) - ref).max() > 1e-4


# --------------------------------------------------------------------- CLIs
class _JaxRecorder(jet.EDLoRATrainer):
    """The JAX CLI's trainer, recording its LoRA init, its step keys and
    losses and its first step's gradients (from the same compiled step)."""
    record: dict = None

    def __post_init__(self):
        super().__post_init__()
        self.return_grads = True

    def init_train_params(self, rng, concept_emb, rank=4):
        out = super().init_train_params(rng, concept_emb, rank)
        self.record['init'] = jax.device_get(out)   # the step donates it
        return out

    def step(self, train_params, opt_state, batch, rng):
        train_params, opt_state, loss, grads = super().step(
            train_params, opt_state, batch, rng)
        rec = self.record
        rec['rngs'].append(rng)
        rec['losses'].append(float(loss))
        rec.setdefault('grads', jax.device_get(grads))
        return train_params, opt_state, loss


def _jax_draws(rng):
    """build_loss_fn's draws for a (1, 1, 8, 8, 4) latent, made as it
    makes them."""
    k_vae, k_t, k_noise = jax.random.split(rng, 3)
    shape = (1, 1, 8, 8, 4)
    return {'vae_eps': np.array(jax.random.normal(k_vae, (1, 8, 8, 4))
                                ).reshape(shape),
            't': np.array(j_sample_biased_timestep(k_t, 0.0, 1000)),
            'noise': np.array(jax.random.normal(k_noise, shape))}


def _flat_groups(tree):
    """{'emb', 'lora'}: a train-params tree's leaves flattened in the port's
    group order (et.param_groups)."""
    groups = et.param_groups(edlora_train_params_from_jax(tree))
    return {k: torch.cat([t.reshape(-1) for t in v])
            for k, v in groups.items()}


@pytest.fixture(scope='module')
def clis(models, tmp_path_factory):
    """Both CLIs on the smoke config (4 steps, rank 2, alpha 1) over three
    concept images of make_smoke_dataset, in roots of their own."""
    import importlib.util

    import train_edlora as jcli
    base = tmp_path_factory.mktemp('edlora')
    spec = importlib.util.spec_from_file_location(
        'make_smoke_dataset', ROOT / 'scripts' / 'make_smoke_dataset.py')
    msd = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(msd)
    msd.make(str(base / 'data'), frames=2, size=64)
    yml = base / 'edlora.yml'
    yml.write_text(SMOKE.read_text().replace(
        'image_dir: datasets/smoke/concepts',
        f'image_dir: {base / "data" / "concepts"}'))
    jrec = {'rngs': [], 'losses': []}
    jm = models['jmods']

    def jax_models(opt, root_path, **kw):
        return dict(jm, adapter=None, sched=j_make_schedule(),
                    tokenizer=JHashTokenizer(),
                    params=jax.tree.map(jnp.asarray, models['params']))

    class JRec(_JaxRecorder):
        record = jrec

    args = type('A', (), {'opt': str(yml), 'shard': None})()
    with mock.patch.object(jcli, 'build_models', jax_models), \
            mock.patch.object(jcli, 'EDLoRATrainer', JRec):
        jcli.train(str(base / 'jax'), args)

    draws = [_jax_draws(r) for r in jrec['rngs']]
    trec = {'grads': None}
    jinit = edlora_train_params_from_jax(jrec['init'])
    real_build = tcli.build_models

    def port_models(opt, root_path, **kw):
        built = real_build(opt, root_path, **kw)
        for n in NAMES:
            built[n].load_state_dict(models['sds'][n], strict=True)
        return built

    class TRec(et.EDLoRATrainer):
        def init_train_params(self, generator, concept_emb, rank=4):
            out = super().init_train_params(generator, concept_emb, rank)
            trec['emb0'] = {k: v.detach().clone()
                            for k, v in out['concept_emb'].items()}
            for part in ('unet_lora', 'text_lora'):
                out[part] = {k: {n: t.clone().requires_grad_()
                                 for n, t in p.items()}
                             for k, p in jinit[part].items()}
            return out

        def make_draws(self, batch, generator):
            return {k: torch.from_numpy(v)
                    for k, v in draws[trec.setdefault('n', 0)].items()}

        def update(self, optimizer):
            if trec['grads'] is None:
                trec['grads'] = {g['name']: torch.cat(
                    [p.grad.reshape(-1) for p in g['params']]).clone()
                    for g in optimizer.param_groups}
            trec['n'] += 1
            super().update(optimizer)

    args = type('A', (), {'opt': str(yml), 'device': 'cpu',
                          'shard': None})()
    with mock.patch.object(tcli, 'build_models', port_models), \
            mock.patch.object(tcli, 'EDLoRATrainer', TRec):
        out = tcli.train(str(base / 'port'), args)
    files = {side: base / side / 'experiments' / 'smoke_edlora' / 'models'
             / 'models_4' for side in ('jax', 'port')}
    return dict(jax=jrec, port=trec, out=out, files=files)


def test_cli_steps_match_jax(clis):
    """Same weights, LoRA init, image order and draws: the concept warm
    start equals the JAX CLI's, the first step's loss and each group's
    gradient agree to 1e-4 (relative), and every later step's loss too
    (the states apart by Adam's rounding of the same gradients)."""
    j, t = clis['jax'], clis['port']
    for name, emb in t['emb0'].items():
        np.testing.assert_allclose(emb.numpy(), j['init']['concept_emb'][name],
                                   rtol=1e-6, atol=1e-7)
    losses = clis['out']['losses']
    assert len(losses) == len(j['losses']) == 4
    ref = _flat_groups(j['grads'])
    for k in ('emb', 'lora'):
        err = float((t['grads'][k] - ref[k]).norm() / ref[k].norm())
        assert err <= 1e-4, (k, err)
    for step, (a, b) in enumerate(zip(losses, j['losses'])):
        assert abs(a - b) <= 1e-4 * abs(b), (step, a, b)


def test_cli_writes_the_jax_clis_files(clis):
    """models/models_4 holds edlora_model-latest.pth with the JAX CLI's
    keys and shapes and the same new_concept_cfg.json."""
    jdir, tdir = clis['files']['jax'], clis['files']['port']
    assert clis['out']['checkpoints'] == {4: str(tdir / tcli.CHECKPOINT)}
    assert json.loads((tdir / 'new_concept_cfg.json').read_text()) \
        == json.loads((jdir / 'new_concept_cfg.json').read_text())
    a, b = (torch.load(d / tcli.CHECKPOINT, weights_only=True)
            for d in (tdir, jdir))
    assert sorted(a) == sorted(b) == ['new_concept_embedding',
                                      'text_encoder', 'unet']
    for part in a:
        assert {k: tuple(v.shape) for k, v in a[part].items()} \
            == {k: tuple(v.shape) for k, v in b[part].items()}, part
    assert len(a['unet']) == 2 * 128 and len(a['text_encoder']) == 2 * 4


@pytest.mark.parametrize('writer', ['port', 'jax'])
def test_checkpoint_loads_in_both_consumers(models, clis, writer):
    """Each CLI's file, through videoswap_tpu.edlora.load_edlora_into_
    pipeline and videoswap_torch.edlora's: the same concept rows and the
    same merged U-Net and text-encoder weights (1e-6)."""
    path = str(clis['files'][writer] / tcli.CHECKPOINT)
    jpipe = JPipeline(unet=models['jmods']['unet'], vae=models['jmods']['vae'],
                      text_encoder=models['jmods']['text_encoder'],
                      tokenizer=JHashTokenizer(), sched=j_make_schedule(),
                      params={n: models['params'][n] for n in NAMES})
    jedlora.load_edlora_into_pipeline(jpipe, path, alpha=0.7)
    port = models['port']
    tpipe = VideoSwapPipeline(unet=port['unet'], vae=port['vae'],
                              text_encoder=port['text_encoder'],
                              tokenizer=HashTokenizer(), sched=port['sched'])
    ctx = load_edlora_into_pipeline(tpipe, path, alpha=0.7)
    try:
        assert tpipe.new_concept_cfg == jpipe.new_concept_cfg
        np.testing.assert_allclose(tpipe.extra_token_embeds.numpy(),
                                   np.asarray(jpipe.extra_token_embeds),
                                   rtol=0, atol=0)
        for name in ('unet', 'text_encoder'):
            ref = jax_params_to_state_dict(jpipe.params[name])
            assert len(ctx[name]) == (128 if name == 'unet' else 4)
            module = getattr(tpipe, name)
            for key in ctx[name]:
                np.testing.assert_allclose(
                    module.get_parameter(key).detach().numpy(),
                    ref[key].numpy(), rtol=1e-6, atol=1e-6, err_msg=key)
    finally:
        from videoswap_torch.edlora import restore_pipeline
        restore_pipeline(tpipe, ctx)
