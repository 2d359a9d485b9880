"""Parity of the port's prompt-to-prompt functions (videoswap_torch/p2p)
with the JAX package's, on the same inputs: token mappers, word indices,
the cross-replacement alpha schedule, site geometry at 512^2 and 448x768,
the blend mask and latent blend, the per-site edit functions, the per-step
self masks and latent blend step, and `make_edit_bundle`. Also: the
port's new modules import no JAX, flax, optax, yaml or PIL.

The host-side functions (mappers, indices, schedules, geometry, bundle
configs) must agree exactly; the tensor functions in fp32 to 1e-6
(elementwise arithmetic in the same order, sums over 77 words and a few
heads).
"""

import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.p2p import blend as jblend
from videoswap_tpu.p2p import edit as jedit
from videoswap_tpu.p2p import ptp_utils as jptp
from videoswap_tpu.p2p import seq_aligner as jseq
from videoswap_tpu.p2p import sites as jsites
from videoswap_tpu.p2p.ctrl import SiteKey as JSiteKey
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch.p2p import blend, edit, ptp_utils, seq_aligner, sites
from videoswap_torch.p2p.ctrl import AttnCtrl, SiteKey
from videoswap_torch.utils.tokenizer import HashTokenizer

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-6
PAIRS = [('a cat walking on the floor', 'a fluffy dog walking on the floor'),
         ('a man is walking in front of trees and grass',
          'a <hermione1> <hermione2> is walking in front of trees and grass'),
         ('a cat on a mat', 'a dog on a mat')]


def _np(t):
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(a, b, tol=TOL):
    np.testing.assert_allclose(_np(a), np.asarray(b), rtol=0, atol=tol)


@pytest.mark.parametrize('src,tgt', PAIRS)
def test_mappers_match_jax(src, tgt):
    m, a = seq_aligner.get_refinement_mapper([src, tgt], HashTokenizer())
    jm, ja = jseq.get_refinement_mapper([src, tgt], JHashTokenizer())
    np.testing.assert_array_equal(m, jm)
    np.testing.assert_array_equal(a, ja)
    if len(src.split(' ')) == len(tgt.split(' ')):
        np.testing.assert_array_equal(
            seq_aligner.get_replacement_mapper([src, tgt], HashTokenizer()),
            jseq.get_replacement_mapper([src, tgt], JHashTokenizer()))


def _concept_tokenizers():
    cfg = {'<hermione1>': {'concept_token_names': [
        f'<<hermione1>_{i}>' for i in range(16)]}}
    toks = []
    for tok in (HashTokenizer(), JHashTokenizer()):
        tok.add_tokens(cfg['<hermione1>']['concept_token_names'])
        tok.new_concept_cfg = cfg
        toks.append(tok)
    return toks


@pytest.mark.parametrize('concepts', [False, True])
def test_word_inds_and_alpha_schedule_match_jax(concepts):
    tok, jtok = (_concept_tokenizers() if concepts
                 else (HashTokenizer(), JHashTokenizer()))
    src, tgt = PAIRS[1]
    for word in ('<hermione1>', 'walking', 'trees', 'absent', 3):
        np.testing.assert_array_equal(
            ptp_utils.get_word_inds(tgt, word, tok),
            jptp.get_word_inds(tgt, word, jtok))
    for steps, bounds in ((5, 0.5), (50, (0.2, 0.7)),
                          (10, {'default_': 0.4, 'walking': (0.1, 0.9)})):
        np.testing.assert_array_equal(
            ptp_utils.get_time_words_attention_alpha(
                [src, tgt], steps, dict(bounds) if isinstance(bounds, dict)
                else bounds, tok),
            jptp.get_time_words_attention_alpha(
                [src, tgt], steps, dict(bounds) if isinstance(bounds, dict)
                else bounds, jtok))


@pytest.mark.parametrize('height,width', [(512, 512), (448, 768),
                                          (256, 256)])
def test_site_geometry_matches_jax(height, width):
    h8, w8 = height // 8, width // 8
    for kind in ('self', 'cross'):
        for s, js in zip(sites.all_sites(kind), jsites.all_sites(kind)):
            assert tuple(s) == tuple(js) and s.name == js.name
            assert sites.site_hw(s, h8, w8) == jsites.site_hw(js, h8, w8)
            assert sites.site_tokens(s, h8, w8) == \
                jsites.site_tokens(js, h8, w8)
        for place in ('down', 'mid', 'up'):
            assert [tuple(s) for s in sites.stored_sites(place, kind, h8, w8)] \
                == [tuple(s) for s in jsites.stored_sites(place, kind, h8, w8)]
    assert [s.name for s in sites.blend_sites(h8, w8)] == \
        [s.name for s in jsites.blend_sites(h8, w8)]
    assert edit.self_store_bytes(50, 16, h8, w8) == \
        jedit.self_store_bytes(50, 16, h8, w8)


def _maps(rs, p, f, heads, s):
    m = rs.rand(p, f, heads, s, 77).astype(np.float32)
    return m / m.sum(-1, keepdims=True)


@pytest.mark.parametrize('height,width,out_hw', [
    (256, 256, (32, 32)), (256, 256, (4, 4)), (448, 768, (56, 96)),
    (448, 768, (7, 12))])
def test_blend_mask_and_latent_blend_match_jax(height, width, out_hw):
    rs = np.random.RandomState(0)
    h8, w8 = height // 8, width // 8
    s = sites.site_tokens(sites.blend_sites(h8, w8)[0], h8, w8)
    maps = [_maps(rs, 2, 3, 2, s) for _ in range(3)]
    alpha = np.zeros((2, 77), np.float32)
    alpha[0, [2, 3]] = 1.0
    alpha[1, [2, 5]] = 1.0
    mask = blend.blend_mask([torch.from_numpy(m) for m in maps],
                            torch.from_numpy(alpha), 0.3, out_hw, height,
                            width)
    jmask = jblend.blend_mask([jnp.asarray(m) for m in maps],
                              jnp.asarray(alpha), 0.3, out_hw, height, width)
    np.testing.assert_array_equal(_np(mask), np.asarray(jmask))
    np.testing.assert_array_equal(_np(blend.union_both(mask)),
                                  np.asarray(jblend.union_both(jmask)))
    x = rs.randn(2, 4, 5, 6).astype(np.float32)
    _close(blend.max_pool_3x3(torch.from_numpy(x)),
           jblend.max_pool_3x3(jnp.asarray(x)))
    src, tgt = (rs.randn(1, 3, *out_hw, 4).astype(np.float32)
                for _ in range(2))
    _close(blend.latent_blend(torch.from_numpy(src), torch.from_numpy(tgt),
                              mask[1]),
           jblend.latent_blend(jnp.asarray(src), jnp.asarray(tgt), jmask[1]))


F, H8 = 2, 32           # 2 frames at 256^2: the smallest blend geometry
HEADS = 2


def _inversion(rs, steps, kinds=('cross', 'self')):
    """A random inversion store: per-step latents and maps of every
    controlled site."""
    lat = rs.randn(steps, 1, F, H8, H8, 4).astype(np.float32)
    attn = {}
    for kind in kinds:
        for s in sites.controlled_sites(kind, H8, H8):
            tok = sites.site_tokens(s, H8, H8)
            keys = 77 if kind == 'cross' else tok
            m = rs.rand(steps, F, HEADS, tok, keys).astype(np.float32)
            attn[s.name] = m / m.sum(-1, keepdims=True)
    z0 = rs.randn(1, F, H8, H8, 4).astype(np.float32)
    ts = np.arange(steps)[::-1] * 7 + 1
    return lat, attn, z0, ts


def _bundles(blend_cfg, steps=5, is_replace=False, recompute=False, seed=0):
    rs = np.random.RandomState(seed)
    lat, attn, z0, ts = _inversion(rs, steps)
    src, tgt = (PAIRS[2] if is_replace else PAIRS[0])
    kw = dict(num_steps=steps, video_length=F, height=8 * H8, width=8 * H8,
              blend_words=[['cat'], ['dog'] if is_replace else
                           ['fluffy', 'dog']], blend_cfg=blend_cfg,
              is_replace=is_replace, recompute_self=recompute)
    b = edit.make_edit_bundle(
        HashTokenizer(), src, tgt, inv_latents_per_step=torch.from_numpy(lat),
        inv_attn_store={k: torch.from_numpy(v) for k, v in attn.items()},
        inv_z0=torch.from_numpy(z0), inv_ts=ts, **kw)
    jb = jedit.make_edit_bundle(
        JHashTokenizer(), src, tgt, inv_latents_per_step=jnp.asarray(lat),
        inv_attn_store={k: jnp.asarray(v) for k, v in attn.items()},
        inv_z0=jnp.asarray(z0), inv_ts=ts, **kw)
    return b, jb


def _tree_close(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _tree_close(a[k], b[k])
    else:
        _close(a, b, 0)


@pytest.mark.parametrize('blend_cfg,is_replace,recompute', [
    ({'cross_replace_steps': 0.5, 'self_replace_steps': 0.5}, False, False),
    ({'cross_replace_steps': 0.5, 'self_replace_steps': 0.5}, False, True),
    ({'cross_replace_steps': 0.7, 'self_replace_steps': (0.2, 0.6),
      'blend_th': 0.4}, True, False),
    ({}, False, False)])
def test_make_edit_bundle_matches_jax(blend_cfg, is_replace, recompute):
    b, jb = _bundles(blend_cfg, is_replace=is_replace, recompute=recompute)
    assert b.cfg.__dict__ == jb.cfg.__dict__
    _tree_close(b.static_state, jb.static_state)
    _tree_close(b.xs, jb.xs)
    _tree_close(b.init_sums, jb.init_sums)


@pytest.mark.parametrize('is_replace', [False, True])
@pytest.mark.parametrize('self_on', [False, True])
def test_edit_functions_match_jax(is_replace, self_on):
    """Cross refine/replace and masked self replacement on random CFG-batch
    probabilities, with this step's state, against make_edit_fn of JAX."""
    b, jb = _bundles({'cross_replace_steps': 0.6, 'self_replace_steps': 0.6},
                     is_replace=is_replace)
    rs = np.random.RandomState(1)
    i = 1
    step = {k: {n: a[i] for n, a in v.items()} if isinstance(v, dict)
            else v[i] for k, v in b.xs.items()}
    jstep = {k: {n: a[i] for n, a in v.items()} if isinstance(v, dict)
             else v[i] for k, v in jb.xs.items()}
    state = {'alpha_words': b.static_state['alpha_words'][i],
             'base': step['base_cross'], 'base_self': step['base_self'],
             'self_on': self_on}
    jstate = {'alpha_words': jb.static_state['alpha_words'][i],
              'base': jstep['base_cross'], 'base_self': jstep['base_self'],
              'self_on': jnp.asarray(self_on)}
    state['self_mask'] = edit.self_masks_for_step(b.cfg, b.static_state,
                                                  state['base'])
    jstate['self_mask'] = jedit.self_masks_for_step(jb.cfg, jb.static_state,
                                                    jstate['base'])
    _tree_close(state['self_mask'], jstate['self_mask'])
    fn = edit.make_edit_fn(b.cfg, b.static_state)
    jfn = jedit.make_edit_fn(jb.cfg, jb.static_state)
    for kind in ('cross', 'self'):
        for s in sites.controlled_sites(kind, H8, H8):
            tok = sites.site_tokens(s, H8, H8)
            probs = _maps(rs, 1, 2 * F, HEADS, tok)[0] if kind == 'cross' \
                else rs.rand(2 * F, HEADS, tok, tok).astype(np.float32)
            f_ = fn(SiteKey(*s), tok, state)
            jf = jfn(JSiteKey(*s), tok, jstate)
            assert (f_ is None) == (jf is None)
            if f_ is not None:
                _close(f_(torch.from_numpy(probs)), jf(jnp.asarray(probs)))


def test_latent_blend_step_matches_jax():
    b, jb = _bundles({'cross_replace_steps': 0.5})
    rs = np.random.RandomState(2)
    sums, jsums = dict(b.init_sums), dict(jb.init_sums)
    lat = rs.randn(1, F, H8, H8, 4).astype(np.float32)
    for i in range(b.cfg.num_steps):               # the gate opens at 1..3
        tgt = {n: _maps(rs, 1, F, HEADS, m.shape[-2])[0]
               for n, m in b.init_sums.items()}
        out, sums = edit.latent_blend_step(
            b.cfg, b.static_state, torch.from_numpy(lat),
            b.xs['inv_latents'][i], {n: a[i] for n, a in
                                     b.xs['base_cross'].items()},
            sums, {n: torch.from_numpy(t) for n, t in tgt.items()}, i)
        jout, jsums = jedit.latent_blend_step(
            jb.cfg, jb.static_state, jnp.asarray(lat),
            jb.xs['inv_latents'][i], {n: a[i] for n, a in
                                      jb.xs['base_cross'].items()},
            jsums, {n: jnp.asarray(t) for n, t in tgt.items()}, i)
        _close(out, jout)
        for k in sums:                  # running sums of up to 5 maps
            _close(sums[k], jsums[k], 1e-5)


def test_store_filters_and_recompute_choice_match_jax():
    cfg = {'editing_prompts': {
        'a': {'replace': 'cat -> dog',
              'blend_cfg': {'cross_replace_steps': 0.5,
                            'self_replace_steps': 0.5}},
        'b': {'replace': 'cat -> fox'}}}
    for mode in ('auto', True, False):
        c = dict(cfg, recompute_self_stores=mode)
        for hw, frames, steps in (((512, 512), 16, 50), ((256, 256), 2, 5)):
            assert edit.want_recompute_self(c, *hw, frames, steps) == \
                jedit.want_recompute_self(c, *hw, frames, steps)
            f = edit.inversion_store_filter(c, HashTokenizer(), *hw, frames,
                                            steps)
            jf = jedit.inversion_store_filter(c, JHashTokenizer(), *hw,
                                              frames, steps)
            for kind in ('self', 'cross'):
                for s in sites.all_sites(kind):
                    assert f(s, 0) == jf(JSiteKey(*s), 0)


def test_ctrl_routes_like_jax():
    from videoswap_tpu.p2p.ctrl import AttnCtrl as JAttnCtrl
    flt = (lambda site, q: site.kind == 'cross')
    edit_fn = (lambda site, q, state: (lambda p: p) if q < 100 else None)
    for mode in ('none', 'store', 'edit', 'store_edit'):
        c = AttnCtrl(mode, store_filter=flt, edit_fn=edit_fn)
        jc = JAttnCtrl(mode, store_filter=flt, edit_fn=edit_fn)
        for site in (SiteKey('down', 'cross', 2), SiteKey('up', 'self', 0)):
            for q in (64, 256, 1024):
                assert c.wants_store(site, q) == jc.wants_store(site, q)
                assert (c.get_edit_fn(site, q) is None) == \
                    (jc.get_edit_fn(site, q) is None)
    with pytest.raises(ValueError):
        AttnCtrl('sow')


def test_new_modules_import_without_jax_yaml_or_pil():
    code = textwrap.dedent(f'''
        import sys
        for name in ('jax', 'flax', 'optax', 'yaml', 'PIL'):
            sys.modules[name] = None
        sys.path.insert(0, {str(ROOT)!r})
        import videoswap_torch.edlora
        import videoswap_torch.ops.fused_temporal
        import videoswap_torch.p2p.blend
        import videoswap_torch.p2p.edit
        import videoswap_torch.pipelines.videoswap_pipeline
        import videoswap_torch.utils.image
        loaded = [m for m in sys.modules
                  if m.split('.')[0] in ('jax', 'flax', 'optax', 'yaml',
                                         'PIL', 'videoswap_tpu')
                  and sys.modules[m] is not None]
        assert not loaded, loaded
        print('ok')
    ''')
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=120, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('ok')
