"""Parity of the port's CLIP scorer (videoswap_torch/models/clip_vision.py,
`builders.build_clip_scorer`, the swap CLI's `make_clip_scorer`) with the
JAX package, fp32 on the CPU, on a tiny CLIP (a 28x28 ViT with 14x14
patches, width 32, two layers a tower, projection 16) with numpy-seeded
weights.

Checked: `preprocess_frames` against the JAX package's (the triangle taps
against `jax.image.resize`'s antialiased bilinear: 1e-4 in normalised
units, fp32 sums in another order); both towers' outputs, the embeddings
and the score (2e-5); a transformers-layout `pytorch_model.bin` written
from those weights, loaded by `build_clip_scorer` in both packages; the CLI
scorers' scores of the same uint8 frames and prompt (1e-3 on the 0-100
scale, the preprocessing's difference carried through the tower); a
missing `clip_model_path` directory giving a warning and no scorer.
"""

import importlib.util
import json
import logging
import math
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.fixtures.logging_guard import jax_logger_as_found  # noqa: F401
from videoswap_tpu.models import converters as jconverters
from videoswap_tpu.models.clip_text import CLIPTextConfig as JTextConfig
from videoswap_tpu.models.clip_vision import (
    CLIPVisionConfig as JVisionConfig, CLIPWithProjection as JCLIP,
    preprocess_frames as j_preprocess_frames)
from videoswap_tpu.utils.tokenizer import HashTokenizer as JHashTokenizer
from videoswap_torch.builders import build_clip_scorer
from videoswap_torch.models.clip_text import CLIPTextConfig
from videoswap_torch.models.clip_vision import (CLIPVisionConfig,
                                                CLIPWithProjection,
                                                preprocess_frames)
from videoswap_torch.models.converters import jax_params_to_state_dict
from videoswap_torch.test import make_clip_scorer
from videoswap_torch.utils.tokenizer import HashTokenizer

ROOT = Path(__file__).resolve().parents[1]
VISION = dict(image_size=28, patch_size=14, hidden_size=32, num_layers=2,
              num_heads=4, intermediate_size=64, projection_dim=16)
TEXT = dict(vocab_size=49408, hidden_size=32, num_layers=2, num_heads=4,
            max_position_embeddings=77, intermediate_size=64)
# the same sizes as a transformers CLIPModel config.json
CONFIG_JSON = {
    'projection_dim': 16,
    'vision_config': {'image_size': 28, 'patch_size': 14, 'hidden_size': 32,
                      'num_hidden_layers': 2, 'num_attention_heads': 4,
                      'intermediate_size': 64},
    'text_config': {'vocab_size': 49408, 'hidden_size': 32,
                    'num_hidden_layers': 2, 'num_attention_heads': 4,
                    'max_position_embeddings': 77, 'intermediate_size': 64}}


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    """JAX params from a numpy seed, the port's model holding them, and a
    CLIP directory with them as transformers' CLIPModel keys."""
    jmodel = JCLIP(vision_cfg=JVisionConfig(**VISION),
                   text_cfg=JTextConfig(**TEXT))
    shapes = jax.eval_shape(jmodel.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 28, 28, 3)),
                            jnp.zeros((1, 77), jnp.int32))
    rs = np.random.RandomState(0)

    def leaf(path, x):
        name = str(getattr(path[-1], 'key', path[-1]))
        if name == 'kernel':
            v = rs.randn(*x.shape) / math.sqrt(np.prod(x.shape[:-1]))
        elif name == 'scale':
            v = 1.0 + 0.1 * rs.randn(*x.shape)
        elif name == 'bias':
            v = 0.1 * rs.randn(*x.shape)
        else:
            v = 0.5 * rs.randn(*x.shape)
        return v.astype(np.float32)

    params = {'params': jax.tree_util.tree_map_with_path(
        leaf, shapes['params'])}
    sd = jax_params_to_state_dict(params)
    model = CLIPWithProjection(CLIPVisionConfig(**VISION),
                               CLIPTextConfig(**TEXT)).eval()
    model.load_state_dict(sd, strict=True)
    d = tmp_path_factory.mktemp('clip')
    (d / 'config.json').write_text(json.dumps(CONFIG_JSON))
    hf = {jconverters.clip_full_key_map(k): v for k, v in sd.items()}
    hf['logit_scale'] = torch.tensor(4.6)
    hf['text_model.embeddings.position_ids'] = torch.arange(77)[None]
    torch.save(hf, d / 'pytorch_model.bin')
    return jmodel, params, model, d


@pytest.mark.parametrize('shape', [(2, 64, 96, 3), (1, 20, 24, 3),
                                   (1, 448, 768, 3)])
def test_preprocess_matches_jax(shape):
    frames = np.random.RandomState(1).rand(*shape).astype(np.float32)
    out = preprocess_frames(frames)
    ref = np.asarray(j_preprocess_frames(frames))
    assert tuple(out.shape) == (shape[0], 224, 224, 3)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-4)


def test_towers_and_score_match_jax(clip):
    jmodel, params, model, _ = clip
    rs = np.random.RandomState(2)
    pix = rs.randn(3, 28, 28, 3).astype(np.float32)
    ids = rs.randint(1, 49407, (3, 77)).astype(np.int32)
    ids[:, 9] = 49407                                  # the EOT, pooled

    def everything(m, x, i):
        hidden, pooled = m.vision_model(x)
        return hidden, pooled, m.image_embeds(x), m.text_embeds(i), m(x, i)

    ref = jax.jit(lambda p, x, i: jmodel.apply(p, x, i, method=everything))(
        params, pix, ids)
    with torch.no_grad():
        x, i = torch.from_numpy(pix), torch.from_numpy(ids)
        ours = (*model.vision_model(x), model.image_embeds(x),
                model.text_embeds(i), model(x, i))
    for name, a, b in zip(('hidden', 'pooled', 'image_embeds',
                           'text_embeds', 'score'), ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=2e-5,
                                   atol=2e-5, err_msg=name)
    assert float(ours[-1].max()) > 0.0          # not every score clipped


def test_build_clip_scorer_loads_the_transformers_file(clip):
    """The directory's config.json sizes the model and every tensor of its
    CLIPModel-keyed file loads (the logit scale and position ids aside);
    the JAX package's loader reads the same file to the same weights."""
    _, params, model, d = clip
    scorer = build_clip_scorer(str(d), device='cpu')
    assert scorer.vision_cfg == CLIPVisionConfig(**VISION)
    assert scorer.text_cfg == CLIPTextConfig(**TEXT)
    for k, v in model.state_dict().items():
        assert torch.equal(scorer.state_dict()[k], v), k
    jsd = torch.load(d / 'pytorch_model.bin', weights_only=True)
    loaded = jconverters.convert_clip_full(jsd, params['params'])
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(loaded),
            jax.tree_util.tree_leaves(params['params'])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=str(path))


def test_cli_scorer_matches_jax(clip):
    """`make_clip_scorer` of the swap CLI against test.py's
    `_make_clip_scorer` on the same directory, frames and prompt (ids past
    the vocabulary clamped to its last, the EOT pooled by argmax)."""
    _, _, _, d = clip
    spec = importlib.util.spec_from_file_location('jax_swap_cli',
                                                  ROOT / 'test.py')
    jcli = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jcli)
    opt = {'path': {'clip_model_path': d.name}}
    jtok, ttok = JHashTokenizer(), HashTokenizer()
    for tok in (jtok, ttok):
        tok.add_tokens(['<catA1>'])          # id 49408: past the vocabulary
    jscore = jcli._make_clip_scorer(opt, str(d.parent), jtok)
    tscore = make_clip_scorer(opt, str(d.parent), ttok, 'cpu')
    frames = np.random.RandomState(3).randint(0, 256, (2, 64, 96, 3),
                                              dtype=np.uint8)
    scores = []
    for prompt in ('a cat sitting on a wooden floor', 'a <catA1> dog'):
        a, b = tscore(frames, prompt), jscore(frames, prompt)
        assert abs(a - b) <= 1e-3, (prompt, a, b)
        scores.append(a)
    assert max(scores) > 1.0, scores            # not every cosine clipped


def test_missing_clip_directory_warns_and_scores_nothing(tmp_path, caplog):
    opt = {'path': {'clip_model_path': 'no_such_dir'}}
    with caplog.at_level(logging.WARNING):
        assert make_clip_scorer(opt, str(tmp_path), HashTokenizer(),
                                'cpu') is None
    assert 'no_such_dir missing; skipping CLIP scores' in caplog.text
    assert make_clip_scorer({'path': {}}, str(tmp_path), HashTokenizer(),
                            'cpu') is None
