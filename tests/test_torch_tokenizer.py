"""The port's CLIP BPE tokenizer (videoswap_torch/utils/tokenizer.py, no
transformers) against `transformers.CLIPTokenizer` on a generated
vocabulary with merges (chip_smoke.clip_vocab, the card run's own, learnt
from the shipped configs' texts): the ids of every `prompt`, `replace` and
negative prompt of the configs under options/, with ED-LoRA's mixed-case
concept tokens added, `encode` and the one-token `decode`s that
prompt-to-prompt's word indexing reads."""

import glob
import importlib.util
import json
import os
from pathlib import Path

import numpy as np
import pytest
import yaml

from videoswap_torch.utils.tokenizer import (CLIPBPETokenizer, HashTokenizer,
                                             load_tokenizer)

ROOT = Path(__file__).resolve().parents[1]
CONCEPTS = [f'<catA1_{i}>' for i in range(16)] + ['<<hermione1>_3>',
                                                  '<Batman2_0>']
EXTRA = ['a <catA1_0> and <catA1_12> sat', 'a catA1 on grass',
         "it's a CAT's toy, isn't it?", 'Héllo wörld 中文 x__y 42 1.5',
         'a\tb\n c  d', '<|startoftext|> x <|endoftext|>', '', 'a ' * 90]


def _texts():
    out = set()

    def walk(x):
        if isinstance(x, dict):
            for k, v in x.items():
                if k in ('prompt', 'replace', 'replace_other',
                         'negative_prompt') and isinstance(v, str):
                    out.add(v)
                walk(v)
        elif isinstance(x, list):
            for v in x:
                walk(v)
    for p in glob.glob(str(ROOT / 'options' / '**' / '*.yml'),
                       recursive=True):
        with open(p) as f:
            walk(yaml.safe_load(f))
    return sorted(out)


TEXTS = _texts()


@pytest.fixture(scope='module')
def tokenizers(tmp_path_factory):
    from transformers import CLIPTokenizer
    path = ROOT / 'chip_smoke.py'
    spec = importlib.util.spec_from_file_location('chip_smoke', path)
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    root = tmp_path_factory.mktemp('sd')
    tok_dir = root / 'tokenizer'
    tok_dir.mkdir()
    vocab, merges = cs.clip_vocab(TEXTS[::2], merges=600)
    (tok_dir / 'vocab.json').write_text(json.dumps(vocab))
    (tok_dir / 'merges.txt').write_text(merges)
    (tok_dir / 'tokenizer_config.json').write_text(
        json.dumps({'model_max_length': 77}))
    hf, port = CLIPTokenizer.from_pretrained(str(tok_dir)), \
        load_tokenizer(str(root))
    assert hf.add_tokens(CONCEPTS) == port.add_tokens(CONCEPTS) \
        == len(CONCEPTS)
    return hf, port


def test_the_texts_are_there():
    assert len(TEXTS) > 100


def test_load_tokenizer_reads_the_directory(tokenizers, tmp_path):
    hf, port = tokenizers
    assert isinstance(port, CLIPBPETokenizer)
    assert len(port) == 49408 + len(CONCEPTS) == len(hf)
    assert port.model_max_length == 77
    assert (port.bos_token_id, port.eos_token_id) == (49406, 49407)
    assert isinstance(load_tokenizer(str(tmp_path)), HashTokenizer)
    assert isinstance(load_tokenizer(None), HashTokenizer)


@pytest.mark.parametrize('part', range(4))
def test_ids_equal_transformers(tokenizers, part):
    hf, port = tokenizers
    texts = (TEXTS + EXTRA + [t.replace('cat', 'catA1_0') for t in TEXTS]
             )[part::4]
    for t in texts:
        ref = hf([t], padding='max_length', max_length=77,
                 truncation=True).input_ids
        out = port([t], padding='max_length', max_length=77,
                   truncation=True).input_ids
        assert out.tolist() == ref, t
        assert port.encode(t) == hf.encode(t), t


def test_concept_tokens_match_before_lowercasing(tokenizers):
    hf, port = tokenizers
    ids = [port.convert_tokens_to_ids(n) for n in CONCEPTS]
    assert ids == [hf.convert_tokens_to_ids(n) for n in CONCEPTS]
    assert min(ids) == 49408 and len(set(ids)) == len(ids)
    enc = port.encode('a <catA1_5> on grass')
    assert ids[5] in enc
    assert not set(ids) & set(port.encode('a catA1 on grass'))


def test_decode_equals_transformers(tokenizers):
    """Word indexing (p2p/ptp_utils.get_word_inds) decodes one id at a
    time; whole sequences too."""
    hf, port = tokenizers
    for t in TEXTS[:40] + EXTRA[:4]:
        ids = hf.encode(t)
        assert port.decode(ids) == hf.decode(ids), t
        for i in ids:
            assert port.decode([i]) == hf.decode([i]), (t, i)


def test_word_indices_equal_transformers(tokenizers):
    from videoswap_torch.p2p.ptp_utils import get_word_inds
    hf, port = tokenizers
    for t, w in (('a man is walking in front of trees and grass', 'man'),
                 ('a kitten with a red bell around its neck', 'bell'),
                 ('a photo of a <catA1_0> on the floor', '<catA1_0>')):
        np.testing.assert_array_equal(get_word_inds(t, w, port),
                                      get_word_inds(t, w, hf))
