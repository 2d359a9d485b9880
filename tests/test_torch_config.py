"""The port's YAML loader (videoswap_torch/utils/config.py, no pyyaml)
against `yaml.safe_load`: every config under options/ loads to the same
values, the scalar rules of YAML 1.1 agree, and what lies outside the
supported subset raises with its line number."""

import glob
import math
import os

import pytest
import yaml

from videoswap_torch.utils.config import (ConfigError, cfg_get, load_config,
                                          parse_yaml, resolve_path)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTIONS = sorted(os.path.relpath(p, ROOT) for p in glob.glob(
    os.path.join(ROOT, 'options', '**', '*.yml'), recursive=True))


def test_the_corpus_is_all_there():
    assert len(OPTIONS) == 75


@pytest.mark.parametrize('path', OPTIONS)
def test_load_config_equals_yaml_safe_load(path):
    with open(os.path.join(ROOT, path)) as f:
        ref = yaml.safe_load(f)
    assert load_config(os.path.join(ROOT, path)) == ref


@pytest.mark.parametrize('text', [
    'a: 1', 'a: 010', 'a: 0x1F', 'a: 0b101', 'a: 1_000', 'a: -7', 'a: +3',
    'a: 1.5e-3', 'a: 5e-4', 'a: !!float 5e-4', 'a: !!float 50', 'a: .5',
    'a: 1.', 'a: -.inf',
    'a: yes', 'a: No', 'a: ON', 'a: off', 'a: True', "a: 'no'", 'a: "yes"',
    'a: ~', 'a: null', 'a:', "a: ''", 'a: "x\\ty\\u00e9"', "a: 'it''s'",
    'a: b # c', "a: 'b # c'", 'a: b#c', 'a: x:y', 'a: http://x/y',
    'a: man -> <hermione1> <hermione2>',
    'a: [1, [2, 3], {b: c, d: [e]}]', 'a: { type: Resize, size: [448, 768]}',
    'a: [a b, "c, d"]', 'a: {x: , y}', 'a: [\n 1,\n 2]', 'a: []', 'a: {}',
    'a:\n- 1\n- 2', 'a:\n  - b: 1\n    c: [2]\n  - 3', 'a:\n  b',
    '- a\n- - b\n  - c', "'a b': 1\n\"c\": 2", 'a:\n  b:\n    c: 1\n  d: 2',
    '# only a comment', '',
])
def test_scalars_and_collections_like_pyyaml(text):
    ref = yaml.safe_load(text)
    got = parse_yaml(text)
    assert got == ref and type(got) is type(ref)
    if isinstance(ref, dict) and isinstance(ref.get('a'), float) \
            and math.isnan(ref['a']):
        assert math.isnan(got['a'])


@pytest.mark.parametrize('text, line, what', [
    ('a: 1\nb: &x 2', 2, "'&'"),
    ('a: 1\nb: *x', 2, "'*'"),
    ('a: |\n  text', 1, 'block scalars'),
    ('a: >-\n  text', 1, 'block scalars'),
    ('---\na: 1', 1, 'documents'),
    ('a: 1\nb: 2001-12-14', 2, 'timestamps'),
    ('a: 1:20', 1, 'sexagesimal'),
    ('a: !foo x', 1, "'!'"),
    ('a: !!binary eA==', 1, 'tag'),
    ('a: !!str 12', 1, 'tag'),
    ('a: [1,', 1, 'unterminated'),
    ('a:\n  b\n  c', 3, 'indentation'),
    ('a: "b\n  c"', 1, 'unterminated'),
    ('a:\n\tb: 1', 2, 'tabs'),
    ('? a\n: b', 1, 'complex keys'),
    ('a: 1\n<<: {b: 1}', 2, 'merge keys'),
    ('a: [1, 2', 1, 'expected ","'),
    ('a: 1\n  b: 2', 2, 'indentation'),
])
def test_outside_the_subset_raises_with_the_line(tmp_path, text, line, what):
    p = tmp_path / 'bad.yml'
    p.write_text(text)
    with pytest.raises(ConfigError) as e:
        load_config(str(p))
    assert f'line {line}:' in str(e.value) and what in str(e.value)
    assert str(p) in str(e.value)


def test_cfg_get_and_resolve_path():
    cfg = {'a': {'b': {'c': 1}}, 'x': None}
    assert cfg_get(cfg, 'a.b.c') == 1
    assert cfg_get(cfg, 'a.b.z', 'd') == 'd'
    assert cfg_get(cfg, 'x.y') is None
    assert resolve_path('/r', 'p/q') == '/r/p/q'
    assert resolve_path('/r', '/abs') == '/abs'
    assert resolve_path('/r', None) is None
