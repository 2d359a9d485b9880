"""YAML config loading without pyyaml (the port of
videoswap_tpu/utils/config.py).

The port imports no pyyaml: it parses the subset of YAML that the
experiment configs under `options/` use, with pyyaml's `safe_load`
semantics (YAML 1.1 scalars):

- block mappings and sequences (a sequence may sit at its key's indent),
  with `- key: value` items;
- flow mappings and sequences (`{ type: Resize, size: [448, 768] }`),
  which may continue over several lines (the atlas configs' model blocks);
- plain, 'single-quoted' and "double-quoted" scalars on one line; `~`,
  `null` and an empty value are None; `yes`/`no`/`on`/`off`/`true`/`false`
  in any of pyyaml's three casings are booleans; ints (decimal, 0x, 0NN
  octal, 0b) and floats as pyyaml's resolver reads them (a float needs a
  dot: `5e-4` is a string, `!!float 5e-4` a float);
- the tag `!!float`;
- comments, whole-line and trailing (` # ...`).

Anything else (anchors and aliases, block scalars, values over several
lines, documents and directives, merge keys, complex keys, timestamps,
sexagesimal numbers, other tags, tabs in indentation) raises `ConfigError`
naming the line.
"""

from __future__ import annotations

import os
import re
from typing import Any

_NULL = {'', '~', 'null', 'Null', 'NULL'}
_BOOL = {**{w: True for w in ('yes', 'Yes', 'YES', 'true', 'True', 'TRUE',
                               'on', 'On', 'ON')},
         **{w: False for w in ('no', 'No', 'NO', 'false', 'False', 'FALSE',
                                'off', 'Off', 'OFF')}}
# pyyaml's implicit resolvers (resolver.py), YAML 1.1
_INT = re.compile(r'[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)'
                  r'|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+')
_FLOAT = re.compile(r'[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?'
                    r'|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*'
                    r'|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)')
_TIMESTAMP = re.compile(r'[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}'
                        r'(?:(?:[Tt]|[ \t]+)[0-9]{1,2}:.*)?')
_ESCAPES = {'0': '\0', 'a': '\a', 'b': '\b', 't': '\t', '\t': '\t',
            'n': '\n', 'v': '\v', 'f': '\f', 'r': '\r', 'e': '\x1b',
            ' ': ' ', '"': '"', '/': '/', '\\': '\\', 'N': '\x85',
            '_': '\xa0', 'L': ' ', 'P': ' '}
_HEX_ESCAPES = {'x': 2, 'u': 4, 'U': 8}


class ConfigError(ValueError):
    """A config outside the supported YAML subset, or malformed."""


def _int(text: str, line: int) -> int:
    v = text.replace('_', '')
    sign = -1 if v[0] == '-' else 1
    v = v.lstrip('+-')
    if ':' in v:
        raise ConfigError(f'line {line}: sexagesimal numbers are not in the '
                          'supported YAML subset')
    if v == '0':
        return 0
    if v.startswith('0b'):
        return sign * int(v[2:], 2)
    if v.startswith('0x'):
        return sign * int(v[2:], 16)
    if v.startswith('0'):
        return sign * int(v, 8)
    return sign * int(v)


def _float(text: str, line: int) -> float:
    v = text.replace('_', '').lower()
    if ':' in v:
        raise ConfigError(f'line {line}: sexagesimal numbers are not in the '
                          'supported YAML subset')
    sign = -1.0 if v.startswith('-') else 1.0
    if v.lstrip('+-') == '.inf':
        return sign * float('inf')
    if v == '.nan':
        return float('nan')
    return float(v)


def _plain(text: str, line: int) -> Any:
    """A plain scalar resolved as pyyaml's SafeLoader does."""
    if text in _NULL:
        return None
    if text in _BOOL:
        return _BOOL[text]
    if _INT.fullmatch(text):
        return _int(text, line)
    if _FLOAT.fullmatch(text):
        return _float(text, line)
    if _TIMESTAMP.fullmatch(text):
        raise ConfigError(f'line {line}: timestamps are not in the supported '
                          'YAML subset')
    if text == '<<':
        raise ConfigError(f'line {line}: merge keys are not in the supported '
                          'YAML subset')
    if text[0] in '&*!|>%@`':
        raise ConfigError(f'line {line}: {text[0]!r} starts a construct '
                          f'outside the supported YAML subset: {text!r}')
    return text


def _strip_comment(text: str) -> str:
    """The line without its comment: a '#' at the start or after
    whitespace, outside quotes."""
    quote = None
    i = 0
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    i += 1
                else:
                    quote = None
        elif quote == '"':
            if c == '\\':
                i += 1
            elif c == '"':
                quote = None
        elif c in '\'"' and (i == 0 or text[i - 1] in ' \t[{,:-?'):
            quote = c
        elif c == '#' and (i == 0 or text[i - 1] in ' \t'):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


class _Flow:
    """Recursive descent over one value: a flow collection or a scalar,
    quoted or plain, with an optional tag."""

    def __init__(self, text: str, line: int):
        self.s, self.i, self.line = text, 0, line

    def error(self, msg: str):
        return ConfigError(f'line {self.line}: {msg}: {self.s!r}')

    def skip(self) -> None:
        while self.i < len(self.s) and self.s[self.i] in ' \t\n':
            self.i += 1

    def value(self, in_flow: bool, key: bool = False) -> Any:
        self.skip()
        s = self.s
        if s.startswith('!!', self.i):
            m = re.compile(r'!!\w+').match(s, self.i)
            if m.group(0) != '!!float':
                raise self.error(f'the tag {m.group(0)} is not in the '
                                 'supported YAML subset')
            self.i = m.end()
            self.skip()
            return _float(self.plain_text(in_flow, key), self.line)
        if self.i >= len(s):
            return None
        c = s[self.i]
        if c == '[':
            return self.sequence()
        if c == '{':
            return self.mapping()
        if c in '\'"':
            return self.quoted()
        text = self.plain_text(in_flow, key)
        return _plain(text, self.line)

    def plain_text(self, in_flow: bool, key: bool) -> str:
        s, start = self.s, self.i
        while self.i < len(s):
            c = s[self.i]
            if in_flow and c in ',[]{}':
                break
            if c == ':' and (key or in_flow) and (
                    self.i + 1 == len(s) or s[self.i + 1] in ' \t\n,[]{}'):
                break
            self.i += 1
        return ' '.join(s[start:self.i].split())

    def quoted(self) -> str:
        s, q = self.s, self.s[self.i]
        self.i += 1
        out = []
        while True:
            if self.i >= len(s):
                raise self.error('unterminated quoted scalar')
            c = s[self.i]
            if c == q:
                if q == "'" and s[self.i + 1:self.i + 2] == "'":
                    out.append("'")
                    self.i += 2
                    continue
                self.i += 1
                return ''.join(out)
            if q == '"' and c == '\\':
                e = s[self.i + 1:self.i + 2]
                if e in _ESCAPES:
                    out.append(_ESCAPES[e])
                    self.i += 2
                elif e in _HEX_ESCAPES:
                    n = _HEX_ESCAPES[e]
                    out.append(chr(int(s[self.i + 2:self.i + 2 + n], 16)))
                    self.i += 2 + n
                else:
                    raise self.error(f'unknown escape \\{e}')
                continue
            out.append(c)
            self.i += 1

    def sequence(self) -> list:
        self.i += 1
        out = []
        while True:
            self.skip()
            if self.i >= len(self.s):
                raise self.error('unterminated flow sequence')
            if self.s[self.i] == ']':
                self.i += 1
                return out
            out.append(self.value(in_flow=True))
            self.skip()
            if self.i < len(self.s) and self.s[self.i] == ':':
                raise self.error('flow pairs in sequences are not in the '
                                 'supported YAML subset')
            self.separator(']')

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.skip()
            if self.i >= len(self.s):
                raise self.error('unterminated flow mapping')
            if self.s[self.i] == '}':
                self.i += 1
                return out
            k = self.value(in_flow=True, key=True)
            self.skip()
            v = None
            if self.i < len(self.s) and self.s[self.i] == ':':
                self.i += 1
                self.skip()
                if self.i < len(self.s) and self.s[self.i] not in ',}':
                    v = self.value(in_flow=True)
            out[_key(k, self.line)] = v
            self.separator('}')

    def separator(self, close: str) -> None:
        self.skip()
        if self.i < len(self.s) and self.s[self.i] == ',':
            self.i += 1
        elif self.i >= len(self.s) or self.s[self.i] != close:
            raise self.error(f'expected "," or {close!r}')

    def end(self) -> None:
        self.skip()
        if self.i != len(self.s):
            raise self.error('unexpected text after the value')


def _key(k: Any, line: int) -> Any:
    if isinstance(k, (list, dict)):
        raise ConfigError(f'line {line}: complex keys are not in the '
                          'supported YAML subset')
    return k


def _inline(text: str, line: int) -> Any:
    p = _Flow(text, line)
    v = p.value(in_flow=False)
    p.end()
    return v


def _balance(text: str) -> int:
    """Open brackets minus closed ones, outside quotes."""
    depth, quote = 0, None
    for i, c in enumerate(text):
        if quote:
            if c == quote and not (quote == '"' and text[i - 1] == '\\'):
                quote = None
        elif c in '\'"':
            quote = c
        elif c in '[{':
            depth += 1
        elif c in ']}':
            depth -= 1
    return depth


class _Lines:
    """The document as (line number, indent, text) of its non-blank,
    non-comment lines, comments stripped."""

    def __init__(self, text: str):
        self.items = []
        for n, raw in enumerate(text.splitlines(), 1):
            body = raw.lstrip(' ')
            if body.startswith('\t') and body.strip() and \
                    not body.strip().startswith('#'):
                raise ConfigError(f'line {n}: tabs in indentation')
            body = _strip_comment(body)
            if not body:
                continue
            if body.startswith(('---', '...', '%')):
                raise ConfigError(f'line {n}: documents and directives are '
                                  'not in the supported YAML subset')
            self.items.append([n, len(raw) - len(raw.lstrip(' ')), body])

    def __len__(self):
        return len(self.items)


def _map_entry(text: str, line: int):
    """(key, rest) when the line is a block mapping entry, else None."""
    if text.startswith('? '):
        raise ConfigError(f'line {line}: complex keys are not in the '
                          'supported YAML subset')
    if text[0] in '[{':
        return None
    p = _Flow(text, line)
    if text[0] in '\'"':
        k = p.quoted()
    else:
        raw = p.plain_text(in_flow=False, key=True)
        if not raw:
            return None
        k = _plain(raw, line)
    p.skip()
    if p.i < len(text) and text[p.i] == ':' and (
            p.i + 1 == len(text) or text[p.i + 1] == ' '):
        return _key(k, line), text[p.i + 1:].strip()
    return None


class _Parser:
    def __init__(self, text: str):
        self.lines = _Lines(text)
        self.i = 0

    def node(self, indent: int) -> Any:
        """The block node whose first line is the current one, at
        `indent`."""
        n, ind, text = self.lines.items[self.i]
        if text == '-' or text.startswith('- '):
            return self.sequence(ind)
        if _map_entry(text, n) is not None:
            return self.mapping(ind)
        self.i += 1
        return self.scalar(text, n)

    def scalar(self, text: str, n: int) -> Any:
        """A scalar on its line, or a flow collection, which may continue
        over the following lines."""
        if re.fullmatch(r'(!!\w+\s+)?[|>][-+0-9]*', text):
            raise ConfigError(f'line {n}: block scalars are not in the '
                              'supported YAML subset')
        if text[0] in '[{':
            while _balance(text) > 0 and self.i < len(self.lines):
                text += '\n' + self.lines.items[self.i][2]
                self.i += 1
        return _inline(text, n)

    def value_after(self, rest: str, n: int, indent: int,
                    seq_at_indent: bool) -> Any:
        """A mapping value: `rest` on the key's line, or the block below."""
        if rest:
            return self.scalar(rest, n)
        if self.i < len(self.lines):
            _, ind, text = self.lines.items[self.i]
            if ind > indent or (seq_at_indent and ind == indent and (
                    text == '-' or text.startswith('- '))):
                return self.node(ind)
        return None

    def mapping(self, indent: int) -> dict:
        out = {}
        while self.i < len(self.lines):
            n, ind, text = self.lines.items[self.i]
            if ind < indent:
                break
            if ind > indent:
                raise ConfigError(f'line {n}: unexpected indentation')
            entry = _map_entry(text, n)
            if entry is None:
                raise ConfigError(f'line {n}: expected "key: value"')
            self.i += 1
            key, rest = entry
            out[key] = self.value_after(rest, n, indent, seq_at_indent=True)
        return out

    def sequence(self, indent: int) -> list:
        out = []
        while self.i < len(self.lines):
            n, ind, text = self.lines.items[self.i]
            if ind < indent or not (text == '-' or text.startswith('- ')):
                break
            if ind > indent:
                raise ConfigError(f'line {n}: unexpected indentation')
            rest = text[1:].lstrip(' ')
            if not rest:
                self.i += 1
                out.append(self.value_after('', n, indent,
                                            seq_at_indent=False))
                continue
            # the item's content stands as a line of its own at its column
            self.lines.items[self.i] = [n, ind + len(text) - len(rest), rest]
            out.append(self.node(ind + len(text) - len(rest)))
        return out

    def document(self) -> Any:
        if not len(self.lines):
            return None
        out = self.node(self.lines.items[0][1])
        if self.i < len(self.lines):
            n = self.lines.items[self.i][0]
            raise ConfigError(f'line {n}: unexpected text after the '
                              'document\'s root node')
        return out


def parse_yaml(text: str) -> Any:
    """A YAML document of the supported subset -> plain Python values."""
    return _Parser(text).document()


def load_config(path: str) -> dict:
    with open(path, 'r') as f:
        try:
            cfg = parse_yaml(f.read())
        except ConfigError as e:
            raise ConfigError(f'{path}: {e}') from None
    if cfg is None:
        cfg = {}
    if not isinstance(cfg, dict):
        raise ValueError(f'Config root must be a mapping: {path}')
    return cfg


def cfg_get(cfg: dict, dotted: str, default: Any = None) -> Any:
    """Fetch `a.b.c` from nested dicts, returning `default` when missing."""
    node: Any = cfg
    for key in dotted.split('.'):
        if not isinstance(node, dict) or key not in node:
            return default
        node = node[key]
    return node


def resolve_path(root_path: str, p: str | None) -> str | None:
    """Paths in configs are relative to the repo/experiment root."""
    if p is None:
        return None
    if os.path.isabs(p):
        return p
    return os.path.join(root_path, p)
