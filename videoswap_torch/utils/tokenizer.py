"""Tokenizers: CLIP's byte-level BPE, read from a pretrained directory's
`tokenizer/`, and the deterministic stand-in for weightless runs and tests
(the port of videoswap_tpu/utils/tokenizer.py, which loads
`transformers.CLIPTokenizer`: the port imports no transformers).

`CLIPBPETokenizer` gives the ids of transformers' slow `CLIPTokenizer`
(without ftfy): text cleaned, CJK characters spaced, NFC-normalised and
lowercased; split into words by CLIP's pattern; each word's UTF-8 bytes
mapped to GPT-2's printable characters and merged by `merges.txt`'s ranks.
Tokens added with `add_tokens` (ED-LoRA's `<catA1_0>`) match
case-sensitively, longest first, before any of that. CLIP's pattern needs
the `regex` module's `\\p{L}` and `\\p{N}`; here letters are `[^\\W\\d_]`
and digits `\\d`, which differ only on numeric characters that are not
decimal digits (`²`, `½`, `Ⅻ`: letters here, single digits there).

`HashTokenizer` gives the same ids as the JAX package's (crc32 word
hashes, CLIP bos/eos ids, 77-token padding), so a prompt gives the same ids
in both packages.
"""

from __future__ import annotations

import json
import os
import re
import unicodedata
import zlib

import numpy as np

_CLIP_PAT = re.compile(r"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve"
                       r"|'m|'ll|'d|[^\W\d_]+|\d|(?:[^\s\w]|_)+",
                       re.IGNORECASE)
# merges past this rank are not read (transformers' CLIPTokenizer)
_MAX_MERGES = 49152 - 256 - 2


class _Encoding:
    def __init__(self, input_ids):
        self.input_ids = input_ids


def _bytes_to_unicode() -> dict[int, str]:
    """GPT-2's byte -> printable character table."""
    bs = (list(range(ord('!'), ord('~') + 1))
          + list(range(ord('¡'), ord('¬') + 1))
          + list(range(ord('®'), ord('ÿ') + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
            or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
            or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
            or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _basic_clean(text: str) -> str:
    """transformers' BasicTokenizer as CLIPTokenizer configures it:
    control characters dropped, whitespace made spaces, CJK characters
    spaced, NFC, lowercase, words joined by one space."""
    out = []
    for ch in text:
        cp = ord(ch)
        if ch in ' \t\n\r' or unicodedata.category(ch) == 'Zs':
            out.append(' ')
        elif cp == 0 or cp == 0xFFFD or unicodedata.category(ch) in (
                'Cc', 'Cf'):
            continue
        elif _is_cjk(cp):
            out.append(f' {ch} ')
        else:
            out.append(ch)
    text = unicodedata.normalize('NFC', ''.join(out))
    return ' '.join(w.lower() for w in text.split())


class CLIPBPETokenizer:
    """CLIP's tokenizer from `vocab.json` and `merges.txt`, with the
    surface the pipelines use: `__call__` (padding, max_length,
    truncation), `encode`, `decode`, `add_tokens`,
    `convert_tokens_to_ids`, `model_max_length`."""

    bos_token, eos_token = '<|startoftext|>', '<|endoftext|>'
    unk_token = pad_token = eos_token

    def __init__(self, vocab_file: str, merges_file: str,
                 model_max_length: int = 77):
        with open(vocab_file, encoding='utf-8') as f:
            self.encoder: dict[str, int] = json.load(f)
        self.decoder = {v: k for k, v in self.encoder.items()}
        with open(merges_file, encoding='utf-8') as f:
            merges = f.read().strip().split('\n')[1:_MAX_MERGES + 1]
        self.bpe_ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.byte_encoder = _bytes_to_unicode()
        self.byte_decoder = {v: k for k, v in self.byte_encoder.items()}
        self.model_max_length = model_max_length
        self._added: dict[str, int] = {}
        self._added_pat = None
        self._cache = {t: t for t in (self.bos_token, self.eos_token)}

    @classmethod
    def from_dir(cls, tok_dir: str) -> 'CLIPBPETokenizer':
        max_len = 77
        cfg = os.path.join(tok_dir, 'tokenizer_config.json')
        if os.path.isfile(cfg):
            with open(cfg) as f:
                max_len = int(json.load(f).get('model_max_length', 77))
        return cls(os.path.join(tok_dir, 'vocab.json'),
                   os.path.join(tok_dir, 'merges.txt'), max_len)

    @property
    def vocab_size(self) -> int:
        return len(self.encoder)

    @property
    def bos_token_id(self) -> int:
        return self.encoder[self.bos_token]

    @property
    def eos_token_id(self) -> int:
        return self.encoder[self.eos_token]

    pad_token_id = eos_token_id

    def __len__(self):
        return len(self.encoder) + len(self._added)

    def add_tokens(self, tokens) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        n = 0
        for t in tokens:
            if t not in self._added and t not in self.encoder:
                self._added[t] = len(self)
                n += 1
        # leftmost, then longest match, case-sensitive
        names = sorted(self._added, key=len, reverse=True)
        self._added_pat = re.compile('|'.join(map(re.escape, names)))
        return n

    def convert_tokens_to_ids(self, token):
        if isinstance(token, (list, tuple)):
            return [self.convert_tokens_to_ids(t) for t in token]
        if token in self._added:
            return self._added[token]
        return self.encoder.get(token, self.encoder[self.unk_token])

    def _bpe(self, token: str) -> list[str]:
        if token in self._cache:
            return self._cache[token].split(' ')
        word = tuple(token[:-1]) + (token[-1] + '</w>',)
        pairs = set(zip(word, word[1:]))
        if not pairs:
            return [token + '</w>']
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, np.inf))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            merged, i = [], 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
            if len(word) == 1:
                break
            pairs = set(zip(word, word[1:]))
        self._cache[token] = ' '.join(word)
        return list(word)

    def _tokenize_plain(self, text: str) -> list[str]:
        out = []
        for word in _CLIP_PAT.findall(_basic_clean(text)):
            word = ''.join(self.byte_encoder[b] for b in word.encode('utf-8'))
            out.extend(self._bpe(word))
        return out

    def tokenize(self, text: str) -> list[str]:
        """Added tokens as they are, the text between them through BPE."""
        if self._added_pat is None:
            return self._tokenize_plain(text)
        out, pos = [], 0
        for m in self._added_pat.finditer(text):
            out.extend(self._tokenize_plain(text[pos:m.start()]))
            out.append(m.group(0))
            pos = m.end()
        out.extend(self._tokenize_plain(text[pos:]))
        return out

    def encode(self, text: str) -> list[int]:
        """bos, the text's ids, eos (no padding, no truncation)."""
        return ([self.bos_token_id]
                + self.convert_tokens_to_ids(self.tokenize(text))
                + [self.eos_token_id])

    def decode(self, ids) -> str:
        tokens = [self.decoder.get(int(i)) for i in ids]
        added = {v: k for k, v in self._added.items()}
        parts, run = [], []
        for i, tok in zip(ids, tokens):
            if tok is None:
                if run:
                    parts.append(self._detokenize(run))
                    run = []
                parts.append(added[int(i)])
            else:
                run.append(tok)
        if run:
            parts.append(self._detokenize(run))
        return ' '.join(p for p in parts if p)

    def _detokenize(self, tokens: list[str]) -> str:
        data = bytearray(self.byte_decoder[c] for c in ''.join(tokens))
        return data.decode('utf-8', errors='replace').replace(
            '</w>', ' ').strip()

    def __call__(self, text, padding='max_length', max_length=None,
                 truncation=True, return_tensors=None):
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        out = []
        for t in text:
            ids = self.convert_tokens_to_ids(self.tokenize(t))
            if truncation:
                ids = ids[:max_length - 2]
            ids = [self.bos_token_id] + ids + [self.eos_token_id]
            if padding == 'max_length':
                ids = ids + [self.pad_token_id] * (max_length - len(ids))
            out.append(ids)
        if padding != 'max_length':
            return _Encoding(out)
        return _Encoding(np.asarray(out, dtype=np.int64))


class HashTokenizer:
    model_max_length = 77
    bos_token_id = 49406
    eos_token_id = 49407

    def __init__(self, vocab_size: int = 49408):
        self.vocab_size = vocab_size
        self._added: dict[str, int] = {}

    def add_tokens(self, tokens) -> int:
        if isinstance(tokens, str):
            tokens = [tokens]
        for t in tokens:
            if t not in self._added:
                self._added[t] = self.vocab_size + len(self._added)
        return len(tokens)

    def __len__(self):
        return self.vocab_size + len(self._added)

    def convert_tokens_to_ids(self, token: str) -> int:
        if token in self._added:
            return self._added[token]
        # crc32, not hash(): str hashes are salted per process
        return 2 + (zlib.crc32(token.encode('utf-8')) % (self.vocab_size - 3))

    def _word_ids(self, text: str) -> list[int]:
        # added tokens match case-sensitively before lowercasing, as
        # transformers' AddedToken splitting does
        words = re.findall(r'<[^>]+>|\w+|[^\w\s]', text)
        return [self._added[w] if w in self._added
                else self.convert_tokens_to_ids(w.lower()) for w in words]

    def __call__(self, text, padding='max_length', max_length=None,
                 truncation=True, return_tensors=None):
        if isinstance(text, str):
            text = [text]
        max_length = max_length or self.model_max_length
        out = []
        for t in text:
            ids = [self.bos_token_id] + self._word_ids(t)
            ids = ids[:max_length - 1] + [self.eos_token_id]
            if padding == 'max_length':
                ids = ids + [self.eos_token_id] * (max_length - len(ids))
            out.append(ids)
        return _Encoding(np.asarray(out, dtype=np.int32))


def load_tokenizer(pretrained_path: str | None):
    """CLIP's tokenizer from `<pretrained_path>/tokenizer` when it is
    there, else the hash stand-in."""
    if pretrained_path:
        tok_dir = os.path.join(pretrained_path, 'tokenizer')
        if os.path.isdir(tok_dir):
            return CLIPBPETokenizer.from_dir(tok_dir)
    return HashTokenizer()
