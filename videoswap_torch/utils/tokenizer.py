"""Deterministic stand-in tokenizer for weightless runs and tests.

The same ids as the JAX package's `HashTokenizer` (crc32 word hashes, CLIP
bos/eos ids, 77-token padding), so a prompt gives the same ids in both
packages. A real `CLIPTokenizer` can be passed to the pipeline instead.
"""

from __future__ import annotations

import re
import zlib

import numpy as np


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

        class R:
            input_ids = np.asarray(out, dtype=np.int32)
        return R()
