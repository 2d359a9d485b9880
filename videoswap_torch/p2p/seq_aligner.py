"""Token-sequence alignment between source and target prompts, host-side
numpy (a copy of videoswap_tpu/p2p/seq_aligner.py, which imports no JAX;
the port keeps its own).

Same behavior as the reference's seq_aligner (videoswap/utils/p2p_utils/
seq_aligner.py): a Needleman-Wunsch global alignment (gap 0, match 1,
mismatch -1) produces, for AttentionRefine, a per-target-token index into
the source tokens (`mapper`, -1 -> no counterpart) and an alpha vector
(1 where the target token has a source counterpart); for AttentionReplace
(equal-length prompts) a [77, 77] soft permutation matrix.
"""

from __future__ import annotations

import numpy as np

GAP, MATCH, MISMATCH = 0, 1, -1


def _align(x: list[int], y: list[int]) -> list[tuple[int, int]]:
    """Global alignment; returns (target_pos, source_pos|-1) pairs in order."""
    nx, ny = len(x), len(y)
    score = np.zeros((nx + 1, ny + 1), np.int32)
    score[0, 1:] = np.arange(1, ny + 1) * GAP
    score[1:, 0] = np.arange(1, nx + 1) * GAP
    # traceback: 1 = left (gap in x), 2 = up (gap in y), 3 = diagonal
    tb = np.zeros((nx + 1, ny + 1), np.int32)
    tb[0, 1:] = 1
    tb[1:, 0] = 2
    tb[0, 0] = 4
    for i in range(1, nx + 1):
        for j in range(1, ny + 1):
            left = score[i, j - 1] + GAP
            up = score[i - 1, j] + GAP
            diag = score[i - 1, j - 1] + (MATCH if x[i - 1] == y[j - 1]
                                          else MISMATCH)
            best = max(left, up, diag)
            score[i, j] = best
            tb[i, j] = 1 if best == left else (2 if best == up else 3)

    pairs = []
    i, j = nx, ny
    while i > 0 or j > 0:
        step = tb[i, j]
        if step == 3:
            i, j = i - 1, j - 1
            pairs.append((j, i))
        elif step == 1:
            j -= 1
            pairs.append((j, -1))
        elif step == 2:
            i -= 1
        else:
            break
    pairs.reverse()
    return pairs


def get_mapper(x: str, y: str, tokenizer,
               max_len: int = 77) -> tuple[np.ndarray, np.ndarray]:
    x_seq = _encode(tokenizer, x)
    y_seq = _encode(tokenizer, y)
    pairs = np.asarray(_align(x_seq, y_seq), np.int64)
    alphas = np.ones(max_len, np.float32)
    alphas[:len(pairs)] = (pairs[:, 1] != -1).astype(np.float32)
    mapper = np.zeros(max_len, np.int64)
    mapper[:len(pairs)] = pairs[:, 1]
    mapper[len(pairs):] = len(y_seq) + np.arange(max_len - len(y_seq))
    return mapper, alphas


def get_refinement_mapper(prompts: list[str], tokenizer, max_len: int = 77):
    """[P-1, 77] mappers + alphas from prompts[0] to each other prompt."""
    out_m, out_a = [], []
    for p in prompts[1:]:
        m, a = get_mapper(prompts[0], p, tokenizer, max_len)
        out_m.append(m)
        out_a.append(a)
    return np.stack(out_m), np.stack(out_a)


def _encode(tokenizer, text: str) -> list[int]:
    if hasattr(tokenizer, 'encode'):
        return list(tokenizer.encode(text))
    return list(tokenizer([text]).input_ids[0])


def get_replacement_mapper(prompts: list[str], tokenizer,
                           max_len: int = 77) -> np.ndarray:
    """[P-1, 77, 77] soft permutation for equal-word-count prompt pairs."""
    from .ptp_utils import get_word_inds
    x = prompts[0]
    mappers = []
    for y in prompts[1:]:
        wx, wy = x.split(' '), y.split(' ')
        if len(wx) != len(wy):
            raise ValueError(
                'attention replacement requires equal-length prompts, got '
                f'{len(wx)} vs {len(wy)} words')
        diff = [i for i in range(len(wy)) if wy[i] != wx[i]]
        src_inds = [get_word_inds(x, i, tokenizer) for i in diff]
        tgt_inds = [get_word_inds(y, i, tokenizer) for i in diff]
        m = np.zeros((max_len, max_len), np.float32)
        i = j = cur = 0
        while i < max_len and j < max_len:
            if cur < len(src_inds) and len(src_inds[cur]) and \
                    src_inds[cur][0] == i:
                s, t = src_inds[cur], tgt_inds[cur]
                if len(s) == len(t):
                    m[s, t] = 1.0
                else:
                    for tt in t:
                        m[s, tt] = 1.0 / len(t)
                i += len(s)
                j += len(t)
                cur += 1
            else:
                m[i, j] = 1.0
                i += 1
                j += 1
        mappers.append(m)
    return np.stack(mappers)
