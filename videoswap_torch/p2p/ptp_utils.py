"""Prompt-to-prompt helpers: word -> token indices and the per-step
cross-replacement alpha schedule, host-side numpy (a copy of
videoswap_tpu/p2p/ptp_utils.py, with the port's ED-LoRA prompt binding).

Parity: the reference VideoSwap's
videoswap/utils/p2p_utils/ptp_utils.py:62-135, including the ED-LoRA
expansion: when the tokenizer carries a
`new_concept_cfg`, `<concept>` occurrences are expanded to their layer-0
token list before indexing (reference :67-69).
"""

from __future__ import annotations

from typing import Union

import numpy as np


def _expand_concepts(text: str, new_concept_cfg: dict | None) -> str:
    if not new_concept_cfg:
        return text
    from videoswap_torch.edlora import bind_concept_prompt
    return bind_concept_prompt([text], new_concept_cfg)[0]


def get_word_inds(text: str, word_place: Union[str, int],
                  tokenizer) -> np.ndarray:
    """Indices (in the padded token sequence, BOS at 0) of the word(s)."""
    cfg = getattr(tokenizer, 'new_concept_cfg', None)
    if cfg and isinstance(word_place, str):
        text = _expand_concepts(text, cfg)
        word_place = _expand_concepts(word_place, cfg)

    split_text = text.split(' ')
    if isinstance(word_place, str):
        places = [i for i, w in enumerate(split_text) if w == word_place]
    else:
        places = [word_place]
    out: list[int] = []
    if places:
        if hasattr(tokenizer, 'decode'):
            ids = tokenizer.encode(text)
            words_encode = [tokenizer.decode([t]).strip('#') for t in
                            ids][1:-1]
        else:  # HashTokenizer: one token per word
            words_encode = split_text
        cur_len, ptr = 0, 0
        for i, tok in enumerate(words_encode):
            cur_len += len(tok)
            if ptr in places:
                out.append(i + 1)
            if ptr < len(split_text) and cur_len >= len(split_text[ptr]):
                ptr += 1
                cur_len = 0
    return np.asarray(out, np.int64)


def update_alpha_time_word(alpha: np.ndarray, bounds, prompt_ind: int,
                           word_inds=None) -> np.ndarray:
    if isinstance(bounds, (int, float)):
        bounds = (0.0, float(bounds))
    start = int(bounds[0] * alpha.shape[0])
    end = int(bounds[1] * alpha.shape[0])
    if word_inds is None:
        word_inds = np.arange(alpha.shape[2])
    alpha[:start, prompt_ind, word_inds] = 0
    alpha[start:end, prompt_ind, word_inds] = 1
    alpha[end:, prompt_ind, word_inds] = 0
    return alpha


def get_time_words_attention_alpha(prompts: list[str], num_steps: int,
                                   cross_replace_steps, tokenizer,
                                   max_num_words: int = 77) -> np.ndarray:
    """[steps+1, P-1, 1, 1, 77] per-step 0/1 gate for cross replacement."""
    if not isinstance(cross_replace_steps, dict):
        cross_replace_steps = {'default_': cross_replace_steps}
    if 'default_' not in cross_replace_steps:
        cross_replace_steps['default_'] = (0.0, 1.0)

    alpha = np.zeros((num_steps + 1, len(prompts) - 1, max_num_words),
                     np.float32)
    for i in range(len(prompts) - 1):
        alpha = update_alpha_time_word(
            alpha, cross_replace_steps['default_'], i)
    for key, bounds in cross_replace_steps.items():
        if key == 'default_':
            continue
        for i in range(1, len(prompts)):
            inds = get_word_inds(prompts[i], key, tokenizer)
            if len(inds) > 0:
                alpha = update_alpha_time_word(alpha, bounds, i - 1, inds)
    return alpha.reshape(num_steps + 1, len(prompts) - 1, 1, 1,
                         max_num_words)
