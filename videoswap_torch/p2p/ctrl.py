"""Attention control: a static identity for every spatial attention site
and one controller that decides, per site, whether to capture the attention
probabilities and whether to rewrite them (the port of
videoswap_tpu/p2p/ctrl.py).

Every spatial attention site of the U-Net has a `SiteKey`. An `AttnCtrl`
passed to `AnimateDiffUNet3DModel.forward(..., ctrl=...)` is asked, at each
site, for

- `wants_store(site, q_tokens)`: capture the pre-edit probabilities; the
  U-Net call then returns `(eps, store)` with `store` {site name: probs
  (B, heads, Sq, Sk)} (flax's `sow` into a mutable collection in the JAX
  package);
- `get_edit_fn(site, q_tokens)`: a function that rewrites the
  probabilities before the value contraction, or None.

Only sites with strictly fewer than `max_tokens` query tokens are tapped
(the reference's `<= 32 ** 2` guard on (h*w) maps is on the map size, so a
32x32 site with 1024 tokens is not): every larger site keeps the flash
kernel.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional


class SiteKey(NamedTuple):
    place: str    # 'down' | 'mid' | 'up'
    kind: str     # 'self' | 'cross'
    index: int    # per-(place, kind) position in the reference walk order

    @property
    def name(self) -> str:
        return f'{self.place}_{self.kind}_{self.index}'


class AttnCtrl:
    """mode: 'none' (kernels everywhere), 'store', 'edit' or 'store_edit'."""

    def __init__(self, mode: str = 'none',
                 store_filter: Optional[Callable[[SiteKey, int], bool]] = None,
                 edit_fn: Optional[Callable] = None,
                 state: Any = None,
                 max_tokens: int = 1024):
        if mode not in ('none', 'store', 'edit', 'store_edit'):
            raise ValueError(f'unknown AttnCtrl mode {mode!r}')
        self.mode = mode
        self.store_filter = store_filter
        self.edit_fn = edit_fn
        self.state = state
        self.max_tokens = max_tokens

    @property
    def stores(self) -> bool:
        return self.mode in ('store', 'store_edit')

    def wants_store(self, site: SiteKey, q_tokens: int) -> bool:
        if not self.stores or q_tokens >= self.max_tokens:
            return False
        return self.store_filter is None or self.store_filter(site, q_tokens)

    def get_edit_fn(self, site: SiteKey, q_tokens: int):
        if (self.mode not in ('edit', 'store_edit')
                or q_tokens >= self.max_tokens or self.edit_fn is None):
            return None
        return self.edit_fn(site, q_tokens, self.state)


NO_CTRL = AttnCtrl()
