"""Static attention-site geometry of the SD-1.5 3D U-Net (the port of
videoswap_tpu/p2p/sites.py).

The controllers address attention maps as ordered lists per (place, kind)
among the stored sites, those with strictly fewer than 32^2 query tokens
(reference attention_store.py:97). Everything here follows from the latent
size (h8, w8).
"""

from __future__ import annotations

from .ctrl import SiteKey

CTRL_MAX_TOKENS = 32 ** 2   # strictly-less threshold

# SD-1.5 structure: 3 cross-attention down blocks x 2 layers, 1 mid, 3
# cross-attention up blocks x 3 layers
_DOWN_LAYERS = 2
_UP_LAYERS = 3


def site_hw(site: SiteKey, h8: int, w8: int) -> tuple[int, int]:
    """Map size (h, w) of a spatial attention site at latent (h8, w8)."""
    if site.place == 'down':
        div = 2 ** (site.index // _DOWN_LAYERS)
    elif site.place == 'mid':
        div = 8
    else:                                    # up blocks 1..3 have attention
        div = 2 ** (3 - (site.index // _UP_LAYERS + 1))
    return h8 // div, w8 // div


def site_tokens(site: SiteKey, h8: int, w8: int) -> int:
    """Query-token count of a spatial attention site at latent (h8, w8)."""
    h, w = site_hw(site, h8, w8)
    return h * w


def all_sites(kind: str) -> list[SiteKey]:
    sites = [SiteKey('down', kind, i) for i in range(3 * _DOWN_LAYERS)]
    sites += [SiteKey('mid', kind, 0)]
    sites += [SiteKey('up', kind, i) for i in range(3 * _UP_LAYERS)]
    return sites


def stored_sites(place: str, kind: str, h8: int, w8: int) -> list[SiteKey]:
    """Sites of (place, kind), in walk order, with q-tokens < 32^2."""
    return [s for s in all_sites(kind)
            if s.place == place and site_tokens(s, h8, w8) < CTRL_MAX_TOKENS]


def controlled_sites(kind: str, h8: int, w8: int) -> list[SiteKey]:
    """Every site of `kind` with q-tokens < 32^2, in walk order."""
    return [s for s in all_sites(kind)
            if site_tokens(s, h8, w8) < CTRL_MAX_TOKENS]


def blend_sites(h8: int, w8: int) -> list[SiteKey]:
    """The cross-attention maps the spatial blender consumes: stored
    down_cross[2:4] + stored up_cross[:3] (reference spatial_blend.py:90).
    At production resolutions these share one map resolution."""
    return (stored_sites('down', 'cross', h8, w8)[2:4]
            + stored_sites('up', 'cross', h8, w8)[:3])
