"""Prompt-to-prompt attention control (the port of videoswap_tpu/p2p)."""

from .ctrl import NO_CTRL, AttnCtrl, SiteKey

__all__ = ['NO_CTRL', 'AttnCtrl', 'SiteKey']
