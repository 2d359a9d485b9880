"""The device a CLI of the port runs on."""

from __future__ import annotations

import torch


def cli_device(device=None) -> torch.device:
    """`device` (a `--device` value), else 'cuda', which must be there: the
    CLIs run on the card unless asked for the CPU."""
    device = torch.device(device or 'cuda')
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the '
                           'CPU')
    return device
