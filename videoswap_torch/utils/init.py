"""Seeded random weights for runs without checkpoints."""

from __future__ import annotations

import torch
from torch import nn


@torch.no_grad()
def init_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Fill every parameter from `generator`, in `named_parameters` order:
    matrices and conv kernels ~ N(0, 1/fan_in) (flax's lecun-normal scale),
    embedding tables ~ N(0, 0.02), norm scales 1, biases 0. Unlike the JAX
    default init, the motion modules' proj_out is not zeroed, so the motion
    modules shape the output of a random-weight run."""
    for name, p in module.named_parameters():
        if name.endswith('embedding.weight'):
            p.normal_(0.0, 0.02, generator=generator)
        elif p.dim() >= 2:
            p.normal_(0.0, p[0].numel() ** -0.5, generator=generator)
        elif name.endswith('bias'):
            p.zero_()
        else:
            p.fill_(1.0)
