"""Sharded inference on torch.distributed (the port of
videoswap_tpu/parallel/): a (dp, sp, tp) mesh of process groups
(mesh.py), the layout rules and the collectives (sharding.py), and the
multi-process scaffolding (dist.py)."""

from .mesh import Mesh, make_mesh
from .sharding import (Layout, layout_for, param_sharding_rules,
                       shard_pipeline, shard_unet, video_sharding,
                       video_spec)

__all__ = ['Mesh', 'make_mesh', 'Layout', 'layout_for',
           'param_sharding_rules', 'shard_pipeline', 'shard_unet',
           'video_sharding', 'video_spec']
