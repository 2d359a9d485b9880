"""Sharded inference and training on torch.distributed (the port of
videoswap_tpu/parallel/): a (dp, sp, tp) mesh of process groups (mesh.py),
the layout rules, the differentiable collectives and the trainer-side
helpers (sharding.py), and the multi-process scaffolding (dist.py)."""

from .mesh import Mesh, make_mesh
from .sharding import (Layout, batch_layout, layout_for, param_sharding_rules,
                       reduce_gradients, replicate_tree, shard_batch,
                       shard_pipeline, shard_text_encoder, shard_unet,
                       video_sharding, video_spec)

__all__ = ['Mesh', 'make_mesh', 'Layout', 'batch_layout', 'layout_for',
           'param_sharding_rules', 'reduce_gradients', 'replicate_tree',
           'shard_batch', 'shard_pipeline', 'shard_text_encoder',
           'shard_unet', 'video_sharding', 'video_spec']
