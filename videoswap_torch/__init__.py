"""videoswap_torch: the PyTorch and CUDA port of videoswap_tpu.

The same models, schedules and pipeline as the JAX package, written as
`nn.Module`s and plain tensor functions, with the JAX package's Pallas
kernels replaced by hand-written Hopper kernels (`csrc/`, built with `nvcc`
at first use). Video tensors keep the JAX layout at public boundaries:
channels-last (B, F, H, W, C). The port imports nothing from `videoswap_tpu`
and nothing of JAX.
"""

__version__ = '0.1.0'
