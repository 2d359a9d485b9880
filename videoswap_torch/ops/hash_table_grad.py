"""Hash-grid table gradient: a hand-written Hopper kernel and its plain
PyTorch version.

`hash_table_grad(idx, val, num_entries)` sums the rows of val (R, F) fp32
into a zero (num_entries, F) fp32 table at the rows idx (R,) int32 names,
dropping rows whose index is negative (or past the table). It is the
backward of the atlas's multiresolution hash encoding, one call a level
(`atlas/imlp.py`). With `out=` it accumulates into that (num_entries, F)
fp32 table instead.

A CUDA tensor launches `csrc/hash_table_grad.cu` (fp32 only, unlike the
bf16 kernels of the U-Net; contiguous idx and val) or raises; a CPU tensor
takes `hash_table_grad_plain`. The JAX package's kernel takes val as (F, R)
for the TPU's lanes; here rows are contiguous, which is what coalesces on a
GPU.

The kernel adds with fp32 atomics, whose order changes from run to run: the
low bits of each sum do too.
"""

from __future__ import annotations

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

# the kernel's choice between its two forms (csrc/hash_table_grad.cu)
MODES = {'auto': 0, 'global': 1, 'shared': 2}


def hash_table_grad_plain(idx, val, num_entries: int, out=None):
    """Mask out the dropped rows, then `index_add_` into a zero fp32 table
    (or into `out`)."""
    if out is None:
        out = torch.zeros((num_entries, val.shape[1]), dtype=torch.float32,
                          device=val.device)
    keep = (idx >= 0) & (idx < num_entries)
    return out.index_add_(0, idx[keep].long(), val[keep].float())


def _check_kernel_args(idx, val, out):
    if idx.device != val.device or out.device != val.device:
        raise ValueError('hash_table_grad: all tensors must be on one device')
    if idx.dtype != torch.int32:
        raise TypeError(f'hash_table_grad kernel takes int32 indices, got '
                        f'{idx.dtype}')
    if val.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError('hash_table_grad kernel takes fp32 values and table, '
                        f'got {val.dtype} and {out.dtype}')
    if idx.dim() != 1 or val.dim() != 2 or val.shape[0] != idx.shape[0] \
            or out.dim() != 2 or out.shape[1] != val.shape[1]:
        raise ValueError(f'hash_table_grad: idx (R,), val (R, F) and out '
                         f'(T, F) expected, got {tuple(idx.shape)}, '
                         f'{tuple(val.shape)}, {tuple(out.shape)}')
    if not (idx.is_contiguous() and val.is_contiguous()
            and out.is_contiguous()):
        raise ValueError('hash_table_grad kernel takes contiguous tensors')
    if val.shape[1] == 2 and (val.data_ptr() % 8 or out.data_ptr() % 8):
        raise ValueError('hash_table_grad kernel needs 8-byte aligned val '
                         'and out (float2 atomics)')


def _launch(idx, val, out, mode: str = 'auto'):
    """Add the rows of val into out on the card (no zeroing)."""
    global launches
    _check_kernel_args(idx, val, out)
    rows = idx.shape[0]
    if rows == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(val.device).cuda_stream
    status = lib.vs_hash_table_grad(idx.data_ptr(), val.data_ptr(),
                                    out.data_ptr(), rows, out.shape[0],
                                    val.shape[1], MODES[mode], stream)
    _build.check(status, 'vs_hash_table_grad')
    launches += 1
    return out


def hash_table_grad(idx, val, num_entries: int, out=None):
    """idx: (R,) int32; val: (R, F) fp32; returns (num_entries, F) fp32, or
    `out` with the rows added."""
    if not val.is_cuda:
        return hash_table_grad_plain(idx, val, num_entries, out)
    if out is None:
        out = torch.zeros((num_entries, val.shape[1]), dtype=torch.float32,
                          device=val.device)
    elif out.shape[0] != num_entries:
        raise ValueError(f'hash_table_grad: out has {out.shape[0]} entries, '
                         f'not {num_entries}')
    return _launch(idx, val, out)
