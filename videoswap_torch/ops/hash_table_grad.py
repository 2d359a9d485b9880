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

The kernel is deterministic: it sums the finite values in 64-bit fixed
point at one scale a call (`fixed_shift`), so two calls on the same inputs
give the same bits, whatever order its integer atomics commit in; a value
that is not finite is added in fp32, where the sum of infinities and NaNs
does not depend on order, so an entry comes out NaN or infinite as the
plain version leaves it. `hash_table_grad_fixed` states that arithmetic in
PyTorch; the kernel matches it bit for bit. Its int64 scratch is kept
between calls, one per device and stream, and each call leaves it zero.
"""

from __future__ import annotations

import math

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

# the kernel's choice between its two forms (csrc/hash_table_grad.cu)
MODES = {'auto': 0, 'global': 1, 'shared': 2}

# (device, stream) -> [int64 scratch, phase]: the kernel leaves the scratch
# zero, except the max|val| half of its first word that `phase` names; the
# next call uses the other half, which this one zeroed
_scratch = {}


def hash_table_grad_plain(idx, val, num_entries: int, out=None):
    """Mask out the dropped rows, then `index_add_` into a zero fp32 table
    (or into `out`)."""
    if out is None:
        out = torch.zeros((num_entries, val.shape[1]), dtype=torch.float32,
                          device=val.device)
    keep = (idx >= 0) & (idx < num_entries)
    return out.index_add_(0, idx[keep].long(), val[keep].float())


def fixed_shift(max_abs: float, rows: int) -> int:
    """The fixed-point exponent k of a call: values are summed as
    round(v * 2^k) in int64, with max|v| < 2^e and rows < 2^rb, k = 62 - rb
    - e, so that the sum of |terms| stays below 2^63."""
    return 62 - rows.bit_length() - math.frexp(max_abs)[1]


def hash_table_grad_fixed(idx, val, num_entries: int, out=None):
    """The kernel's arithmetic: the values that are not finite added to a
    zero table (or to `out`) in fp32; each finite kept value rounded once
    to an int64 at 2^fixed_shift (from the largest finite |value|), the
    integers summed per entry, the sums scaled back to fp32 and added where
    they are not 0."""
    if out is None:
        out = torch.zeros((num_entries, val.shape[1]), dtype=torch.float32,
                          device=val.device)
    keep = (idx >= 0) & (idx < num_entries)
    rows = idx[keep].long()
    kept = val[keep].float()
    finite = torch.isfinite(kept)
    max_abs = float(kept[finite].abs().max()) if finite.any() else 0.0
    shift = fixed_shift(max_abs, idx.shape[0])
    bad_row, bad_col = (~finite).nonzero(as_tuple=True)
    out.index_put_((rows[bad_row], bad_col), kept[bad_row, bad_col],
                   accumulate=True)
    q = torch.round(torch.where(finite, kept, 0.0).double()
                    * 2.0 ** shift).long()
    acc = torch.zeros(out.shape, dtype=torch.int64, device=val.device)
    acc.index_add_(0, rows, q)
    nz = acc != 0
    out[nz] += (acc[nz].double() * 2.0 ** -shift).float()
    return out


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


def _launch(idx, val, out, mode: str = 'auto'):
    """Add the rows of val into out on the card (no zeroing)."""
    global launches
    _check_kernel_args(idx, val, out)
    rows = idx.shape[0]
    if rows == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(val.device).cuda_stream
    key = (val.device, stream)
    held = _scratch.get(key)
    if held is None or held[0].numel() < 1 + out.numel():
        # the max|val| word, then the int64 fixed-point table
        held = _scratch[key] = [torch.zeros(1 + out.numel(),
                                            dtype=torch.int64,
                                            device=val.device), 0]
    status = lib.vs_hash_table_grad(idx.data_ptr(), val.data_ptr(),
                                    out.data_ptr(), held[0].data_ptr(),
                                    held[1], rows, out.shape[0],
                                    val.shape[1], MODES[mode], stream)
    if status != 0:
        del _scratch[key]       # a refused call may leave it dirty
    _build.check(status, 'vs_hash_table_grad')
    held[1] ^= 1
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
