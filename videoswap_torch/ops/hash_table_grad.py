"""Hash-grid table gradient: a hand-written Hopper kernel and its plain
PyTorch version.

`hash_table_grad_levels(idx, val, used, out)` is the backward of the
atlas's multiresolution hash encoding (`atlas/imlp.py`), all levels in one
call: for each level l it sums the rows of val[l] (R, F) fp32 into
out[l] (T, F) fp32 at the rows idx[l] (R,) int32 names, dropping rows whose
index is negative or not below used[l]. `hash_table_grad(idx, val,
num_entries)` is one level, the JAX package's signature: it sums into a
zero (num_entries, F) fp32 table, or with `out=` into that table.

A CUDA tensor launches `csrc/hash_table_grad.cu` (fp32 only, unlike the
bf16 kernels of the U-Net; contiguous idx and val; at most MAX_LEVELS levels
and MAX_FEATURES features a row), one launch a call, or raises; a CPU
tensor takes `hash_table_grad_plain`, a level at a time. The JAX package's kernel takes val as (F, R) for the
TPU's lanes; here rows are contiguous, which is what coalesces on a GPU.

The kernel is deterministic: it sums a level's finite values in 64-bit
fixed point at one scale a level (`fixed_shift`), so two calls on the same
inputs give the same bits, whatever order its integer atomics commit in; a
value that is not finite is added in fp32, where the sum of infinities and
NaNs does not depend on order, so an entry comes out NaN or infinite as the
plain version leaves it. `hash_table_grad_fixed` states that arithmetic in
PyTorch for one level; the kernel matches it bit for bit on each level. Its
max words and int64 tables are a buffer allocated for each call; nothing is
kept between calls.

`hash_table_grad`, one level a call, routes through the same kernel with
L = 1 and pays the same cooperative launch and grid syncs as a call of 16
levels: on the H100 it is 1.3-1.4x slower than the one-level kernel it
replaced at the atlas's hashed levels (7-15) and 2-3x slower than
`index_add_` there (PERF.md section 6, row 6). No path makes one-level
calls; the atlas makes one call for all its levels.
"""

from __future__ import annotations

import ctypes
import math

import torch

from . import _build

# launches of the CUDA kernel since the last reset
launches = 0

# levels a call takes (csrc/hash_table_grad.cu kMaxLevels)
MAX_LEVELS = 32
# features a row the kernel takes (csrc/hash_table_grad.cu kMaxGenericF)
MAX_FEATURES = 8

# the kernel's choice between the two forms of its scatter, for every level
# of a launch (csrc/hash_table_grad.cu); 'auto' chooses a level's form
MODES = {'auto': 0, 'global': 1, 'shared': 2}

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


def hash_table_grad_levels_plain(idx, val, used, out):
    """Each level through `hash_table_grad_plain` into its first used[l]
    entries of out."""
    for lv, n in enumerate(used):
        hash_table_grad_plain(idx[lv], val[lv], n, out=out[lv, :n])
    return out


def _check_kernel_args(idx, val, used, out):
    if idx.device != val.device or out.device != val.device:
        raise ValueError('hash_table_grad: all tensors must be on one device')
    if idx.dtype != torch.int32:
        raise TypeError(f'hash_table_grad kernel takes int32 indices, got '
                        f'{idx.dtype}')
    if val.dtype != torch.float32 or out.dtype != torch.float32:
        raise TypeError('hash_table_grad kernel takes fp32 values and table, '
                        f'got {val.dtype} and {out.dtype}')
    if idx.dim() != 2 or val.dim() != 3 or out.dim() != 3 \
            or val.shape[:2] != idx.shape or out.shape[0] != idx.shape[0] \
            or out.shape[2] != val.shape[2]:
        raise ValueError(f'hash_table_grad: idx (L, R), val (L, R, F) and out '
                         f'(L, T, F) expected, got {tuple(idx.shape)}, '
                         f'{tuple(val.shape)}, {tuple(out.shape)}')
    if idx.shape[0] > MAX_LEVELS:
        raise ValueError(f'hash_table_grad kernel takes at most {MAX_LEVELS} '
                         f'levels a call, got {idx.shape[0]}')
    if val.shape[2] > MAX_FEATURES:
        raise ValueError(f'hash_table_grad kernel takes at most '
                         f'{MAX_FEATURES} features a row, got {val.shape[2]}')
    if len(used) != idx.shape[0] or not all(0 < n <= out.shape[1]
                                            for n in used):
        raise ValueError(f'hash_table_grad: used entries {list(used)} for '
                         f'{idx.shape[0]} levels of {out.shape[1]}')
    if not (idx.is_contiguous() and val.is_contiguous()
            and out.is_contiguous()):
        raise ValueError('hash_table_grad kernel takes contiguous tensors')


def _launch_levels(idx, val, used, out, mode: str = 'auto'):
    """Add each level's rows into out on the card (no zeroing), one
    launch."""
    global launches
    used = [int(n) for n in used]
    _check_kernel_args(idx, val, used, out)
    levels, rows = idx.shape
    if rows == 0:
        return out
    lib = _build.library()
    stream = torch.cuda.current_stream(val.device).cuda_stream
    c_used = (ctypes.c_int * levels)(*used)
    # the call's max words and int64 fixed-point tables, which the kernel
    # zeroes; the caching allocator keeps the block for the next call
    buf = torch.empty(lib.vs_hash_table_grad_table_words(
        c_used, levels, val.shape[2]), dtype=torch.int64, device=val.device)
    _build.check(lib.vs_hash_table_grad_levels(
        idx.data_ptr(), val.data_ptr(), out.data_ptr(), buf.data_ptr(),
        c_used, levels, rows, out.shape[1], val.shape[2], MODES[mode],
        stream), 'vs_hash_table_grad_levels')
    launches += 1
    return out


def _launch(idx, val, out, mode: str = 'auto'):
    """One level: add the rows of val (R, F) into out (T, F) on the card."""
    return _launch_levels(idx[None], val[None], [out.shape[0]], out[None],
                          mode)[0]


def hash_table_grad_levels(idx, val, used, out):
    """All levels of one backward. idx: (L, R) int32; val: (L, R, F) fp32;
    used: L ints, the entries of each level's table its rows may reach
    (<= T); out: (L, T, F) fp32, accumulated into and returned. Each level's
    table is what `hash_table_grad(idx[l], val[l], used[l],
    out=out[l, :used[l]])` gives, bit for bit on the card."""
    if not val.is_cuda:
        return hash_table_grad_levels_plain(idx, val, used, out)
    return _launch_levels(idx, val, used, out)


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
