"""Coordinate MLPs of the layered neural atlas, with the multiresolution hash
encoding.

The counterpart of videoswap_tpu/atlas/imlp.py: `IMLP` with pe_type 'none',
'encoding' (Fourier features) or 'hash_encoding' (a 2-D hash grid: per level
four corner gathers and bilinear weights; levels whose (res + 1)^2 grid fits
the table index it densely with a floor-mod wrap, finer levels through the
uint32 spatial hash). Layers are `hidden_{i}` Linears and the grid is the
`hash_table` parameter (L, T, F), so the JAX parameters load by name through
`models/converters.py`.

`HashEncode` is the encoding's autograd Function. Its forward is plain
gathers; its backward computes d_table with the hand-written scatter kernel
(`ops/hash_table_grad.py`) on the card and its plain version on the CPU,
one call for all levels, and d_x as the analytic derivative of the bilinear
weights.
The geometry of all levels is computed at once, level by level in the same
arithmetic as the JAX package, so that a step launches a few dozen
elementwise kernels for the encoding and not a few hundred.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from ..ops.hash_table_grad import hash_table_grad_levels

HASH_PRIMES = (1, 2654435761, 805459861)
_MASK32 = 0xFFFFFFFF
# corner c of a cell: (dx, dy); the forward sums the corners in this order
_CORNERS = ((0, 0), (1, 0), (0, 1), (1, 1))


def _const(values, device: torch.device, dtype=None) -> torch.Tensor:
    """A small constant tensor on `device`. On the card it goes through
    pinned memory without blocking: a blocking copy to the card waits for
    its queue to drain, which a training step would pay for each constant."""
    t = torch.tensor(values, dtype=dtype)
    if device.type != 'cuda':
        return t
    return t.pin_memory().to(device, non_blocking=True)


def positional_encode(x: torch.Tensor, num_freqs: int) -> torch.Tensor:
    """Fourier features: per frequency j, all sin(x_i b_j) then all
    cos(x_i b_j), b_j = 2^j pi."""
    b = _const([(2.0 ** j) * math.pi for j in range(num_freqs)], x.device,
               x.dtype)
    proj = x[..., :, None] * b                          # [N, D, J]
    feat = torch.cat([torch.sin(proj), torch.cos(proj)], dim=-2)
    return feat.transpose(-1, -2).reshape(*x.shape[:-1], -1)


def _level_resolutions(n_levels: int, base_resolution: int,
                       per_level_scale: float) -> list[int]:
    return [int(math.floor(base_resolution * per_level_scale ** lv))
            for lv in range(n_levels)]


def _mul_u32(a: torch.Tensor, prime: int) -> torch.Tensor:
    """(a * prime) mod 2^32 for int64 a in [0, 2^32). The prime is split
    into 16-bit halves so that no product leaves int64's range."""
    hi, lo = prime >> 16, prime & 0xFFFF
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _level_geometry(x: torch.Tensor, resolutions: Sequence[int],
                    table_size: int):
    """Corner indices and bilinear weights of every level at once.

    Returns idx (L, 4, N) int64 (level-local), u and v (L, 4, N) fp32 (the
    x and y factors of each corner's weight, w = u * v) and res (L,)
    fp32."""
    dev = x.device
    res_i = _const(resolutions, dev, torch.int64)
    res = res_i.float()
    pos = x[None, :, :2].float() * res[:, None, None]     # (L, N, 2)
    c0 = torch.floor(pos)
    frac = pos - c0
    c0 = c0.long()
    dxs = _const([dx for dx, _ in _CORNERS], dev)[None, :, None]
    dys = _const([dy for _, dy in _CORNERS], dev)[None, :, None]
    cx = c0[:, None, :, 0] + dxs                          # (L, 4, N)
    cy = c0[:, None, :, 1] + dys
    side = (res_i + 1)[:, None, None]
    dense_idx = cx % side + (cy % side) * side            # floor-mod wrap
    hashed_idx = (_mul_u32(cx & _MASK32, HASH_PRIMES[0])
                  ^ _mul_u32(cy & _MASK32, HASH_PRIMES[1])) % table_size
    dense = ((res_i + 1) ** 2 <= table_size)[:, None, None]
    idx = torch.where(dense, dense_idx, hashed_idx)
    fx, fy = frac[..., 0], frac[..., 1]                   # (L, N)
    u = torch.stack([1 - fx, fx, 1 - fx, fx], dim=1)
    v = torch.stack([1 - fy, 1 - fy, fy, fy], dim=1)
    return idx, u, v, res


def _gather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table (L, T, F), level-local idx (L, 4, N) -> (L, 4, N, F)."""
    n_levels, table_size, _ = table.shape
    offs = torch.arange(n_levels, device=idx.device)[:, None, None]
    return table.reshape(n_levels * table_size, -1)[idx + offs * table_size]


def _hash_encode_impl(x, table, base_resolution, per_level_scale):
    n_levels, table_size, nf = table.shape
    idx, u, v, _ = _level_geometry(
        x, _level_resolutions(n_levels, base_resolution, per_level_scale),
        table_size)
    w = u * v
    g = _gather(table, idx)
    acc = g[:, 0] * w[:, 0, :, None]
    for c in range(1, 4):
        acc = acc + g[:, c] * w[:, c, :, None]             # (L, N, F)
    return acc.permute(1, 0, 2).reshape(x.shape[0], n_levels * nf).to(x.dtype)


class HashEncode(torch.autograd.Function):
    """The hash encoding with the JAX package's custom VJP: d_table through
    the scatter kernel, d_x analytic."""

    @staticmethod
    def forward(ctx, x, table, base_resolution, per_level_scale):
        ctx.save_for_backward(x, table)
        ctx.grid = (base_resolution, per_level_scale)
        return _hash_encode_impl(x, table, base_resolution, per_level_scale)

    @staticmethod
    def backward(ctx, g):
        x, table = ctx.saved_tensors
        n_levels, table_size, nf = table.shape
        resolutions = _level_resolutions(n_levels, *ctx.grid)
        idx, u, v, res = _level_geometry(x, resolutions, table_size)
        gl = g.float().reshape(x.shape[0], n_levels, nf).permute(1, 0, 2)
        d_x = d_table = None
        if ctx.needs_input_grad[1]:
            # R = 4N weighted rows a level, corner-major as in the JAX
            # package. A dense level indexes only its first (res + 1)^2
            # entries, so the scatter sees that table (small ones fit the
            # kernel's shared-memory form)
            vals = ((u * v)[..., None] * gl[:, None]).reshape(
                n_levels, -1, nf).contiguous()
            idx32 = idx.to(torch.int32).reshape(n_levels, -1)
            d_table = torch.zeros(table.shape, dtype=torch.float32,
                                  device=table.device)
            hash_table_grad_levels(
                idx32, vals, [min((r + 1) ** 2, table_size)
                              for r in resolutions], d_table)
            d_table = d_table.to(table.dtype)
        if ctx.needs_input_grad[0]:
            # w_c = u_c(fx) v_c(fy): dw_c/dfx = +-v_c, dw_c/dfy = +-u_c
            s = (_gather(table, idx).float() * gl[:, None]).sum(-1)
            sgn_x = _const([-1.0, 1.0, -1.0, 1.0], x.device)[None, :, None]
            sgn_y = _const([-1.0, -1.0, 1.0, 1.0], x.device)[None, :, None]
            dfx = (sgn_x * v * s).sum(1)                   # (L, N)
            dfy = (sgn_y * u * s).sum(1)
            dpos = (res[:, None, None]
                    * torch.stack([dfx, dfy], dim=-1)).sum(0)
            d_x = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
            d_x[:, :2] = dpos
            d_x = d_x.to(x.dtype)
        return d_x, d_table, None, None


def hash_encode(x: torch.Tensor, table: torch.Tensor, *,
                base_resolution: int = 16,
                per_level_scale: float = 1.38) -> torch.Tensor:
    """Multiresolution hash encoding of 2-D inputs.

    x: (N, 2) (the atlas UV; coordinates out of [0, 1] hash like any
    other); table: (L, T, F) learned features. Returns (N, L * F)."""
    return HashEncode.apply(x, table, base_resolution, per_level_scale)


class IMLP(nn.Module):
    """pe_type: 'none' | 'encoding' | 'hash_encoding'; a ReLU MLP of
    `mlp_layers` Linears with skip connections (the encoded input
    concatenated before the layers in `skip_layers`) and a tanh output."""

    def __init__(self, input_dim: int, output_dim: int, hidden_dim: int = 256,
                 pe_type: str = 'none', pe_dim: int = 10,
                 skip_layers: Sequence[int] = (), mlp_layers: int = 8,
                 use_tanh: bool = True, hash_levels: int = 16,
                 hash_feats: int = 2, log2_hashmap_size: int = 19,
                 base_resolution: int = 16, per_level_scale: float = 1.38):
        super().__init__()
        if pe_type not in ('none', 'encoding', 'hash_encoding'):
            raise ValueError(f'unknown pe_type {pe_type!r}')
        self.input_dim, self.output_dim = input_dim, output_dim
        self.pe_type, self.pe_dim = pe_type, pe_dim
        self.skip_layers = tuple(skip_layers)
        self.mlp_layers, self.use_tanh = mlp_layers, use_tanh
        self.base_resolution = base_resolution
        self.per_level_scale = per_level_scale
        if pe_type == 'hash_encoding':
            self.hash_table = nn.Parameter(torch.empty(
                hash_levels, 2 ** log2_hashmap_size, hash_feats))
            enc_dim = hash_levels * hash_feats
        elif pe_type == 'encoding':
            enc_dim = input_dim * 2 * pe_dim
        else:
            enc_dim = input_dim
        for i in range(mlp_layers):
            in_dim = (enc_dim if i == 0 else hidden_dim) \
                + (enc_dim if i in self.skip_layers else 0)
            out_dim = output_dim if i == mlp_layers - 1 else hidden_dim
            setattr(self, f'hidden_{i}', nn.Linear(in_dim, out_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.pe_type == 'hash_encoding':
            x = hash_encode(x, self.hash_table,
                            base_resolution=self.base_resolution,
                            per_level_scale=self.per_level_scale)
        elif self.pe_type == 'encoding':
            x = positional_encode(x, self.pe_dim)
        inp = x
        for i in range(self.mlp_layers):
            if i > 0:
                x = torch.relu(x)
            if i in self.skip_layers:
                x = torch.cat([x, inp], dim=-1)
            x = getattr(self, f'hidden_{i}')(x)
        return torch.tanh(x) if self.use_tanh else x


@torch.no_grad()
def init_imlp(net: IMLP, generator: torch.Generator) -> None:
    """Seeded weights on flax's scales, in `named_parameters` order: Linear
    weights ~ N(0, 1/fan_in) (lecun-normal), biases 0, the hash table
    ~ U(-1e-4, 1e-4)."""
    for name, p in net.named_parameters():
        if name == 'hash_table':
            p.uniform_(-1e-4, 1e-4, generator=generator)
        elif name.endswith('weight'):
            p.normal_(0.0, p.shape[1] ** -0.5, generator=generator)
        else:
            p.zero_()


def imlp_from_opt(opt: dict) -> IMLP:
    """Build from a YAML model block (IMLP_Hash keyword arguments); the
    hash-grid sizes default to 16 levels x 2 features, a 2^19 table, base
    16 and scale 1.38, and the block may override them."""
    return IMLP(
        input_dim=opt['input_dim'],
        output_dim=opt['output_dim'],
        hidden_dim=opt.get('hidden_dim', 256),
        pe_type=opt.get('pe_type', 'none'),
        pe_dim=opt.get('pe_dim', 10),
        skip_layers=tuple(opt.get('skip_layers', []) or []),
        mlp_layers=opt.get('mlp_layers', 8),
        use_tanh=opt.get('use_tanh', True),
        hash_levels=opt.get('n_levels', opt.get('hash_levels', 16)),
        hash_feats=opt.get('n_features_per_level', opt.get('hash_feats', 2)),
        log2_hashmap_size=opt.get('log2_hashmap_size', 19),
        base_resolution=opt.get('base_resolution', 16),
        per_level_scale=opt.get('per_level_scale', 1.38),
    )
