"""Sharding rules and the collectives of the sharded swap (the port of
videoswap_tpu/parallel/sharding.py).

The JAX package states layouts and lets GSPMD insert the collectives. Here
every rank holds its own shard of each activation and the collectives are
written out:

- **Parameters over tp** (`param_sharding_rules`, `shard_unet`): in the
  spatial transformers, `to_q`, `to_k`, `to_v` and `net.0.proj` keep the
  rank's output rows (column parallel; `net.0.proj` as `[a | gate]` pairs),
  `to_out.0` and `net.2` the rank's input columns (row parallel: the
  partial products are all-reduced in their own dtype and the bias is
  added on tp rank 0 alone). The motion modules stay replicated over tp: the fused
  temporal kernel computes a whole block from whole weights.
- **Activations over (dp, sp)** (`video_spec`, `Layout`): the layout rule of
  `constrain_frames` as a function of (B, F, mesh): CFG halves over (dp, sp)
  where B > 1 divides dp x sp, else the batch over dp where it divides and
  the frames over sp where they divide; what does not divide stays
  replicated.
- **The U-Net call** (`VideoRun`): the U-Net takes and returns whole
  tensors; inside, each rank runs its rows and frames. Under CFG-prefix
  dedup the prefix runs replicated over (dp, sp) and each rank keeps its
  part at the doubling. The resnets' GroupNorm reduces its statistics over
  sp where the frames are sharded (`stats_group`); the motion modules
  switch from frame to location sharding with an all-to-all over sp and
  split the locations over (sp, tp) (`frames_to_locations`); stored
  attention maps are gathered over (dp, sp) at once (`gather_folded`), and
  stay head-sharded over tp.

Collectives count the bytes each rank sends (`moved`). Every function is an
identity where no mesh is active.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import Mesh

_COL_PARALLEL = ('to_q', 'to_k', 'to_v', 'net_0_proj', 'q_proj', 'k_proj',
                 'v_proj', 'mlp_fc1')
_ROW_PARALLEL = ('to_out_0', 'net_2', 'out_proj', 'mlp_fc2')

# bytes this rank sent through each collective since the last reset
moved = {'all_reduce': 0, 'all_gather': 0, 'all_to_all': 0, 'broadcast': 0}


def reset_moved() -> None:
    for k in moved:
        moved[k] = 0


# ------------------------------------------------------------ collectives

def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def all_reduce_sum(x: torch.Tensor, group, dtype=torch.float32
                   ) -> torch.Tensor:
    """Sum over `group` in `dtype` (the result's dtype)."""
    y = x.to(dtype).contiguous()
    if group is None:
        return y
    moved['all_reduce'] += y.numel() * y.element_size()
    dist.all_reduce(y, group=group)
    return y


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's `x` (same shape on each), in group-rank order."""
    x = x.contiguous()
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(_size(group))]
    moved['all_gather'] += x.numel() * x.element_size()
    dist.all_gather(out, x, group=group)
    return out


def all_to_all(chunks: list, group) -> list:
    """chunks[j] goes to group rank j; returns what each rank sent here."""
    if group is None:
        return list(chunks)
    inp = torch.stack(chunks).contiguous()
    out = torch.empty_like(inp)
    moved['all_to_all'] += inp.numel() * inp.element_size()
    dist.all_to_all_single(out, inp, group=group)
    return list(out.unbind(0))


def broadcast(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mesh's first rank's `x` on every rank of the mesh."""
    group = None if mesh is None else mesh.group('all')
    if group is None:
        return x
    x = x.contiguous()
    moved['broadcast'] += x.numel() * x.element_size()
    dist.broadcast(x, src=mesh.ranks[0], group=group)
    return x


# ------------------------------------------------------------------ rules

def _parts(path) -> list:
    out = []
    for p in path:
        out += [q for q in str(p).replace('.', '_').split('_') if q]
    return out


def _has(parts: list, name: str) -> bool:
    want = name.split('_')
    return any(parts[i:i + len(want)] == want
               for i in range(len(parts) - len(want) + 1))


def param_sharding_rules(path, ndim: int) -> tuple:
    """The JAX package's tp rule for a parameter at `path` (its module names,
    diffusers keys as in `attn1.to_q.weight` or the JAX package's
    `net_0_proj`), in the torch `Linear` layout (out, in): ('tp', None)
    splits the output axis (column parallel), (None, 'tp') the input axis
    (row parallel), () replicates."""
    parts = _parts(path)
    if ndim == 2:
        if any(_has(parts, n) for n in _COL_PARALLEL):
            return ('tp', None)
        if any(_has(parts, n) for n in _ROW_PARALLEL):
            return (None, 'tp')
    return ()


def video_spec(b: int, f: int, mesh: Mesh) -> tuple:
    """(batch spec, frame spec) of a (B, F, ...) activation: the rule of
    the JAX package's `constrain_frames`, as its PartitionSpec entries."""
    dp, sp = mesh.dp, mesh.sp
    if b > 1 and b % (dp * sp) == 0:
        return (('dp', 'sp') if dp > 1 else 'sp'), None
    rows = 'dp' if dp > 1 and b % dp == 0 else None
    return rows, ('sp' if f % sp == 0 else None)


def video_sharding(shape, mesh: Mesh, frame_axis: int = 1) -> tuple:
    """The JAX package's `video_sharding` spec for CLI-provided shapes: an
    axis shards only where its extent divides the mesh axis."""
    spec = [None] * len(shape)
    if shape[0] % mesh.dp == 0:
        spec[0] = 'dp'
    if shape[frame_axis] % mesh.sp == 0:
        spec[frame_axis] = 'sp'
    return tuple(spec)


@dataclasses.dataclass(frozen=True)
class Layout:
    """A (B, F, ...) tensor's placement on `mesh`: `rows` and `frames` are
    the [start, stop) this rank holds; `frame_sharded` when the frames are
    split over sp (sp > 1)."""
    mesh: Mesh
    b: int
    f: int
    spec: tuple

    def _slice(self, entry, n: int, d: int, s: int) -> tuple:
        if entry is None:
            return 0, n
        k, parts = {'dp': (d, self.mesh.dp), 'sp': (s, self.mesh.sp),
                    ('dp', 'sp'): (d * self.mesh.sp + s,
                                   self.mesh.dp * self.mesh.sp)}[entry]
        step = n // parts
        return k * step, (k + 1) * step

    def slices_at(self, d: int, s: int) -> tuple:
        return (self._slice(self.spec[0], self.b, d, s),
                self._slice(self.spec[1], self.f, d, s))

    @property
    def rows(self) -> tuple:
        return self.slices_at(*self.mesh.coord[:2])[0]

    @property
    def frames(self) -> tuple:
        return self.slices_at(*self.mesh.coord[:2])[1]

    @property
    def frame_sharded(self) -> bool:
        return self.spec[1] == 'sp' and self.mesh.sp > 1

    @property
    def replicated(self) -> bool:
        m = self.mesh
        parts = {None: 1, 'dp': m.dp, 'sp': m.sp, ('dp', 'sp'): m.dp * m.sp}
        return parts[self.spec[0]] == 1 and not self.frame_sharded

    def take(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's part of a whole (B, F, ...) tensor."""
        (r0, r1), (f0, f1) = self.rows, self.frames
        return x[r0:r1, f0:f1]

    def take_rows(self, x: torch.Tensor) -> torch.Tensor:
        r0, r1 = self.rows
        return x[r0:r1]

    def gather(self, x: torch.Tensor) -> torch.Tensor:
        """The whole (B, F, ...) tensor from every rank's part `x`."""
        if self.replicated:
            return x
        pieces = all_gather(x, self.mesh.group('dpsp'))
        out = x.new_empty((self.b, self.f, *x.shape[2:]))
        i = 0
        for d in range(self.mesh.dp):
            for s in range(self.mesh.sp):
                (r0, r1), (f0, f1) = self.slices_at(d, s)
                out[r0:r1, f0:f1] = pieces[i]
                i += 1
        return out

    def describe(self) -> str:
        return (f'B={self.b} F={self.f} spec {self.spec}: rows '
                f'{self.rows} frames {self.frames}')


def layout_for(b: int, f: int, mesh: Mesh, replicate: bool = False):
    spec = (None, None) if replicate else video_spec(b, f, mesh)
    return Layout(mesh=mesh, b=b, f=f, spec=spec)


# ------------------------------------------------------------ U-Net calls

class VideoRun:
    """The layout of one sharded U-Net call: `layout` now, `after` the
    layout after the CFG doubling (the same without dedup)."""

    def __init__(self, mesh: Mesh, layout: Layout, after: Layout):
        self.mesh, self.layout, self.after = mesh, layout, after


_RUNS: list = []
_MESHES: list = []


def active() -> Optional[VideoRun]:
    return _RUNS[-1] if _RUNS else None


@contextlib.contextmanager
def video_run(run: VideoRun):
    _RUNS.append(run)
    try:
        yield run
    finally:
        _RUNS.pop()


@contextlib.contextmanager
def mesh_scope(mesh: Optional[Mesh]):
    """The pipeline's mesh for what runs outside the U-Net (the blend
    masks' head sum); no-op without one."""
    _MESHES.append(mesh)
    try:
        yield mesh
    finally:
        _MESHES.pop()


def scoped_mesh() -> Optional[Mesh]:
    if _RUNS:
        return _RUNS[-1].mesh
    return _MESHES[-1] if _MESHES else None


def stats_group():
    """The group a GroupNorm over a (B, F, H, W, C) tensor reduces its
    statistics over: sp where the frames are sharded, else None."""
    run = active()
    if run is None or not run.layout.frame_sharded:
        return None
    return run.mesh.group('sp')


def local_frames() -> Optional[tuple]:
    """[start, stop) of the frames this rank holds in the U-Net call."""
    run = active()
    return None if run is None else run.layout.frames


def local_rows() -> Optional[tuple]:
    run = active()
    return None if run is None else run.layout.rows


def frames_after_expand(f: int) -> int:
    """The local frame count after the CFG doubling (f unsharded)."""
    run = active()
    if run is None:
        return f
    f0, f1 = run.after.frames
    return f1 - f0


def double_cfg(x: torch.Tensor) -> torch.Tensor:
    """[x; x]: the CFG doubling of the shared prefix, then this rank's part
    of the doubled batch. x is (B, F, ...) or frames folded, (B*F, ...)."""
    run = active()
    if run is None:
        return torch.cat([x, x])
    lay = run.layout                       # the replicated prefix
    folded = x.dim() != 5
    v = x.reshape(lay.b, lay.f, *x.shape[1:]) if folded else x
    v = run.after.take(torch.cat([v, v]))
    return v.reshape(-1, *x.shape[1:]) if folded else v


def finish_cfg_expand() -> None:
    run = active()
    if run is not None:
        run.layout = run.after


def gather_folded(probs: torch.Tensor) -> torch.Tensor:
    """Stored attention maps (rows x frames folded, heads, Sq, Sk) of this
    rank -> the whole batch's, still head-sharded over tp."""
    run = active()
    if run is None or run.layout.replicated:
        return probs
    lay = run.layout
    (r0, r1), (f0, f1) = lay.rows, lay.frames
    v = probs.reshape(r1 - r0, f1 - f0, *probs.shape[1:])
    return lay.gather(v).reshape(lay.b * lay.f, *probs.shape[1:])


def head_sum(x: torch.Tensor, dim: int) -> tuple:
    """(sum over `dim` and over the tp ranks' heads in fp32, the number of
    entries summed): the blend masks' head mean, heads sharded over tp."""
    mesh = scoped_mesh()
    group = None if mesh is None else mesh.group('tp')
    s = all_reduce_sum(x.float().sum(dim), group)
    return s, x.shape[dim] * _size(group)


# ------------------------------------------------- motion-module all-to-all

def location_split() -> Optional[dict]:
    """How the motion modules of this U-Net call split their locations:
    None where every rank runs all of its rows' locations (no mesh, or no
    sp frame sharding and tp = 1)."""
    run = active()
    if run is None:
        return None
    mesh = run.mesh
    fg = mesh.group('sp') if run.layout.frame_sharded else None
    tg = mesh.group('tp')
    if fg is None and tg is None:
        return None
    s, t = mesh.coord[1], mesh.coord[2]
    nf = mesh.sp if fg is not None else 1
    return {'fg': fg, 'tg': tg, 'nf': nf, 's': s if fg is not None else 0,
            't': t, 'n': nf * mesh.tp, 'f': run.layout.f,
            'frames': run.layout.frames}


def frames_to_locations(x: torch.Tensor, split: dict) -> tuple:
    """(b, f_local, L, c) frame-sharded -> (this rank's (b, F, q, c)
    location chunk with every frame, L). Chunk k = s * tp + t of the
    locations padded to n chunks; rank (s, t) receives its chunk of the
    other sp ranks' frames through an all-to-all over sp."""
    b, fl, el, c = x.shape
    n, t = split['n'], split['t']
    q = -(-el // n)
    if q * n != el:
        x = torch.cat([x, x.new_zeros((b, fl, q * n - el, c))], dim=2)
    tp = n // split['nf']
    chunks = [x[:, :, (s2 * tp + t) * q:(s2 * tp + t + 1) * q]
              for s2 in range(split['nf'])]
    recv = all_to_all(chunks, split['fg'])
    return torch.cat(recv, dim=1), el


def locations_to_frames(y: torch.Tensor, split: dict, el: int
                        ) -> torch.Tensor:
    """The inverse of `frames_to_locations`: this rank's (b, F, q, c)
    chunk -> its frames at every location, (b, f_local, L, c)."""
    b, f, q, c = y.shape
    nf, t = split['nf'], split['t']
    tp = split['n'] // nf
    step = f // nf
    chunks = [y[:, s2 * step:(s2 + 1) * step] for s2 in range(nf)]
    recv = torch.stack(all_to_all(chunks, split['fg']))   # [s2] my frames
    per_t = all_gather(recv, split['tg'])                 # [t'][s2]
    blocks = [per_t[t2][s2] for s2 in range(nf) for t2 in range(tp)]
    out = torch.cat(blocks, dim=2)
    return out[:, :, :el]


# -------------------------------------------------------------- parameters

def bias_on_rank(bias: torch.Tensor, t: int) -> torch.Tensor:
    """A row-parallel layer's bias on tp rank t: added once, on rank 0."""
    return bias if t == 0 else torch.zeros_like(bias)


def geglu_rows(inner: int, t: int, tp: int) -> torch.Tensor:
    """The rows of net.0.proj's (2 x inner, C) weight that tp rank t holds:
    its a rows and the gate rows of the same hidden units, [a | gate]."""
    h = inner // tp
    a = torch.arange(t * h, (t + 1) * h)
    return torch.cat([a, a + inner])


def _col(w, t, tp):
    n = w.shape[0] // tp
    return w[t * n:(t + 1) * n]


def _row(w, t, tp):
    n = w.shape[1] // tp
    return w[:, t * n:(t + 1) * n]


@torch.no_grad()
def shard_unet(unet, mesh: Mesh) -> dict:
    """Cut the spatial transformers' attention and GEGLU weights of `unet`
    (in place) to tp rank t's shards, and point those layers at the tp
    group. Returns {state-dict key: full -> local} for each weight cut (the
    ED-LoRA merge cuts its deltas with them)."""
    from videoswap_torch.models.attention_blocks import BasicTransformerBlock
    tp, t = mesh.tp, mesh.coord[2]
    group = mesh.group('tp')
    slicers = {}
    if tp == 1:
        return slicers

    def put(name, lin, attr, fn):
        p = getattr(lin, attr)
        p.data = fn(p.data).contiguous()
        slicers[f'{name}{attr}'] = fn

    for name, mod in unet.named_modules():
        if not isinstance(mod, BasicTransformerBlock):
            continue
        name = f'{name}.' if name else ''
        for an in ('attn1', 'attn2'):
            attn = getattr(mod, an)
            if attn.heads % tp:
                raise ValueError(f'{attn.heads} heads do not split over '
                                 f'tp={tp}')
            for pn in ('to_q', 'to_k', 'to_v'):
                put(f'{name}{an}.{pn}.', getattr(attn, pn), 'weight',
                    lambda w: _col(w, t, tp))
            out = attn.to_out[0]
            put(f'{name}{an}.to_out.0.', out, 'weight',
                lambda w: _row(w, t, tp))
            put(f'{name}{an}.to_out.0.', out, 'bias',
                lambda b: bias_on_rank(b, t))
            attn.heads //= tp
            attn.tp_group = group
        ff = mod.ff
        proj, out = ff.net[0].proj, ff.net[2]
        inner = out.weight.shape[1]
        if inner % tp:
            raise ValueError(f'{inner} hidden units do not split over '
                             f'tp={tp}')
        rows = geglu_rows(inner, t, tp)
        put(f'{name}ff.net.0.proj.', proj, 'weight',
            lambda w, r=rows: w[r.to(w.device)])
        put(f'{name}ff.net.0.proj.', proj, 'bias',
            lambda b, r=rows: b[r.to(b.device)])
        put(f'{name}ff.net.2.', out, 'weight', lambda w: _row(w, t, tp))
        put(f'{name}ff.net.2.', out, 'bias', lambda b: bias_on_rank(b, t))
        ff.tp_group = group
    return slicers


def shard_pipeline(pipe, mesh: Mesh):
    """Sharded inference: a new pipeline whose U-Net (a copy) holds this
    rank's tp shards and runs its rows and frames of every call, and whose
    `mesh` makes the pipeline split the VAE's frames over the mesh and
    broadcast its seeded latents. The VAE, the text encoder and the adapter
    are shared with `pipe` (replicated). The analogue of the JAX package's
    `shard_pipeline`."""
    if not mesh.member:
        raise ValueError(f'this rank is not in the mesh {mesh.describe()}')
    unet = copy.deepcopy(pipe.unet)
    unet.tp_slicers = shard_unet(unet, mesh)
    unet.mesh = mesh
    return dataclasses.replace(pipe, unet=unet, mesh=mesh)
