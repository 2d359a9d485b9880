"""Sharding rules and the collectives of the sharded swap and of sharded
training (the port of videoswap_tpu/parallel/sharding.py).

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
  stay head-sharded over tp. A training step calls the U-Net on its part
  (`forward_local`) with the trainer batch's layout (`batch_layout`,
  `shard_batch`: B over dp, F over sp where they divide).
- **Gradients**: every collective an activation's gradient crosses is an
  autograd Function with the backward its place needs (see the
  collectives below); a value computed from a rank's own shard is summed
  over the ranks whose shards differ and never over replicated copies
  (`sum_distinct`, `reduce_gradients`), the same bits on every rank.
- **CLIP over tp** (`shard_text_encoder`): q_proj, k_proj, v_proj and
  mlp.fc1 column parallel, out_proj and mlp.fc2 row parallel, for
  tensor-parallel ED-LoRA training.

Collectives count the bytes each rank sends, forward (`moved`) and backward
(`moved_backward`). Every function is an identity where no mesh is active.
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

# bytes this rank sent through each collective since the last reset: in
# the forward pass (`moved`) and in the backward pass (`moved_backward`)
moved = {'all_reduce': 0, 'all_gather': 0, 'all_to_all': 0, 'broadcast': 0}
moved_backward = dict(moved)


def reset_moved() -> None:
    for d in (moved, moved_backward):
        for k in d:
            d[k] = 0


# ------------------------------------------------------------ collectives
#
# Each collective that a gradient crosses is an autograd Function whose
# backward matches where it sits (torch.distributed.nn's all_reduce and
# all_gather sum their gradients, which would count a gradient tp times
# wherever the output feeds replicated compute):
#
# - `all_reduce_sum` (the row-parallel exit): sum forward, identity backward;
# - `copy_to_tp` (the column-parallel entry): identity forward, sum backward;
# - `reduce_stats` (GroupNorm statistics over sp): sum both ways;
# - `all_to_all`: the inverse all-to-all backward;
# - `gather_parts` (the tp all-gather of `locations_to_frames`,
#   `Layout.gather`): this rank's own part of the gradient, nothing summed.

def _size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _count(kind: str, t: torch.Tensor, backward: bool) -> None:
    (moved_backward if backward else moved)[kind] += (t.numel()
                                                      * t.element_size())


def _sum(x: torch.Tensor, group, backward: bool = False) -> torch.Tensor:
    """A new tensor: the sum of `x` over `group` (the caller's is never
    written)."""
    y = x.contiguous().clone()
    _count('all_reduce', y, backward)
    dist.all_reduce(y, group=group)
    return y


class _SumForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dtype):
        ctx.dtype = x.dtype
        return _sum(x.to(dtype), group)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype), None, None


class _SumBackward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, backward=True), None


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _sum(x, group)

    @staticmethod
    def backward(ctx, g):
        return _sum(g, ctx.group, backward=True), None


def all_reduce_sum(x: torch.Tensor, group, dtype=torch.float32
                   ) -> torch.Tensor:
    """Sum over `group` in `dtype` (the result's dtype); the gradient passes
    to `x` as it is (a row-parallel exit: every rank's partial feeds the
    same sum)."""
    if group is None:
        return x.to(dtype)
    return _SumForward.apply(x, group, dtype)


def copy_to_tp(x: torch.Tensor, group) -> torch.Tensor:
    """The column-parallel entry: `x` as it is, its gradient summed over
    `group` (each tp rank's input gradient holds its own heads' or hidden
    units' part)."""
    if group is None:
        return x
    return _SumBackward.apply(x, group)


def reduce_stats(x: torch.Tensor, group) -> torch.Tensor:
    """Statistics summed over `group` (fp32), gradient summed too: every
    rank's own frames consume the global statistics."""
    if group is None:
        return x
    return _SumBoth.apply(x, group)


def all_reduce_max(x: torch.Tensor, group) -> torch.Tensor:
    """The elementwise maximum over `group` (no gradient)."""
    if group is None:
        return x
    y = x.detach().contiguous().clone()
    _count('all_reduce', y, False)
    dist.all_reduce(y, op=dist.ReduceOp.MAX, group=group)
    return y


def all_gather(x: torch.Tensor, group) -> list:
    """Every rank's `x` (same shape on each), in group-rank order (no
    gradient: `gather_parts` carries one)."""
    x = x.contiguous()
    if group is None:
        return [x]
    out = [torch.empty_like(x) for _ in range(_size(group))]
    _count('all_gather', x, False)
    dist.all_gather(out, x, group=group)
    return out


def gather_backward(g: torch.Tensor, group, part) -> torch.Tensor:
    """The gradient of a gathered tensor for this rank's input: `part`, its
    own part of `g`, nothing summed (every rank holds the whole gradient of
    the gathered tensor, which feeds replicated compute)."""
    return part(g)


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, assemble, part):
        ctx.group, ctx.part = group, part
        return assemble(all_gather(x, group))

    @staticmethod
    def backward(ctx, g):
        return gather_backward(g, ctx.group, ctx.part), None, None, None


def gather_parts(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's `x`, stacked in group-rank
    order; the gradient is this rank's own entry."""
    if group is None:
        return x[None]
    index = dist.get_rank(group)
    return _Gather.apply(x, group, torch.stack, lambda g: g[index])


def _all_to_all(inp: torch.Tensor, group, backward: bool) -> torch.Tensor:
    inp = inp.contiguous()
    out = torch.empty_like(inp)
    _count('all_to_all', inp, backward)
    dist.all_to_all_single(out, inp, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, inp, group):
        ctx.group = group
        return _all_to_all(inp, group, False)

    @staticmethod
    def backward(ctx, g):
        # chunk j of the gradient goes back to the rank it came from
        return _all_to_all(g, ctx.group, True), None


def all_to_all(chunks: list, group) -> list:
    """chunks[j] goes to group rank j; returns what each rank sent here.
    The gradient takes the inverse all-to-all."""
    if group is None:
        return list(chunks)
    return list(_AllToAll.apply(torch.stack(chunks), group).unbind(0))


def broadcast(x: torch.Tensor, mesh: Optional[Mesh]) -> torch.Tensor:
    """The mesh's first rank's `x` on every rank of the mesh (in place)."""
    group = None if mesh is None else mesh.group('all')
    if group is None:
        return x
    x = x.contiguous()
    _count('broadcast', x, False)
    dist.broadcast(x, src=mesh.ranks[0], group=group)
    return x


# -------------------------------------------- sums over distinct shards
#
# A value that each rank computed from its own shard is summed over the
# ranks whose shards differ (the mesh `axes` the value is split over) and
# never over replicated copies. Every rank gathers the mesh's values and
# adds the same copies in the same order, so every rank ends with the same
# bits.

def representatives(mesh: Mesh, axes) -> list:
    """The mesh indices whose values are summed: every coordinate on
    `axes`, the first on every other axis, in row-major order."""
    names = ('dp', 'sp', 'tp')
    out = []
    for i in range(mesh.size):
        d, r = divmod(i, mesh.sp * mesh.tp)
        s, t = divmod(r, mesh.tp)
        if all(c == 0 for n, c in zip(names, (d, s, t)) if n not in axes):
            out.append(i)
    return out


def _distinct_sum(x: torch.Tensor, mesh: Mesh, axes) -> torch.Tensor:
    parts = all_gather(x.detach(), mesh.group('all'))
    out = None
    for i in representatives(mesh, axes):
        out = parts[i] if out is None else out + parts[i]
    return out


class _DistinctSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axes):
        return _distinct_sum(x, mesh, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sum_distinct(x: torch.Tensor, mesh: Optional[Mesh], axes
                 ) -> torch.Tensor:
    """The sum of `x` over the ranks whose shards differ on `axes` (each
    rank's own `x` gets the whole gradient: a loss's partial sums)."""
    if mesh is None or mesh.size == 1:
        return x
    return _DistinctSum.apply(x, mesh, tuple(axes))


def distinct_axes(layout: 'Layout') -> tuple:
    """The mesh axes over which `layout`'s rows or frames differ: a
    value computed from a rank's part sums over these and no other."""
    m, (rows, frames) = layout.mesh, layout.spec
    out = []
    if rows in ('dp', ('dp', 'sp')) and m.dp > 1:
        out.append('dp')
    if (rows == ('dp', 'sp') or rows == 'sp' or frames == 'sp') \
            and m.sp > 1:
        out.append('sp')
    return tuple(out)


@torch.no_grad()
def reduce_gradients(params, mesh: Optional[Mesh], axes) -> None:
    """Each parameter's `.grad` summed over the ranks whose shards differ
    on the mesh `axes` (a gradient held whole on every rank: `axes` = (),
    the mesh's first rank's copy), in place. A missing gradient counts as
    zeros. One gather for all of them."""
    params = list(params)
    if mesh is None or mesh.size == 1 or not params:
        return
    grads = [p.grad if p.grad is not None else torch.zeros_like(p)
             for p in params]
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    total = _distinct_sum(flat, mesh, tuple(axes))
    i = 0
    for p, g in zip(params, grads):
        n = g.numel()
        p.grad = total[i:i + n].view_as(g).to(g.dtype)
        i += n


@torch.no_grad()
def replicate_tree(tensors, mesh: Optional[Mesh]) -> None:
    """The mesh's first rank's values of `tensors` (parameters, optimizer
    state) on every rank of the mesh, in place: every rank starts from the
    same trainable state."""
    group = None if mesh is None else mesh.group('all')
    if group is None:
        return
    # NCCL moves device tensors only (an optimizer's step counts live on
    # the CPU)
    dev = (torch.device('cuda', torch.cuda.current_device())
           if dist.get_backend(group) == 'nccl' else None)
    for t in tensors:
        if not torch.is_tensor(t):
            continue
        buf = t.detach().to(dev or t.device, copy=True).contiguous()
        broadcast(buf, mesh)
        t.data.copy_(buf)


def optimizer_tensors(optimizer: torch.optim.Optimizer) -> list:
    """The optimizer's parameters and every tensor of its state, in a fixed
    order (the same on every rank)."""
    out = []
    for group in optimizer.param_groups:
        for p in group['params']:
            out.append(p)
            st = optimizer.state.get(p, {})
            out += [st[k] for k in sorted(st) if torch.is_tensor(st[k])]
    return out


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
        """The whole (B, F, ...) tensor from every rank's part `x`; the
        gradient is this rank's part of the whole's."""
        if self.replicated:
            return x
        (r0, r1), (f0, f1) = self.rows, self.frames

        def assemble(pieces):
            out = x.new_empty((self.b, self.f, *x.shape[2:]))
            i = 0
            for d in range(self.mesh.dp):
                for s in range(self.mesh.sp):
                    (a0, a1), (b0, b1) = self.slices_at(d, s)
                    out[a0:a1, b0:b1] = pieces[i]
                    i += 1
            return out
        return _Gather.apply(x, self.mesh.group('dpsp'), assemble,
                             lambda g: g[r0:r1, f0:f1])

    def describe(self) -> str:
        return (f'B={self.b} F={self.f} spec {self.spec}: rows '
                f'{self.rows} frames {self.frames}')


def layout_for(b: int, f: int, mesh: Mesh, replicate: bool = False):
    spec = (None, None) if replicate else video_spec(b, f, mesh)
    return Layout(mesh=mesh, b=b, f=f, spec=spec)


def batch_layout(b: int, f: int, mesh: Mesh) -> Layout:
    """The trainer batch's layout (the JAX package's `batch_sharding`: B
    over dp, F over sp), an axis split only where its extent divides (B = 1
    with dp > 1 stays replicated): `video_sharding`'s rule."""
    return Layout(mesh=mesh, b=b, f=f, spec=video_sharding((b, f), mesh))


_VIDEO_KEYS = ('pixels', 'latent_mean', 'latent_logvar')


def shard_batch(batch: dict, mesh: Mesh) -> dict:
    """This rank's part of a trainer batch (the JAX package's rule):
    `pixels` and the cached `latent_mean` / `latent_logvar` (B, F, ...) by
    `batch_layout`, `pred_tracks` (F, P, 2) over sp, everything else
    replicated."""
    video = next(batch[k] for k in _VIDEO_KEYS if k in batch)
    lay = batch_layout(video.shape[0], video.shape[1], mesh)
    f0, f1 = lay.frames
    out = {}
    for k, v in batch.items():
        if k in _VIDEO_KEYS:
            out[k] = lay.take(v)
        elif k == 'pred_tracks':
            out[k] = v[f0:f1]
        else:
            out[k] = v
    return out


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


def rerun_in_scope(fn):
    """`fn` wrapped to run under the U-Net call's layout active now: a
    segment recomputed in the backward pass (outside the call) issues the
    same collectives as its forward did."""
    run = active()
    if run is None:
        return fn
    layout, after = run.layout, run.after

    def wrapped(*args, **kwargs):
        again = VideoRun(run.mesh, layout, after)
        with video_run(again):
            out = fn(*args, **kwargs)
        run.layout = again.layout          # a CFG doubling inside `fn`
        return out
    return wrapped


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
    other sp ranks' frames through an all-to-all over sp. Differentiable:
    the inverse all-to-all backward, and x's gradient summed over tp."""
    b, fl, el, c = x.shape
    n, t = split['n'], split['t']
    # the tp ranks hold the same x and take different locations: the
    # gradient of x is the sum of their chunks'
    x = copy_to_tp(x, split['tg'])
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
    per_t = gather_parts(recv, split['tg'])               # [t'][s2]
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


@torch.no_grad()
def shard_text_encoder(text_encoder, mesh: Mesh) -> dict:
    """Cut the CLIP text encoder's attention and MLP weights (in place) to
    tp rank t's shards: q_proj, k_proj, v_proj and mlp.fc1 keep their output
    rows and those rows' biases (column parallel), out_proj and mlp.fc2
    their input columns, the bias on tp rank 0 alone (row parallel); the
    heads split over tp. Returns {state-dict key: full -> local} for each
    tensor cut, as `shard_unet` does."""
    from videoswap_torch.models.clip_text import CLIPAttention, CLIPMLP
    tp, t = mesh.tp, mesh.coord[2]
    group = mesh.group('tp')
    slicers = {}
    if tp == 1:
        return slicers

    def put(name, lin, attr, fn):
        p = getattr(lin, attr)
        p.data = fn(p.data).contiguous()
        slicers[f'{name}{attr}'] = fn

    def col(w):
        return _col(w, t, tp)

    for name, mod in text_encoder.named_modules():
        name = f'{name}.' if name else ''
        if isinstance(mod, CLIPAttention):
            if mod.heads % tp:
                raise ValueError(f'{mod.heads} heads do not split over '
                                 f'tp={tp}')
            for pn in ('q_proj', 'k_proj', 'v_proj'):
                for attr in ('weight', 'bias'):
                    put(f'{name}{pn}.', getattr(mod, pn), attr, col)
            out, out_name = mod.out_proj, 'out_proj'
            mod.heads //= tp
        elif isinstance(mod, CLIPMLP):
            if mod.fc1.out_features % tp:
                raise ValueError(f'{mod.fc1.out_features} hidden units do '
                                 f'not split over tp={tp}')
            for attr in ('weight', 'bias'):
                put(f'{name}fc1.', mod.fc1, attr, col)
            out, out_name = mod.fc2, 'fc2'
        else:
            continue
        put(f'{name}{out_name}.', out, 'weight', lambda w: _row(w, t, tp))
        put(f'{name}{out_name}.', out, 'bias', lambda b: bias_on_rank(b, t))
        mod.tp_group = group
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
