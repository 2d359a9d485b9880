"""Layered-neural-atlas training: the 8-term-loss main step, the
inverse-mapping step and UV-mapping pretraining.

The counterpart of videoswap_tpu/atlas/trainer.py `AtlasTrainer`, in fp32:

- every per-point data plane lives in one (F, H, W, 16) array on the
  device, so a step's sampled batch takes one gather;
- the main step evaluates each net once over the concatenation of every
  point set the losses need (F_Atlas on six sites: the reconstructions at
  the point and at x + 1 and y + 1, FG and BG), in the JAX package's loss
  order; the step-gated terms (alpha BCE until `pretrain_alpha_iter`,
  global rigidity until `pretrain_global_rigidity_iter`) are Python
  conditions on the step number;
- one Adam (optax's defaults, which torch's are) for the four main nets,
  another for the inverse mapping, which regresses the coordinates from the
  FG UVs with the FG mapping held fixed;
- coordinates come from a `torch.Generator` on the device; `step` and
  `inverse_step` also take explicit draws (x, y, f), so that a test can
  feed both packages the same ones;
- data parallel over a mesh (N, 1, 1) (`mesh`, the JAX package's dp mesh):
  every rank draws the whole batch from the same generator and keeps its
  1/N of the points, at the JAX package's three sites (UV pretraining, the
  main step, the inverse step); every mean is global (`losses.split_points`:
  the rank's own sum over the whole batch's count); the nets' gradients,
  the hash tables' included (the hash-grid kernel's fp32 result on the
  rank's own points), are summed over the ranks in fp32, in the same order
  on every rank, so every rank ends a step with the same bits; the loss
  terms it returns are the ranks' shares summed. The sum of fp32 shares is
  not the unsharded step's bits (that would need the kernel's int64
  fixed-point tables summed before their conversion); it is within fp32
  rounding of it.

`run_steps` is a Python loop, where the JAX package scans its dispatches.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch

from videoswap_torch.parallel import sharding

from . import losses
from .imlp import init_imlp

MAIN_NETS = ('FG_UV_Mapping', 'BG_UV_Mapping', 'F_Alpha', 'F_Atlas')
INVERSE_NET = 'FG_UV_Mapping_Inverse'
# channels of the fused per-pixel array
RGB, MASK, DX, DY, FLOW_F, FLOW_B, VALID_F, VALID_B = (
    slice(0, 3), 3, slice(4, 7), slice(7, 10), slice(10, 12), slice(12, 14),
    14, 15)


def fuse_data(data: dict, device) -> torch.Tensor:
    """The (F, H, W, 16) fp32 array of rgb, mask, dx, dy, forward and
    backward flow and their consistency masks, on `device`."""
    t = {k: torch.as_tensor(v).to(device=device, dtype=torch.float32)
         for k, v in data.items()}
    return torch.cat([t['video'], t['mask'][..., None], t['dx'], t['dy'],
                      t['flows'], t['flows_rev'],
                      t['flow_masks'][..., None],
                      t['flow_masks_rev'][..., None]], dim=-1)


class AtlasTrainer:
    def __init__(self, nets: dict, data: dict, train_opt: dict,
                 larger_dim: int, num_frames: int, device=None, mesh=None):
        """nets: name -> IMLP (moved to `device`); data: the arrays of
        `load_input_data` (numpy or tensors); device: None means 'cuda';
        mesh: a (N, 1, 1) `parallel.Mesh` to split each step's points over
        (the nets' weights are then broadcast from its first rank)."""
        self.device = torch.device('cuda' if device is None else device)
        self.nets = {n: net.to(self.device) for n, net in nets.items()}
        if mesh is not None and (mesh.sp, mesh.tp) != (1, 1):
            raise ValueError(f'the atlas splits points over dp alone, not '
                             f'{mesh.describe()}')
        self.mesh = mesh if mesh is not None and mesh.size > 1 else None
        self.replicate()
        self.train_opt = train_opt
        self.larger_dim, self.num_frames = larger_dim, num_frames
        self.lr = float(train_opt.get('optimizer', {}).get('lr', 1e-4))
        self.uv_scale = float(train_opt.get('uv_mapping_scale', 0.8))
        self.batch = int(train_opt.get('sample_batch_size', 10000))
        self.d_amt = int(train_opt.get('derivative_amount', 1))
        self.gd_amt = int(train_opt.get('global_derivative_amount', 100))
        self.pre_alpha = int(train_opt.get('pretrain_alpha_iter', 0))
        self.pre_grigid = int(train_opt.get('pretrain_global_rigidity_iter',
                                            0))
        self.fused = fuse_data(data, self.device)
        self.res_y, self.res_x = self.fused.shape[1:3]
        self.init_opt_state()

    # normalisation of pixel and frame coordinates to [-1, 1]
    def norm_s(self, v):
        return v / (self.larger_dim / 2.0) - 1.0

    def norm_t(self, v):
        return v / (self.num_frames / 2.0) - 1.0

    def init_params(self, generator: torch.Generator) -> None:
        """Seeded weights on flax's scales, net by net."""
        for net in self.nets.values():
            init_imlp(net, generator)
        self.replicate()

    def replicate(self) -> None:
        """Data parallel: every net's weights from the mesh's first rank."""
        for net in self.nets.values():
            sharding.replicate_tree(list(net.parameters()), self.mesh)

    # ------------------------------------------------------- data parallel
    def _points(self):
        """The means' split of the points over the mesh (a no-op
        without one)."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return losses.split_points(self.mesh.group('all'), self.mesh.dp)

    def _own(self, *arrs):
        """This rank's 1/dp of (batch,)-leading draws."""
        if self.mesh is None:
            return arrs
        n, dp = arrs[0].shape[0], self.mesh.dp
        if n % dp:
            raise ValueError(f'sample_batch_size {n} must divide dp={dp}')
        k = self.mesh.coord[0] * (n // dp)
        return tuple(a[k:k + n // dp] for a in arrs)

    def _reduce(self, params) -> None:
        """The ranks' gradients of `params` summed over dp."""
        sharding.reduce_gradients(params, self.mesh, ('dp',))

    def _gathered(self, ld: dict) -> dict:
        """The loss terms of every rank's points summed (detached)."""
        if self.mesh is None:
            return {k: v.detach() for k, v in ld.items()}
        keys = list(ld)
        total = sharding.sum_distinct(torch.stack(
            [torch.as_tensor(ld[k]).detach().float() for k in keys]),
            self.mesh, ('dp',))
        return dict(zip(keys, total.unbind(0)))

    def init_opt_state(self) -> None:
        """Fresh Adams: one for the main nets, one for the inverse net."""
        self.opt_main = torch.optim.Adam(
            [p for n in MAIN_NETS for p in self.nets[n].parameters()],
            lr=self.lr)
        self.opt_inv = (torch.optim.Adam(self.nets[INVERSE_NET].parameters(),
                                         lr=self.lr)
                        if INVERSE_NET in self.nets else None)

    def sample(self, generator: torch.Generator, batch: Optional[int] = None):
        """Uniform pixel coordinates (x, y, f), int64 on the device."""
        n = batch or self.batch
        kw = dict(generator=generator, device=self.device)
        return (torch.randint(0, self.res_x, (n,), **kw),
                torch.randint(0, self.res_y, (n,), **kw),
                torch.randint(0, self.num_frames, (n,), **kw))

    def _xyt(self, x, y, f):
        return torch.stack([self.norm_s(x), self.norm_s(y), self.norm_t(f)],
                           dim=-1).float()

    # ------------------------------------------------------------- pretrain
    def pretrain_mapping(self, name: str, generator: torch.Generator,
                         iters: int, batch: int = 10000) -> float:
        """Fit a UV mapping to uv_mapping_scale * xy, with its own Adam at
        1e-4, for iters x num_frames iterations. Returns the last loss."""
        net = self.nets[name]
        opt = torch.optim.Adam(net.parameters(), lr=1e-4)
        loss = torch.zeros(())
        for _ in range(iters * self.num_frames):
            xyt = self._xyt(*self._own(*self.sample(generator, batch)))
            with self._points():
                loss = losses.mean(losses.safe_norm(
                    xyt[:, :2] * self.uv_scale - net(xyt)))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            self._reduce(net.parameters())
            opt.step()
        return self._gathered({'loss': loss})['loss'].item()

    # ----------------------------------------------------------------- step
    def loss_fn(self, global_step: int, x, y, f):
        """(total loss, dict of every term) at the draws x, y, f."""
        cfg = self.train_opt['loss_cfg']
        w_rec = cfg['reconstruction_loss']
        nets = self.nets
        d_amt, gd_amt = self.d_amt, self.gd_amt
        pt = self.fused[f, y, x]                    # one gather, 16 channels
        n = x.shape[0]

        def match(fl, direction):
            return torch.stack(
                [self.norm_s(x.float() + fl[:, 0]),
                 self.norm_s(y.float() + fl[:, 1]),
                 self.norm_t((f + direction).float())], dim=-1)

        match_f, match_b = match(pt[:, FLOW_F], 1), match(pt[:, FLOW_B], -1)
        # main, x+1, y+1, x-d, y-d, x-gd, y-gd, flow_f, flow_b
        pts = [self._xyt(x, y, f), self._xyt(x + 1, y, f),
               self._xyt(x, y + 1, f), self._xyt(x - d_amt, y, f),
               self._xyt(x, y - d_amt, f), self._xyt(x - gd_amt, y, f),
               self._xyt(x, y - gd_amt, f), match_f, match_b]
        pts9 = torch.cat(pts)
        uv_fg9 = nets['FG_UV_Mapping'](pts9)
        uv_bg9 = nets['BG_UV_Mapping'](pts9)

        def s(arr, i):
            return arr[i * n:(i + 1) * n]

        al5 = losses.scaled_alpha(nets['F_Alpha'](torch.cat(
            [pts[0], pts[1], pts[2], match_f, match_b])))
        alpha = s(al5, 0)
        # F_Atlas at the six (uv, layer) sites, quadrant shift per slice
        at6 = (nets['F_Atlas'](torch.cat(
            [s(uv_fg9, 0) * 0.5 + 0.5, s(uv_bg9, 0) * 0.5 - 0.5,
             s(uv_fg9, 1) * 0.5 + 0.5, s(uv_bg9, 1) * 0.5 - 0.5,
             s(uv_fg9, 2) * 0.5 + 0.5, s(uv_bg9, 2) * 0.5 - 0.5])) + 1.0) * 0.5
        rgb_fg = s(at6, 0)

        def recon(i, a):
            return s(at6, 2 * i) * a + s(at6, 2 * i + 1) * (1.0 - a)

        rgb_out = recon(0, alpha)
        uv_fg, uv_bg = s(uv_fg9, 0), s(uv_bg9, 0)

        ld = {}
        total = 0.0
        ld['gradient_loss'] = losses.gradient_loss_pre(
            rgb_out, recon(1, s(al5, 1)), recon(2, s(al5, 2)), pt[:, DX],
            pt[:, DY])
        total += w_rec['gradient_loss_weight'] * ld['gradient_loss']
        ld['rgb_loss'] = losses.rgb_loss(rgb_out, pt[:, RGB])
        total += w_rec['rgb_loss_weight'] * ld['rgb_loss']
        ld['alpha_loss'] = losses.alpha_bce_loss(alpha, pt[:, MASK:MASK + 1])
        if global_step <= self.pre_alpha:
            total += w_rec['alpha_loss_weight'] * ld['alpha_loss']
        ld['sparsity_loss'] = losses.sparsity_loss(rgb_fg, alpha)
        total += (cfg['sparsity_loss']['sparsity_loss_weight']
                  * ld['sparsity_loss'])

        rig = cfg['rigidity_loss']
        for tag, uv9, uv in (('fg', uv_fg9, uv_fg), ('bg', uv_bg9, uv_bg)):
            r = losses.rigidity_loss_pre(uv, s(uv9, 3), s(uv9, 4), d_amt,
                                         self.larger_dim, self.uv_scale)
            ld[f'rigidity_loss_{tag}'] = r
            total += rig['rigidity_loss_weight'] * r
            g = losses.rigidity_loss_pre(uv, s(uv9, 5), s(uv9, 6), gd_amt,
                                         self.larger_dim, self.uv_scale)
            ld[f'global_rigidity_loss_{tag}'] = g
            if global_step <= self.pre_grigid:
                total += rig[f'global_rigidity_{tag}_loss_weight'] * g

        valid_f, valid_b = pt[:, VALID_F], pt[:, VALID_B]
        for tag, uv9, uv, a in (('fg', uv_fg9, uv_fg, alpha),
                                ('bg', uv_bg9, uv_bg, 1 - alpha)):
            fl = losses.optical_flow_loss_pre(
                uv, s(uv9, 7), s(uv9, 8), valid_f, valid_b, self.larger_dim,
                self.uv_scale, alpha=a)
            ld[f'flow_loss_{tag}'] = fl
            total += cfg['flow_loss']['flow_loss_weight'] * fl

        fa = losses.optical_flow_alpha_loss_pre(alpha, s(al5, 3), s(al5, 4),
                                                valid_f, valid_b)
        ld['flow_alpha_loss'] = fa
        total += cfg['flow_loss']['alpha_flow_loss_weight'] * fa
        ld['total_loss'] = total
        return total, ld

    def step(self, global_step: int, generator=None, draws=None) -> dict:
        """One main iteration: sample (or take the whole batch's `draws`),
        losses, backward, Adam. Returns the loss terms (detached, on the
        device). The gradients stay on the parameters until the next
        step."""
        x, y, f = self._own(*(draws if draws is not None
                              else self.sample(generator)))
        with self._points():
            total, ld = self.loss_fn(global_step, x, y, f)
        self.opt_main.zero_grad(set_to_none=True)
        total.backward()
        self._reduce([p for n in MAIN_NETS
                      for p in self.nets[n].parameters()])
        self.opt_main.step()
        return self._gathered(ld)

    def inverse_step(self, generator=None, draws=None) -> torch.Tensor:
        """One inverse-mapping iteration on the FG pixels of the draws."""
        x, y, f = self._own(*(draws if draws is not None
                              else self.sample(generator)))
        xyt = self._xyt(x, y, f)
        fg_mask = self.fused[f, y, x, MASK]
        with torch.no_grad():
            uv = self.nets['FG_UV_Mapping'](xyt)
        pred = self.nets[INVERSE_NET](torch.cat([uv, xyt[:, 2:]], dim=-1))
        with self._points():
            loss = losses.masked_mean(losses.safe_norm(pred - xyt),
                                      fg_mask == 1)
        self.opt_inv.zero_grad(set_to_none=True)
        loss.backward()
        self._reduce(self.nets[INVERSE_NET].parameters())
        self.opt_inv.step()
        return self._gathered({'loss': loss})['loss']

    def run_steps(self, start_step: int, n: int,
                  generator: torch.Generator) -> dict:
        """Iterations start_step + 1 .. start_step + n, each a main step then
        (with an inverse net) an inverse step. Returns the last losses."""
        ld = {}
        for it in range(start_step + 1, start_step + n + 1):
            ld = self.step(it, generator)
            if self.opt_inv is not None:
                ld['fg_inv_loss'] = self.inverse_step(generator)
        return ld
