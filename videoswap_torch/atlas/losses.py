"""Layered-neural-atlas losses as plain functions.

The counterpart of videoswap_tpu/atlas/losses.py, function for function.
The `*_pre` forms take precomputed evaluations (what the batched trainer
step feeds them); the callable forms evaluate the nets themselves, for
composition and tests. Data-dependent selections are masked means.

Data parallel (`split_points(group, parts)`, the atlas trainer's dp mesh):
each rank holds 1/parts of the step's points, and every mean is global:
the rank's own sum over the whole batch's count (a mask's count summed over
the group). A rank's loss is then its share of the global loss; the sum of
the ranks' gradients is the global loss's.
"""

from __future__ import annotations

import contextlib

import torch

from videoswap_torch.parallel import sharding

_SPLITS: list = []


@contextlib.contextmanager
def split_points(group, parts: int):
    """Means over points split in `parts` equal shards over `group`."""
    _SPLITS.append((group, parts))
    try:
        yield
    finally:
        _SPLITS.pop()


def mean(x: torch.Tensor) -> torch.Tensor:
    """The mean over every point of the step: `x.mean()`, or with the
    points split over ranks, this rank's sum over the whole count."""
    if not _SPLITS:
        return x.mean()
    return x.sum() / (x.numel() * _SPLITS[-1][1])


def global_count(m: torch.Tensor) -> torch.Tensor:
    """The number of selected points in the whole step (no gradient)."""
    n = m.sum()
    if _SPLITS:
        n = sharding.all_reduce_sum(n.detach(), _SPLITS[-1][0], n.dtype)
    return n


def masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask.float()
    return (values * m).sum() / torch.clamp(global_count(m), min=1.0)


def safe_norm(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with a finite gradient at 0 (masked-out zero rows must not
    poison the backward pass)."""
    return torch.sqrt(torch.sum(x * x, dim=dim) + 1e-12)


def _norm2(x: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(x, dim=-1) ** 2


def scaled_alpha(raw: torch.Tensor) -> torch.Tensor:
    """tanh output -> (0.001, 0.991), away from log's poles."""
    return (0.5 * (raw + 1.0)) * 0.99 + 0.001


def atlas_rgb(f_atlas, uv: torch.Tensor, layer: str) -> torch.Tensor:
    """FG colours sampled from the +0.5 quadrant, BG from -0.5."""
    shift = 0.5 if layer == 'fg' else -0.5
    return (f_atlas(uv * 0.5 + shift) + 1.0) * 0.5


def reconstruct_rgb(fg_uv, bg_uv, alpha, f_atlas):
    rgb_fg = atlas_rgb(f_atlas, fg_uv, 'fg')
    rgb_bg = atlas_rgb(f_atlas, bg_uv, 'bg')
    return rgb_fg * alpha + rgb_bg * (1.0 - alpha), rgb_fg, rgb_bg


def rgb_loss(rgb_out: torch.Tensor, rgb_gt: torch.Tensor) -> torch.Tensor:
    return mean(_norm2(rgb_out - rgb_gt))


def alpha_bce_loss(alpha: torch.Tensor,
                   alpha_gt: torch.Tensor) -> torch.Tensor:
    return mean(-alpha_gt * torch.log(alpha)
                      - (1 - alpha_gt) * torch.log(1 - alpha))


def sparsity_loss(rgb_fg: torch.Tensor, alpha: torch.Tensor) -> torch.Tensor:
    """Penalise FG atlas colours where alpha ~ 0."""
    return mean(_norm2(rgb_fg * (1.0 - alpha)))


def gradient_loss_pre(rgb_out, rgb_out_x1, rgb_out_y1, dx_gt, dy_gt):
    d_out_x = rgb_out_x1 - rgb_out
    d_out_y = rgb_out_y1 - rgb_out
    return mean(_norm2(dx_gt - d_out_x) + _norm2(dy_gt - d_out_y))


def gradient_loss(xyf, rgb_out, dx_gt, dy_gt, fg_map, bg_map, f_alpha,
                  f_atlas, norm_s, norm_t):
    """Finite-difference image-gradient reconstruction. xyf: (N, 3) integer
    coords; dx_gt/dy_gt: (N, 3) I(x+1) - I(x), I(y+1) - I(y)."""
    x, y, f = xyf[:, 0], xyf[:, 1], xyf[:, 2]

    def xyt(px, py):
        return torch.stack([norm_s(px), norm_s(py), norm_t(f)], dim=-1)

    out = {}
    for tag, p in (('x', xyt(x + 1, y)), ('y', xyt(x, y + 1))):
        a = scaled_alpha(f_alpha(p))
        out[tag], _, _ = reconstruct_rgb(fg_map(p), bg_map(p), a, f_atlas)
    return gradient_loss_pre(rgb_out, out['x'], out['y'], dx_gt, dy_gt)


def rigidity_loss_all(uv, uv_xm, uv_ym, derivative_amount: int,
                      larger_dim: int,
                      uv_mapping_scale: float) -> torch.Tensor:
    """Per-point rigidity: |J^T J| + |(J^T J)^-1| of the mapping's
    finite-difference Jacobian."""
    scale = larger_dim / 2.0 / uv_mapping_scale / derivative_amount
    du_dx = (uv[:, 0] - uv_xm[:, 0]) * scale
    du_dy = (uv[:, 0] - uv_ym[:, 0]) * scale
    dv_dx = (uv[:, 1] - uv_xm[:, 1]) * scale
    dv_dy = (uv[:, 1] - uv_ym[:, 1]) * scale
    a = du_dx ** 2 + dv_dx ** 2 + 0.001
    b = du_dx * du_dy + dv_dx * dv_dy
    c = b
    dd = du_dy ** 2 + dv_dy ** 2 + 0.001
    jtj_norm = torch.sqrt(a ** 2 + b ** 2 + c ** 2 + dd ** 2)
    det = a * dd - b * c
    inv_norm = jtj_norm / torch.clamp(det.abs(), min=1e-9)
    return jtj_norm + inv_norm


def rigidity_loss_pre(uv, uv_xm, uv_ym, derivative_amount: int,
                      larger_dim: int,
                      uv_mapping_scale: float) -> torch.Tensor:
    return mean(rigidity_loss_all(uv, uv_xm, uv_ym, derivative_amount,
                                  larger_dim, uv_mapping_scale))


def rigidity_loss(xyf, uv, uv_map, derivative_amount: int, larger_dim: int,
                  uv_mapping_scale: float, norm_s, norm_t) -> torch.Tensor:
    x, y, f = xyf[:, 0], xyf[:, 1], xyf[:, 2]
    d = derivative_amount
    p_ym = torch.stack([norm_s(x), norm_s(y - d), norm_t(f)], dim=-1)
    p_xm = torch.stack([norm_s(x - d), norm_s(y), norm_t(f)], dim=-1)
    return rigidity_loss_pre(uv, uv_map(p_xm), uv_map(p_ym), d,
                             larger_dim, uv_mapping_scale)


def _flow_match_coords(xyf, flows, direction: int, norm_s, norm_t):
    """Coords moved by the forward (+1) or backward (-1) flow."""
    x, y, f = xyf[:, 0], xyf[:, 1], xyf[:, 2]
    fl = flows[f, y, x]
    mx = x.float() + fl[:, 0]
    my = y.float() + fl[:, 1]
    mf = (f + direction).float()
    return torch.stack([norm_s(mx), norm_s(my), norm_t(mf)], dim=-1)


def optical_flow_loss_pre(uv, uv_match_f, uv_match_b, valid_f, valid_b,
                          larger_dim: int, uv_mapping_scale: float,
                          alpha=None) -> torch.Tensor:
    unit = larger_dim / 2.0 / uv_mapping_scale
    total = 0.0
    for uv_match, valid in ((uv_match_f, valid_f), (uv_match_b, valid_b)):
        err = safe_norm(uv_match - uv) * unit
        if alpha is not None:
            err = err * alpha[:, 0]
        total = total + masked_mean(err, valid) * 0.5
    return total


def optical_flow_loss(xyf, uv, uv_map, flows, flow_masks, flows_rev,
                      flow_masks_rev, larger_dim: int,
                      uv_mapping_scale: float, norm_s, norm_t,
                      alpha=None) -> torch.Tensor:
    """UV consistency along the forward and backward flow. flows: (F, H,
    W, 2); masks: (F, H, W) consistency masks."""
    x, y, f = xyf[:, 0], xyf[:, 1], xyf[:, 2]
    match_f = _flow_match_coords(xyf, flows, 1, norm_s, norm_t)
    match_b = _flow_match_coords(xyf, flows_rev, -1, norm_s, norm_t)
    return optical_flow_loss_pre(
        uv, uv_map(match_f), uv_map(match_b),
        flow_masks[f, y, x], flow_masks_rev[f, y, x],
        larger_dim, uv_mapping_scale, alpha=alpha)


def optical_flow_loss_all(uv, uv_match_f, valid_f, larger_dim: int,
                          uv_mapping_scale: float, alpha=None):
    """Per-point forward-flow UV error, zero where the flow is not
    consistent, scaled by alpha and the pixel unit."""
    unit = larger_dim / (2.0 * uv_mapping_scale)
    err = safe_norm(uv_match_f - uv)
    err = torch.where(valid_f > 0, err, 0.0)
    if alpha is not None:
        err = err * alpha[:, 0]
    return err * unit


def flow_alpha_loss_all(alpha, a_match_f, valid_f) -> torch.Tensor:
    """Per-point forward-flow alpha error."""
    err = torch.abs(alpha - a_match_f)[:, 0]
    return torch.where(valid_f > 0, err, 0.0)


def optical_flow_alpha_loss_pre(alpha, a_match_f, a_match_b, valid_f,
                                valid_b) -> torch.Tensor:
    total = 0.0
    for a_match, valid in ((a_match_f, valid_f), (a_match_b, valid_b)):
        err = torch.abs(alpha - a_match)[:, 0]
        total = total + masked_mean(err, valid) * 0.5
    return total


def optical_flow_alpha_loss(xyf, alpha, f_alpha, flows, flow_masks,
                            flows_rev, flow_masks_rev, norm_s,
                            norm_t) -> torch.Tensor:
    """Alpha consistency along the flow."""
    x, y, f = xyf[:, 0], xyf[:, 1], xyf[:, 2]
    match_f = _flow_match_coords(xyf, flows, 1, norm_s, norm_t)
    match_b = _flow_match_coords(xyf, flows_rev, -1, norm_s, norm_t)
    return optical_flow_alpha_loss_pre(
        alpha, scaled_alpha(f_alpha(match_f)),
        scaled_alpha(f_alpha(match_b)),
        flow_masks[f, y, x], flow_masks_rev[f, y, x])
