"""Point-drag displacement propagation through a trained atlas.

The counterpart of videoswap_tpu/atlas/propagate.py. A user drags named
points on one keyframe; the keyframe displacement maps to canonical UV
through the local Jacobian of the FG mapping (finite differences), and the
inverse mapping's Jacobian maps the UV delta back to every frame; alpha
gates visibility; the edited tracks replace the point file's.

The functions work on CPU fp32 tensors and numpy; the closures of
`bind_nets` run the nets on their own device.
"""

from __future__ import annotations

import numpy as np
import torch

from . import losses


def compute_wm(xyt: torch.Tensor, fn, deltax: float,
               deltay: float) -> torch.Tensor:
    """Finite-difference Jacobian rows: (N, 2, out_dim)."""
    dx, dy = xyt.clone(), xyt.clone()
    dx[:, 0] += deltax
    dy[:, 1] += deltay
    base = fn(xyt)
    jac_x = (fn(dx) - base) / deltax
    jac_y = (fn(dy) - base) / deltay
    return torch.stack([jac_x, jac_y], dim=1)


def _frames_uvt(uv: torch.Tensor, num_frames: int, norm_t) -> torch.Tensor:
    frames_t = norm_t(torch.arange(num_frames, dtype=torch.float32))[:, None]
    return torch.cat([uv.expand(num_frames, 2), frames_t], dim=-1)


def propagate_point(x, y, target_x, target_y, t, num_frames: int,
                    fg_map, fg_inv, norm_s, norm_t) -> torch.Tensor:
    """Per-frame displacement (normalised coords) of a dragged point:
    (num_frames, 2)."""
    xyt = torch.tensor([[norm_s(x), norm_s(y), norm_t(t)]],
                       dtype=torch.float32)
    uv = fg_map(xyt)                                        # (1, 2)
    wm = compute_wm(xyt, fg_map, deltax=0.1, deltay=0.05)   # (1, 2, 2)
    dxdy = torch.tensor([[[norm_s(target_x) - norm_s(x),
                           norm_s(target_y) - norm_s(y)]]],
                        dtype=torch.float32)
    delta_uv = torch.einsum('bij,bjk->bik', dxdy, wm)       # (1, 1, 2)
    uvt = _frames_uvt(uv, num_frames, norm_t)
    wm_inv = compute_wm(uvt, fg_inv, deltax=0.1, deltay=0.05)[..., :2]
    delta_xy = torch.einsum('bij,bjk->bik',
                            delta_uv.expand(num_frames, 1, 2), wm_inv)
    return delta_xy[:, 0, :]


def propagate_point_sequence(source_points: dict, target_points: dict,
                             keyframe_t: int, pred_tracks: np.ndarray,
                             point_name2id: dict, fg_map, fg_inv, f_alpha,
                             larger_dim: int, num_frames: int,
                             norm_s, norm_t) -> np.ndarray:
    """Rewrite pred_tracks (F, P, 2) for every edited point. source and
    target points: {name: [y, x]}, as the annotation files hold them."""
    tracks = np.array(pred_tracks, np.float32)
    for name, v in source_points.items():
        if name not in target_points or len(v) == 0:
            continue
        point_idx = point_name2id[name]
        tracks[:, point_idx, :] = -1.0
        sy, sx = v
        ty, tx = target_points[name]

        src_xyt = torch.tensor([[norm_s(sx), norm_s(sy), norm_t(keyframe_t)]],
                               dtype=torch.float32)
        base_xyt = fg_inv(_frames_uvt(fg_map(src_xyt), num_frames, norm_t))
        delta_xy = propagate_point(sx, sy, tx, ty, keyframe_t, num_frames,
                                   fg_map, fg_inv, norm_s, norm_t)
        warp_xy = (base_xyt[:, :2] + delta_xy).numpy()
        alpha = losses.scaled_alpha(f_alpha(base_xyt))[:, 0].numpy()

        vis = alpha > 0.5
        px = np.round((warp_xy[:, 0] + 1) / 2 * larger_dim)
        py = np.round((warp_xy[:, 1] + 1) / 2 * larger_dim)
        tracks[vis, point_idx, 0] = px[vis]
        tracks[vis, point_idx, 1] = py[vis]
    return tracks


def bind_nets(nets: dict):
    """(fg_map, fg_inv, f_alpha): closures that take CPU fp32 coordinates,
    run the net on its device without autograd, and return CPU fp32."""
    def bind(net):
        dev = net.hidden_0.weight.device

        @torch.no_grad()
        def fn(x):
            return net(x.to(dev)).float().cpu()
        return fn
    return (bind(nets['FG_UV_Mapping']), bind(nets['FG_UV_Mapping_Inverse']),
            bind(nets['F_Alpha']))
