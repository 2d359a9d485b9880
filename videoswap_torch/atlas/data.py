"""Atlas input data: frames, masks, flows and their consistency masks.

The counterpart of videoswap_tpu/atlas/data.py. The flow arithmetic
(`bilinear_sample`, `warp_flow`, `compute_consistency`,
`get_consistency_mask`) is written in torch, in float64 as the JAX
package's numpy computes it, so that it runs on the card for a clip that
lives there; it takes tensors or numpy arrays. `resize_flow` and
`load_input_data` read and resize with PIL, imported inside them, so this
module imports on a machine without PIL. Layout is frame-major (F, H, W, ...).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def bilinear_sample(img, x, y) -> torch.Tensor:
    """img[y, x] with bilinear interpolation; out-of-range coordinates clamp
    to the border (consistency masking makes the border immaterial)."""
    img, x, y = (torch.as_tensor(a) for a in (img, x, y))
    x, y = x.double(), y.double()
    h, w = img.shape[:2]
    x0 = torch.floor(x).long().clamp(0, w - 1)
    y0 = torch.floor(y).long().clamp(0, h - 1)
    x1 = (x0 + 1).clamp(0, w - 1)
    y1 = (y0 + 1).clamp(0, h - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    v00, v01 = img[y0, x0], img[y0, x1]
    v10, v11 = img[y1, x0], img[y1, x1]
    return ((v00 * (1 - fx) + v01 * fx) * (1 - fy)
            + (v10 * (1 - fx) + v11 * fx) * fy)


def warp_flow(img, flow) -> torch.Tensor:
    img, flow = torch.as_tensor(img), torch.as_tensor(flow)
    h, w = flow.shape[:2]
    yy, xx = torch.meshgrid(
        torch.arange(h, dtype=torch.float64, device=flow.device),
        torch.arange(w, dtype=torch.float64, device=flow.device),
        indexing='ij')
    return bilinear_sample(img, xx + flow[..., 0].double(),
                           yy + flow[..., 1].double())


def compute_consistency(flow12, flow21) -> torch.Tensor:
    flow12 = torch.as_tensor(flow12)
    diff = flow12.double() + warp_flow(flow21, flow12)
    return torch.sqrt(diff[..., 0] ** 2 + diff[..., 1] ** 2)


def get_consistency_mask(flow_fwd, flow_bwd, thresh: float = 1.0):
    """(forward mask, backward mask), bool (H, W): where following a flow
    and then the other one comes back within `thresh` pixels."""
    return (compute_consistency(flow_fwd, flow_bwd) < thresh,
            compute_consistency(flow_bwd, flow_fwd) < thresh)


def resize_flow(flow: np.ndarray, newh: int, neww: int) -> np.ndarray:
    """PIL bilinear resize of a (H, W, 2) float32 flow. The x channel is
    scaled by newh / oldh and the y channel by neww / oldw, as the
    reference does."""
    from PIL import Image
    oldh, oldw = flow.shape[:2]
    out = np.stack([
        np.asarray(Image.fromarray(flow[..., c]).resize(
            (neww, newh), Image.BILINEAR)) for c in range(2)], axis=-1)
    out[..., 0] *= newh / oldh
    out[..., 1] *= neww / oldw
    return out


def _resize_img(arr: np.ndarray, neww: int, newh: int,
                nearest: bool = False) -> np.ndarray:
    from PIL import Image
    mode = Image.NEAREST if nearest else Image.BILINEAR
    if arr.ndim == 2:
        return np.asarray(Image.fromarray(arr).resize((neww, newh), mode))
    return np.stack([
        np.asarray(Image.fromarray(arr[..., c]).resize((neww, newh), mode))
        for c in range(arr.shape[-1])], axis=-1)


def load_input_data(datasets_opt: dict) -> dict:
    """Read a clip's frames, masks and flows (.npy files holding the
    forward and backward flow of each frame pair). Returns float32 numpy
    arrays: video (F,H,W,3), mask (F,H,W), dx/dy (F,H,W,3),
    flows/flows_rev (F,H,W,2), flow_masks/flow_masks_rev (F,H,W)."""
    from PIL import Image
    res_x, res_y = datasets_opt['res_x'], datasets_opt['res_y']
    frame_files = sorted(Path(datasets_opt['frame_path']).iterdir())
    mask_files = sorted(Path(datasets_opt['mask_path']).iterdir())
    flow_files = sorted(Path(datasets_opt['flow_path']).iterdir())
    n = min(datasets_opt['max_frames'], len(frame_files))
    filter_flow = datasets_opt.get('filter_optical_flow', True)

    video = np.zeros((n, res_y, res_x, 3), np.float32)
    masks = np.zeros((n, res_y, res_x), np.float32)
    dx = np.zeros_like(video)
    dy = np.zeros_like(video)
    flows = np.zeros((n, res_y, res_x, 2), np.float32)
    flows_rev = np.zeros((n, res_y, res_x, 2), np.float32)
    fmask = np.zeros((n, res_y, res_x), np.float32)
    fmask_rev = np.zeros((n, res_y, res_x), np.float32)

    for i in range(n):
        img = np.asarray(Image.open(frame_files[i]).convert('RGB'),
                         np.float32) / 255.0
        msk = np.asarray(Image.open(mask_files[i]).convert('L'),
                         np.float32) / 255.0
        video[i] = _resize_img(img, res_x, res_y)
        masks[i] = _resize_img(msk, res_x, res_y, nearest=True)
        dy[i, :-1] = video[i, 1:] - video[i, :-1]
        dx[i, :, :-1] = video[i, :, 1:] - video[i, :, :-1]

        if i < n - 1:
            fl = np.load(flow_files[i]).astype(np.float32)
            fwd, bwd = fl[0], fl[1]
            if fwd.shape[0] != res_y or fwd.shape[1] != res_x:
                fwd = resize_flow(fwd, res_y, res_x)
                bwd = resize_flow(bwd, res_y, res_x)
            mf, mb = get_consistency_mask(fwd, bwd)
            flows[i] = fwd
            flows_rev[i + 1] = bwd
            fmask[i] = mf.numpy() if filter_flow else 1.0
            fmask_rev[i + 1] = mb.numpy() if filter_flow else 1.0

    return dict(video=video, mask=masks, dx=dx, dy=dy, flows=flows,
                flows_rev=flows_rev, flow_masks=fmask,
                flow_masks_rev=fmask_rev)
