"""Atlas evaluation: the reconstruction and its PSNR, the adaptive
high-resolution textures, texture-edit re-rendering, per-pixel loss videos
and the validation files.

The counterpart of videoswap_tpu/atlas/evaluate.py. Net evaluations and the
renders of whole videos run on the nets' device, in chunks; the results
are tensors there. Where the JAX package computes in numpy float64 (the
texture sampling weights, the pixel coordinates of the reconstruction),
the port does too. `sample_texture` keeps the reference's floor/ceil
relevance test and its clipped corner weights (not `grid_sample`, another
function); the used-area mask's `np.maximum.at` splat is a
`scatter_reduce('amax')`.

`evaluate_model` writes the JAX package's file names: videos through
utils/vis_util.py (mp4 through imageio, else a gif through PIL, named
`<name>.gif`), images as PNG (utils/png.py).
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from ..utils.png import write_png
from ..utils.vis_util import save_video_to_dir
from . import losses

_KEYS = ('rgb', 'fg', 'bg', 'alpha', 'uv_fg', 'uv_bg')


def _device(nets: dict) -> torch.device:
    return nets['FG_UV_Mapping'].hidden_0.weight.device


def _on(x, dev, dtype=None) -> torch.Tensor:
    return torch.as_tensor(x).to(device=dev, dtype=dtype)


@torch.no_grad()
def reconstruct_video(nets: dict, res_x: int, res_y: int, num_frames: int,
                      norm_s, norm_t, chunk: int = 65536) -> dict:
    """Evaluate the atlas at every pixel of frames 0 .. num_frames - 1.
    Returns {'rgb', 'fg', 'bg', 'alpha', 'uv_fg', 'uv_bg'}: (F, H, W, C)
    fp32 tensors on the nets' device."""
    dev = _device(nets)
    ys, xs = torch.meshgrid(torch.arange(res_y, device=dev),
                            torch.arange(res_x, device=dev), indexing='ij')
    # normalised in float64 and rounded once, as the JAX package's numpy
    sx = norm_s(xs.reshape(-1).double()).float()
    sy = norm_s(ys.reshape(-1).double()).float()
    out = {k: [] for k in _KEYS}
    for f in range(num_frames):
        rows = {k: [] for k in _KEYS}
        for i in range(0, res_x * res_y, chunk):
            n = min(chunk, res_x * res_y - i)
            xyt = torch.stack([sx[i:i + n], sy[i:i + n],
                               torch.full((n,), float(norm_t(f)),
                                          device=dev)], dim=-1)
            fg = nets['FG_UV_Mapping'](xyt)
            bg = nets['BG_UV_Mapping'](xyt)
            alpha = losses.scaled_alpha(nets['F_Alpha'](xyt))
            rgb, rgb_fg, rgb_bg = losses.reconstruct_rgb(fg, bg, alpha,
                                                         nets['F_Atlas'])
            for k, v in zip(_KEYS, (rgb, rgb_fg, rgb_bg, alpha, fg, bg)):
                rows[k].append(v)
        for k in _KEYS:
            out[k].append(torch.cat(rows[k]).reshape(res_y, res_x, -1))
    return {k: torch.stack(v) for k, v in out.items()}


def psnr(a: torch.Tensor, b: torch.Tensor, data_range: float = 1.0) -> float:
    mse = torch.mean((a.double() - b.double()) ** 2)
    if float(mse) == 0:
        return float('inf')
    return float(10.0 * torch.log10(data_range ** 2 / mse))


# --------------------------------------------------------------- textures
@torch.no_grad()
def get_mapping_area(nets: dict, mask, larger_dim: int, num_frames: int,
                     uv_shift, norm_s, norm_t, *,
                     mapping: str = 'BG_UV_Mapping',
                     invert_alpha: bool = False, alpha_thresh: float = -0.5,
                     chunk: int = 100_000) -> dict:
    """UV bounding box of the pixels of `mask` ((F, H, W) bool) whose RAW
    F_Alpha output (negated with `invert_alpha`) exceeds `alpha_thresh`,
    through `mapping` into its atlas quadrant (uv * 0.5 + uv_shift),
    clamped to [-1, 1]; where no pixel qualifies, [-1, -1] (inverted) or
    [0, 0] to that + 1. Returns {minx, miny, maxx, maxy, edge}."""
    dev = _device(nets)
    fs, ys, xs = torch.nonzero(_on(mask, dev), as_tuple=True)
    shift = torch.tensor(uv_shift, dtype=torch.float32, device=dev)
    lo = torch.full((2,), math.inf, device=dev)
    hi = -lo
    for i in range(0, len(fs), chunk):
        xyt = torch.stack([norm_s(xs[i:i + chunk].double()),
                           norm_s(ys[i:i + chunk].double()),
                           norm_t(fs[i:i + chunk].double())], dim=-1).float()
        uv = nets[mapping](xyt) * 0.5 + shift
        raw = nets['F_Alpha'](xyt)[:, 0]
        ok = ((-raw if invert_alpha else raw) > alpha_thresh)[:, None]
        lo = torch.minimum(lo, torch.where(ok, uv, math.inf).amin(dim=0))
        hi = torch.maximum(hi, torch.where(ok, uv, -math.inf).amax(dim=0))
    lo = np.maximum(lo.cpu().numpy(), -1.0)
    hi = np.minimum(hi.cpu().numpy(), 1.0)
    if not np.all(np.isfinite(lo)) or not np.all(np.isfinite(hi)):
        lo = np.asarray([-1.0, -1.0]) if invert_alpha else np.zeros(2)
        hi = lo + 1.0
    edge = float(max(hi[0] - lo[0], hi[1] - lo[1]))
    return dict(minx=float(lo[0]), miny=float(lo[1]),
                maxx=float(hi[0]), maxy=float(hi[1]), edge=edge)


@torch.no_grad()
def get_high_res_texture(nets: dict, resolution: int, minx: float,
                         maxx: float, miny: float, maxy: float,
                         chunk: int = 65536) -> torch.Tensor:
    """F_Atlas sampled over [minx, maxx] x [miny, maxy]: row i is y, column
    j is x. Returns (res, res, 3) in [0, 1] on the nets' device."""
    dev = _device(nets)
    us = torch.from_numpy(np.linspace(minx, maxx, resolution,
                                      dtype=np.float32)).to(dev)
    vs = torch.from_numpy(np.linspace(miny, maxy, resolution,
                                      dtype=np.float32)).to(dev)
    vv, uu = torch.meshgrid(vs, us, indexing='ij')
    uv = torch.stack([uu.reshape(-1), vv.reshape(-1)], -1)
    out = [(nets['F_Atlas'](uv[i:i + chunk]) + 1.0) * 0.5
           for i in range(0, len(uv), chunk)]
    return torch.cat(out).reshape(resolution, resolution, 3)


def apply_edit_pattern(texture: torch.Tensor) -> torch.Tensor:
    """The texture with a hue-varying stripe pattern over it, so that the
    mapping shows in re-rendered video (the JAX package's stand-in for the
    reference's text rows)."""
    tex = texture.clone()
    res = tex.shape[0]
    ys, xs = torch.meshgrid(torch.arange(res, device=tex.device),
                            torch.arange(res, device=tex.device),
                            indexing='ij')
    period = max(res // 12, 8)
    stripe = ((xs + ys) // (period // 2)) % 4 == 0
    hue = (ys // period).float() / max(res // period, 1)
    color = torch.stack([torch.abs(torch.cos(2 * np.pi * (hue + s)))
                         for s in (0.0, 1 / 3, 2 / 3)], dim=-1)
    tex[stripe] = color[stripe]
    return tex


def sample_texture(texture: torch.Tensor, box: dict, u: torch.Tensor,
                   v: torch.Tensor):
    """UV points (atlas coordinates, uv * 0.5 + shift) mapped into the
    texture's pixels and sampled bilinearly, as the reference's
    `get_colors` does: a point is relevant where floor and ceil of its
    pixel coordinates both lie in the texture; the corners are clipped to
    it and weighted by (x1 - px), (px - x0), ... in float64.

    Returns (colors [N, 3] float64, relevant [N], px [N], py [N])."""
    res = texture.shape[0]
    pixel = res / max(box['edge'], 1e-8)
    px = (u - box['minx']) * pixel
    py = (v - box['miny']) * pixel
    relevant = ((torch.floor(px) >= 0) & (torch.floor(py) >= 0)
                & (torch.ceil(px) < res) & (torch.ceil(py) < res))
    x0 = torch.floor(px).long().clamp(0, res - 1)
    y0 = torch.floor(py).long().clamp(0, res - 1)
    x1 = (x0 + 1).clamp(0, res - 1)
    y1 = (y0 + 1).clamp(0, res - 1)
    pxd, pyd = px.double(), py.double()
    wa = (x1 - pxd) * (y1 - pyd)
    wb = (x1 - pxd) * (pyd - y0)
    wc = (pxd - x0) * (y1 - pyd)
    wd = (pxd - x0) * (pyd - y0)
    tex = texture.double()
    colors = (tex[y0, x0] * wa[:, None] + tex[y1, x0] * wb[:, None]
              + tex[y0, x1] * wc[:, None] + tex[y1, x1] * wd[:, None])
    return colors, relevant, px, py


def _splat_max(mask: torch.Tensor, iy, ix, values) -> None:
    """mask[iy, ix] = max(mask[iy, ix], values), in place (np.maximum.at)."""
    flat = mask.view(-1)
    flat.scatter_reduce_(0, iy * mask.shape[1] + ix, values, 'amax')


@torch.no_grad()
def render_edited_video(nets: dict, res_x: int, res_y: int, num_frames: int,
                        norm_s, norm_t, *, tex_fg: torch.Tensor, box_fg: dict,
                        tex_bg: torch.Tensor, box_bg: dict,
                        rec: dict | None = None) -> dict:
    """The video re-rendered from (possibly edited) texture images. Returns
    'edit' (both edited layers composited by alpha), 'edit_fg' / 'edit_bg'
    (each layer alone), and the used-area masks of the textures, 'mask_fg'
    (alpha max-splatted on the four texture neighbours) and 'mask_bg' (1
    where used). Tensors on the nets' device."""
    if rec is None:
        rec = reconstruct_video(nets, res_x, res_y, num_frames, norm_s,
                                norm_t)
    dev = rec['alpha'].device
    tex_fg, tex_bg = _on(tex_fg, dev), _on(tex_bg, dev)
    hw = (res_y, res_x)
    edit = torch.zeros((num_frames, *hw, 3), device=dev)
    edit_fg = torch.zeros_like(edit)
    edit_bg = torch.zeros_like(edit)
    mask_fg = torch.zeros(tex_fg.shape[:2], device=dev)
    mask_bg = torch.zeros(tex_bg.shape[:2], device=dev)
    for f in range(num_frames):
        a = rec['alpha'][f].reshape(-1)
        uv1 = rec['uv_fg'][f].reshape(-1, 2) * 0.5 + 0.5
        uv2 = rec['uv_bg'][f].reshape(-1, 2) * 0.5 - 0.5
        c1, rel1, px1, py1 = sample_texture(tex_fg, box_fg, uv1[:, 0],
                                            uv1[:, 1])
        c2, rel2, px2, py2 = sample_texture(tex_bg, box_bg, uv2[:, 0],
                                            uv2[:, 1])
        fg_frame = torch.where(rel1[:, None], c1 * a[:, None],
                               0.0).float()
        bg_frame = torch.where(rel2[:, None], c2, 0.0).float()
        edit[f] = (fg_frame + bg_frame * (1 - a[:, None])).reshape(*hw, 3)
        edit_fg[f] = fg_frame.reshape(*hw, 3)
        edit_bg[f] = bg_frame.reshape(*hw, 3)
        for ox in (torch.floor, torch.ceil):
            for oy in (torch.floor, torch.ceil):
                ix = ox(px1[rel1]).long().clamp(0, tex_fg.shape[1] - 1)
                iy = oy(py1[rel1]).long().clamp(0, tex_fg.shape[0] - 1)
                _splat_max(mask_fg, iy, ix, a[rel1])
                jx = ox(px2[rel2]).long().clamp(0, tex_bg.shape[1] - 1)
                jy = oy(py2[rel2]).long().clamp(0, tex_bg.shape[0] - 1)
                mask_bg[jy, jx] = 1.0
    return dict(edit=edit, edit_fg=edit_fg, edit_bg=edit_bg,
                mask_fg=mask_fg, mask_bg=mask_bg)


# --------------------------------------------------- per-pixel loss videos
@torch.no_grad()
def compute_loss_videos(nets: dict, data: dict, res_x: int, res_y: int,
                        num_frames: int, norm_s, norm_t, larger_dim: int, *,
                        derivative_amount: int = 1,
                        uv_mapping_scale: float = 0.8,
                        chunk: int = 131072) -> dict:
    """Per-pixel loss maps of every frame: rigidity fg / bg, forward flow
    fg / bg, flow alpha, rgb error (F, H, W) and rgb residual (F, H, W,
    3). The last frame has no forward flow: its flow terms are 0."""
    dev = _device(nets)
    d = derivative_amount
    fg_map, bg_map = nets['FG_UV_Mapping'], nets['BG_UV_Mapping']
    f_alpha, f_atlas = nets['F_Alpha'], nets['F_Atlas']
    video = _on(data['video'], dev, torch.float32)
    flows = _on(data['flows'], dev, torch.float32)
    flow_masks = _on(data['flow_masks'], dev, torch.float32)

    def mk(px, py, pf):
        return torch.stack([norm_s(px), norm_s(py), norm_t(pf)],
                           dim=-1).float()

    hw = (res_y, res_x)
    names = ('rigidity_fg', 'rigidity_bg', 'flow_fg', 'flow_bg',
             'flow_alpha', 'rgb_error')
    out = {k: torch.zeros((num_frames, *hw), device=dev) for k in names}
    out['rgb_residual'] = torch.zeros((num_frames, *hw, 3), device=dev)
    ys, xs = torch.meshgrid(torch.arange(res_y, device=dev),
                            torch.arange(res_x, device=dev), indexing='ij')
    coords = torch.stack([xs.reshape(-1), ys.reshape(-1)], -1)
    for f in range(num_frames):
        rows = {k: [] for k in out}
        for i in range(0, len(coords), chunk):
            x, y = coords[i:i + chunk, 0], coords[i:i + chunk, 1]
            fr = torch.full_like(x, f)
            pts = mk(x, y, fr)
            uv1, uv2 = fg_map(pts), bg_map(pts)
            alpha = losses.scaled_alpha(f_alpha(pts))
            rgb, _, _ = losses.reconstruct_rgb(uv1, uv2, alpha, f_atlas)
            rig1 = losses.rigidity_loss_all(
                uv1, fg_map(mk(x - d, y, fr)), fg_map(mk(x, y - d, fr)), d,
                larger_dim, uv_mapping_scale)
            rig2 = losses.rigidity_loss_all(
                uv2, bg_map(mk(x - d, y, fr)), bg_map(mk(x, y - d, fr)), d,
                larger_dim, uv_mapping_scale)
            xyf = torch.stack([x, y, fr], dim=-1)
            match_f = losses._flow_match_coords(xyf, flows, 1, norm_s, norm_t)
            valid_f = flow_masks[fr, y, x]
            if f == num_frames - 1:
                fl1 = fl2 = fla = torch.zeros_like(valid_f)
            else:
                fl1 = losses.optical_flow_loss_all(
                    uv1, fg_map(match_f), valid_f, larger_dim,
                    uv_mapping_scale, alpha=alpha)
                fl2 = losses.optical_flow_loss_all(
                    uv2, bg_map(match_f), valid_f, larger_dim,
                    uv_mapping_scale, alpha=1.0 - alpha)
                fla = losses.flow_alpha_loss_all(
                    alpha, losses.scaled_alpha(f_alpha(match_f)), valid_f)
            residual = video[f].reshape(-1, 3)[i:i + chunk] - rgb
            err = torch.sum(residual * residual, dim=-1)
            for k, v in zip(names + ('rgb_residual',),
                            (rig1, rig2, fl1, fl2, fla, err, residual)):
                rows[k].append(v)
        for k in out:
            arr = torch.cat(rows[k])
            out[k][f] = arr.reshape(*hw, *arr.shape[1:])
    return out


def _panel(img: torch.Tensor, vmin: float, vmax: float) -> torch.Tensor:
    """A scalar map normalised into a [0, 1] RGB tile."""
    g = ((img - vmin) / max(vmax - vmin, 1e-8)).clamp(0, 1)
    if g.dim() == 2:
        g = g[:, :, None].expand(*g.shape, 3)
    return g


def global_info_frames(video, rec, loss_videos, alpha, mask) -> torch.Tensor:
    """The reference's diagnostic grid as a 2x4 mosaic per frame:
    reconstruction | original | rgb_error | alpha-vs-mask over
    flow_fg | flow_bg | flow_alpha | rigidity_fg."""
    dev = rec.device
    video, mask = _on(video, dev, torch.float32), _on(mask, dev,
                                                      torch.float32)
    frames = []
    for i in range(len(video)):
        avm = torch.stack([mask[i], alpha[i, :, :, 0],
                           torch.zeros_like(mask[i])], dim=-1)
        row1 = torch.cat([
            _panel(rec[i], 0, 1), _panel(video[i], 0, 1),
            _panel(loss_videos['rgb_error'][i], 0, 0.2),
            _panel(avm, 0, 1)], dim=1)
        row2 = torch.cat([
            _panel(loss_videos['flow_fg'][i], 0, 2.0),
            _panel(loss_videos['flow_bg'][i], 0, 2.0),
            _panel(loss_videos['flow_alpha'][i], 0, 1.0),
            _panel(loss_videos['rigidity_fg'][i], 2.8, 50.0)], dim=1)
        frames.append(torch.cat([row1, row2], dim=0))
    return torch.stack(frames)


def _checkerboard(res: int, squares: int = 16, device=None) -> torch.Tensor:
    ys, xs = torch.meshgrid(torch.arange(res, device=device),
                            torch.arange(res, device=device), indexing='ij')
    c = ((xs * squares // res + ys * squares // res) % 2).float()
    return c[:, :, None].expand(res, res, 3)


def _uint8(frames: torch.Tensor) -> np.ndarray:
    """[0, 1] floats as uint8 (clipped, truncated), gray repeated to RGB."""
    arr = (frames.float().clamp(0, 1) * 255).to(torch.uint8)
    if arr.shape[-1] == 1:
        arr = arr.expand(*arr.shape[:-1], 3)
    return arr.cpu().numpy()


def _save_image(img: torch.Tensor, path: str) -> None:
    write_png(path, _uint8(img))


def _save_video(frames: torch.Tensor, path: str, fps: int = 10) -> None:
    """`<name>.mp4` (imageio), or `<name>.gif` where imageio cannot write
    it."""
    stem = os.path.splitext(os.path.basename(path))[0]
    save_video_to_dir(_uint8(frames), os.path.dirname(path), stem,
                      save_type='video', fps=fps)


def render_atlas_texture(nets: dict, layer: str = 'fg',
                         resolution: int = 512) -> torch.Tensor:
    """F_Atlas on a UV grid of the layer's quadrant: FG colours live in
    [0, 1] x [0, 1], BG in [-1, 0] x [-1, 0]. (res, res, 3) in [0, 1]."""
    lo, hi = (0.0, 1.0) if layer == 'fg' else (-1.0, 0.0)
    return get_high_res_texture(nets, resolution, lo, hi, lo, hi)


def render_checkerboard(nets: dict, res_x: int, res_y: int, num_frames: int,
                        norm_s, norm_t, squares: int = 16,
                        rec: dict | None = None) -> torch.Tensor:
    """The video re-rendered with a checkerboard texture through the FG
    mapping, composited over the BG layer by alpha (`rec`, the
    reconstruction, is computed when not given)."""
    if rec is None:
        rec = reconstruct_video(nets, res_x, res_y, num_frames, norm_s,
                                norm_t)
    frames = []
    for f in range(num_frames):
        uv = rec['uv_fg'][f].reshape(-1, 2)
        a = rec['alpha'][f].reshape(-1, 1)
        grid = torch.floor((uv * 0.5 + 0.5) * squares).long()
        checker = ((grid[:, 0] + grid[:, 1]) % 2).float()
        tex = torch.stack([checker, 1 - checker, torch.ones_like(checker)],
                          -1)
        frame = tex * a + rec['bg'][f].reshape(-1, 3) * (1 - a)
        frames.append(frame.reshape(res_y, res_x, 3))
    return torch.stack(frames)


# ------------------------------------------------------------- evaluation
@torch.no_grad()
def evaluate_model(nets: dict, video, res_x: int, res_y: int,
                   num_frames: int, norm_s, norm_t,
                   save_dir: str | None = None, *, data: dict | None = None,
                   full: bool = False, texture_res: int = 1000,
                   uv_mapping_scale: float = 0.8,
                   derivative_amount: int = 1) -> float:
    """Reconstruction PSNR over frames 0 .. num_frames - 1 of `video` (F, H,
    W, 3) in [0, 1]; with `save_dir`, the validation files (the
    reconstruction, alpha, foreground and background videos, both atlas
    textures, the checkerboard video); with `full` also the adaptive
    textures, the edited re-renders and the per-pixel loss videos (`data`:
    the clip's mask, video, flows and flow masks)."""
    rec = reconstruct_video(nets, res_x, res_y, num_frames, norm_s, norm_t)
    video = _on(video, rec['rgb'].device, torch.float32)[:num_frames]
    value = psnr(rec['rgb'], video)
    if save_dir is None:
        return value
    os.makedirs(save_dir, exist_ok=True)

    def path(name):
        return os.path.join(save_dir, name)
    _save_video(rec['rgb'], path('reconstruction.mp4'))
    _save_video(rec['alpha'], path('alpha.mp4'))
    _save_video(rec['fg'] * rec['alpha'], path('foreground.mp4'))
    _save_video(rec['bg'], path('background.mp4'))
    for layer in ('fg', 'bg'):
        _save_image(render_atlas_texture(nets, layer, resolution=256),
                    path(f'atlas_{layer}.png'))
    _save_video(render_checkerboard(nets, res_x, res_y, num_frames, norm_s,
                                    norm_t, rec=rec), path('checkerboard.mp4'))
    if not full:
        return value
    assert data is not None, 'full evaluation needs the data dict'
    larger_dim = max(res_x, res_y)
    dev = rec['rgb'].device
    mask = _on(data['mask'], dev, torch.float32)

    # adaptive mapping areas: the FG texture over the fixed [0, 1] quadrant,
    # the BG one over its used area; the checkerboard's FG over the
    # high-alpha used area
    box_fg = dict(minx=0.0, miny=0.0, maxx=1.0, maxy=1.0, edge=1.0)
    box_bg = get_mapping_area(nets, mask > -1, larger_dim, num_frames,
                              (-0.5, -0.5), norm_s, norm_t,
                              mapping='BG_UV_Mapping', invert_alpha=True)
    box_fg_tight = get_mapping_area(
        nets, mask > 0.5, larger_dim, num_frames, (0.5, 0.5), norm_s, norm_t,
        mapping='FG_UV_Mapping', invert_alpha=False, alpha_thresh=0.95)

    def texture(box, res):
        return get_high_res_texture(nets, res, box['minx'],
                                    box['minx'] + box['edge'], box['miny'],
                                    box['miny'] + box['edge'])
    tex_fg, tex_bg = texture(box_fg, texture_res), texture(box_bg,
                                                            texture_res)
    edited_fg, edited_bg = apply_edit_pattern(tex_fg), \
        apply_edit_pattern(tex_bg)
    ed = render_edited_video(nets, res_x, res_y, num_frames, norm_s, norm_t,
                             tex_fg=edited_fg, box_fg=box_fg,
                             tex_bg=edited_bg, box_bg=box_bg, rec=rec)
    _save_video(ed['edit'], path('edit.mp4'))
    _save_video(ed['edit_fg'], path('edited_fg.mp4'))
    _save_video(ed['edit_bg'], path('edited_bg.mp4'))
    m1, m2 = ed['mask_fg'][:, :, None], ed['mask_bg'][:, :, None]
    _save_image(m1 * tex_fg, path('texture_orig1.png'))
    _save_image(m1 * edited_fg, path('texture_edit1.png'))
    _save_image(m2 * tex_bg, path('texture_orig2.png'))
    _save_image(m2 * edited_bg, path('texture_edit2.png'))

    # the checkerboard re-rendered through the tight FG box
    res_t = texture_res // 2
    checker = _checkerboard(res_t, device=dev) * 0.3
    ck = render_edited_video(
        nets, res_x, res_y, num_frames, norm_s, norm_t,
        tex_fg=checker + texture(box_fg_tight, res_t) * 0.7,
        box_fg=box_fg_tight, tex_bg=checker + texture(box_bg, res_t) * 0.7,
        box_bg=box_bg, rec=rec)
    _save_video(ck['edit_fg'], path('checkerboard_fg.mp4'))
    _save_video(ck['edit_bg'], path('checkerboard_bg.mp4'))

    # uv videos, normalised by the mapping boxes
    for tag, key, box, shift in (('fg', 'uv_fg', box_fg, 0.5),
                                 ('bg', 'uv_bg', box_bg, -0.5)):
        uv = rec[key] * 0.5 + shift
        e = max(box['edge'], 1e-8)
        nx = ((uv[..., 0] - box['minx']) / e).clamp(0, 1)
        ny = ((uv[..., 1] - box['miny']) / e).clamp(0, 1)
        img = torch.stack([nx, ny, torch.zeros_like(nx)], dim=-1)
        _save_video(img, path(f'uv_{tag}.mp4'))
        if tag == 'fg':
            _save_video(img * rec['alpha'], path('uv_fg_masked.mp4'))

    lv = compute_loss_videos(
        nets, data, res_x, res_y, num_frames, norm_s, norm_t, larger_dim,
        derivative_amount=derivative_amount,
        uv_mapping_scale=uv_mapping_scale)
    _save_video(lv['rgb_residual'] + 0.5, path('residuals.mp4'))
    avm = torch.stack([mask[:num_frames], rec['alpha'][..., 0],
                       torch.zeros_like(rec['alpha'][..., 0])], dim=-1)
    _save_video(avm, path('alpha_vs_gtmask.mp4'))
    _save_video(global_info_frames(video, rec['rgb'], lv, rec['alpha'], mask),
                path('global_info.mp4'))
    return value
