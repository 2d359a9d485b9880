"""OpenPose COCO-18 body model (two-branch multi-stage CPM) and its
part-affinity-field decode: the port of videoswap_tpu/preprocess/pose.py,
whose docstring gives the graph and the detection protocol (BGR input / 256
- 0.5, a scale around box size 368, padding to stride 8, cubic map
upsampling, blurred peak extraction, PAF line-integral limb scoring, greedy
person assembly).

`OpenPoseBody`'s modules carry the checkpoint's scoped names (`model0.*`,
`model{t}_{b}.*`); `convert_openpose_body` also takes the prefix-less keys
that the public `body_pose_model.pth` ships (`conv1_1.weight`), deriving
the scope from the layer name. The decode is host-side numpy, as in the
JAX package.

The resizes are `jax.image.resize(..., 'cubic')`: Keys' cubic with a =
-0.5, widened by the scale when it downsamples (antialiased), each output's
weights renormalised over the input pixels they reach (no edge clamping).
PyTorch's `mode='bicubic'` uses a = -0.75 and clamps the border, so
`resize_cubic` builds the JAX package's weight matrices. The model and the
resizes run in fp32 with TF32 off on the model's device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
from torch import nn

from .flow import fp32_math
from .unimatch import conv

# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class OpenPoseBodyConfig:
    """Channel plan. Defaults = the public COCO body_pose_model.pth."""
    backbone_channels: tuple = (64, 128, 256, 512)
    cpm_channels: int = 128          # conv4_4_CPM output / stage width
    stage1_mid: int = 512            # conv5_4_CPM 1x1 width
    n_stages: int = 6
    paf_channels: int = 38           # 19 limbs x (x, y)
    heat_channels: int = 19          # 18 keypoints + background


def _backbone_specs(cfg: OpenPoseBodyConfig) -> tuple:
    """(name, out_ch, kernel, relu, pool before) of model0's convs."""
    c1, c2, c3, c4 = cfg.backbone_channels
    return (
        ('conv1_1', c1, 3, True, False), ('conv1_2', c1, 3, True, False),
        ('conv2_1', c2, 3, True, True), ('conv2_2', c2, 3, True, False),
        ('conv3_1', c3, 3, True, True), ('conv3_2', c3, 3, True, False),
        ('conv3_3', c3, 3, True, False), ('conv3_4', c3, 3, True, False),
        ('conv4_1', c4, 3, True, True), ('conv4_2', c4, 3, True, False),
        ('conv4_3_CPM', c3, 3, True, False),
        ('conv4_4_CPM', cfg.cpm_channels, 3, True, False),
    )


def _stage1_specs(cfg: OpenPoseBodyConfig, branch: int) -> tuple:
    out = cfg.paf_channels if branch == 1 else cfg.heat_channels
    c = cfg.cpm_channels
    return (
        (f'conv5_1_CPM_L{branch}', c, 3, True, False),
        (f'conv5_2_CPM_L{branch}', c, 3, True, False),
        (f'conv5_3_CPM_L{branch}', c, 3, True, False),
        (f'conv5_4_CPM_L{branch}', cfg.stage1_mid, 1, True, False),
        (f'conv5_5_CPM_L{branch}', out, 1, False, False),
    )


def _stage_specs(cfg: OpenPoseBodyConfig, t: int, branch: int) -> tuple:
    out = cfg.paf_channels if branch == 1 else cfg.heat_channels
    c = cfg.cpm_channels
    return tuple(
        (f'Mconv{i}_stage{t}_L{branch}', c, 7, True, False)
        for i in range(1, 6)
    ) + (
        (f'Mconv6_stage{t}_L{branch}', c, 1, True, False),
        (f'Mconv7_stage{t}_L{branch}', out, 1, False, False),
    )


class _ConvStack(nn.Module):
    """Named 'SAME' convs in sequence, channels-last; each spec is (name,
    out_ch, kernel, relu, 2x2 max-pool before)."""

    def __init__(self, specs: tuple, in_ch: int):
        super().__init__()
        self.specs = specs
        for name, ch, k, _, _ in specs:
            self.add_module(name, nn.Conv2d(in_ch, ch, k, padding=k // 2))
            in_ch = ch

    def forward(self, x):
        for name, _, _, relu, pool in self.specs:
            if pool:
                x = torch.nn.functional.max_pool2d(
                    x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)
            x = conv(getattr(self, name), x)
            if relu:
                x = torch.relu(x)
        return x


class OpenPoseBody(nn.Module):
    """Input (B, H, W, 3) BGR in [-0.5, 0.5], H and W multiples of 8.
    Returns (paf (B, H/8, W/8, 38), heatmap (B, H/8, W/8, 19))."""

    def __init__(self, cfg: OpenPoseBodyConfig = OpenPoseBodyConfig()):
        super().__init__()
        self.cfg = cfg
        self.model0 = _ConvStack(_backbone_specs(cfg), 3)
        self.model1_1 = _ConvStack(_stage1_specs(cfg, 1), cfg.cpm_channels)
        self.model1_2 = _ConvStack(_stage1_specs(cfg, 2), cfg.cpm_channels)
        stage_in = cfg.paf_channels + cfg.heat_channels + cfg.cpm_channels
        for t in range(2, cfg.n_stages + 1):
            for b in (1, 2):
                self.add_module(f'model{t}_{b}', _ConvStack(
                    _stage_specs(cfg, t, b), stage_in))

    def forward(self, x):
        feat = self.model0(x)
        paf, heat = self.model1_1(feat), self.model1_2(feat)
        for t in range(2, self.cfg.n_stages + 1):
            inp = torch.cat([paf, heat, feat], dim=-1)
            paf = getattr(self, f'model{t}_1')(inp)
            heat = getattr(self, f'model{t}_2')(inp)
        return paf, heat


def _scope_for_layer(conv_name: str) -> str:
    """The module scope of a prefix-less layer name: conv1_1..conv4_4_CPM
    -> model0; conv5_*_CPM_L{b} -> model1_{b}; Mconv*_stage{t}_L{b} ->
    model{t}_{b}."""
    if conv_name.startswith('Mconv'):
        stage = conv_name.split('_stage')[1].split('_L')[0]
        branch = conv_name.rsplit('_L', 1)[1]
        return f'model{stage}_{branch}'
    if conv_name.startswith('conv5_'):
        return f"model1_{conv_name.rsplit('_L', 1)[1]}"
    return 'model0'


def convert_openpose_body(state_dict: dict) -> dict:
    """A `body_pose_model.pth` state dict under `OpenPoseBody`'s names (the
    JAX package's converter gives flax params from it):
    scoped 3-part keys as they are, prefix-less 2-part keys with their
    scope derived from the layer name."""
    out = {}
    for key, value in state_dict.items():
        parts = key.split('.')
        if len(parts) == 2:
            parts = [_scope_for_layer(parts[0])] + parts
        elif len(parts) != 3:
            raise ValueError(f'unrecognized OpenPose checkpoint key: {key!r}')
        out['.'.join(parts)] = torch.as_tensor(value)
    return out


def load_openpose_state(model: OpenPoseBody, state_dict: dict) -> None:
    """`state_dict` (either key layout) into `model`, strictly."""
    model.load_state_dict(convert_openpose_body(state_dict), strict=True)


# ---------------------------------------------------------------------------
# jax.image.resize's cubic filter
# ---------------------------------------------------------------------------


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def cubic_weights(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """(n_in, n_out) weights of jax.image.resize's 'cubic' along one axis
    (scale_and_translate's weight matrix: half-pixel centres, the kernel
    widened by 1 / scale when downsampling, each column renormalised to sum
    to 1, columns outside the input zero)."""
    scale = n_out / n_in
    inv_scale = 1.0 / scale
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(n_out, dtype=torch.float32, device=device) + 0.5)
              * inv_scale - 0.5)
    x = (torch.abs(sample[None, :] - torch.arange(
        n_in, dtype=torch.float32, device=device)[:, None]) / kernel_scale)
    w = _keys_cubic(x)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize_cubic(x: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """jax.image.resize(x, (..., out_h, out_w, C), 'cubic') of (..., H, W,
    C); an axis whose size does not change is left as it is."""
    h, w = x.shape[-3], x.shape[-2]
    if out_h != h:
        x = torch.einsum('...hwc,hy->...ywc', x,
                         cubic_weights(h, out_h, x.device))
    if out_w != w:
        x = torch.einsum('...hwc,wx->...hxc', x,
                         cubic_weights(w, out_w, x.device))
    return x


# ---------------------------------------------------------------------------
# decode tables (Cao et al. CVPR'17, COCO layout)
# ---------------------------------------------------------------------------

# limb endpoints as 0-indexed keypoint ids (the paper's limbSeq minus 1)
LIMB_SEQ = np.array(
    [[1, 2], [1, 5], [2, 3], [3, 4], [5, 6], [6, 7], [1, 8], [8, 9],
     [9, 10], [1, 11], [11, 12], [12, 13], [1, 0], [0, 14], [14, 16],
     [0, 15], [15, 17], [2, 16], [5, 17]])
# PAF (x, y) channel pair of each limb (the paper's mapIdx minus its
# 19-channel heatmap offset)
PAF_IDX = np.array(
    [[12, 13], [20, 21], [14, 15], [16, 17], [22, 23], [24, 25], [0, 1],
     [2, 3], [4, 5], [6, 7], [8, 9], [10, 11], [28, 29], [30, 31],
     [34, 35], [32, 33], [36, 37], [18, 19], [26, 27]])

N_KEYPOINTS = 18
BOXSIZE = 368           # the scale search's box height
SCALES = (0.5,)         # the scale search's scales of BOXSIZE
THRE1 = 0.1             # a heat peak's least blurred value
THRE2 = 0.05            # a limb's least PAF sample along it


def _gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable gaussian blur with edge replication."""
    radius = int(4.0 * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2 * sigma * sigma))
    k /= k.sum()
    pad = np.pad(img, ((radius, radius), (0, 0)), mode='edge')
    out = np.zeros_like(img)
    for i, kv in enumerate(k):
        out += kv * pad[i:i + img.shape[0]]
    pad = np.pad(out, ((0, 0), (radius, radius)), mode='edge')
    out = np.zeros_like(img)
    for i, kv in enumerate(k):
        out += kv * pad[:, i:i + img.shape[1]]
    return out


def find_peaks(heatmap: np.ndarray) -> list:
    """Per-part peak lists [(x, y, score, global_id), ...] from an (H, W,
    19) heatmap."""
    all_peaks = []
    peak_counter = 0
    for part in range(N_KEYPOINTS):
        m = heatmap[:, :, part]
        sm = _gaussian_blur(m.astype(np.float64), 3.0)
        up = np.zeros_like(sm)
        up[1:] = sm[:-1]
        down = np.zeros_like(sm)
        down[:-1] = sm[1:]
        left = np.zeros_like(sm)
        left[:, 1:] = sm[:, :-1]
        right = np.zeros_like(sm)
        right[:, :-1] = sm[:, 1:]
        is_peak = ((sm >= up) & (sm >= down) & (sm >= left) & (sm >= right)
                   & (sm > THRE1))
        ys, xs = np.nonzero(is_peak)
        peaks = [(int(x), int(y), float(m[y, x]), peak_counter + i)
                 for i, (x, y) in enumerate(zip(xs, ys))]
        peak_counter += len(peaks)
        all_peaks.append(peaks)
    return all_peaks


def _limb_connections(paf: np.ndarray, cand_a: list, cand_b: list,
                      limb: int, img_h: int) -> list:
    """Every (a, b) candidate pair of one limb scored by the PAF line
    integral at 10 samples; the best non-conflicting pairs kept
    greedily."""
    n_samples = 10
    px, py = PAF_IDX[limb]
    scored = []
    for ai, a in enumerate(cand_a):
        for bi, b in enumerate(cand_b):
            vec = np.array([b[0] - a[0], b[1] - a[1]], np.float64)
            norm = max(np.hypot(*vec), 1e-8)
            u = vec / norm
            xs = np.linspace(a[0], b[0], n_samples)
            ys = np.linspace(a[1], b[1], n_samples)
            ix = np.clip(np.round(xs).astype(int), 0, paf.shape[1] - 1)
            iy = np.clip(np.round(ys).astype(int), 0, paf.shape[0] - 1)
            samples = paf[iy, ix, px] * u[0] + paf[iy, ix, py] * u[1]
            score = samples.mean() + min(0.5 * img_h / norm - 1, 0)
            if (samples > THRE2).sum() > 0.8 * n_samples and score > 0:
                scored.append((ai, bi, score, score + a[2] + b[2]))
    scored.sort(key=lambda s: s[2], reverse=True)
    used_a, used_b, conns = set(), set(), []
    for ai, bi, score, _ in scored:
        if ai not in used_a and bi not in used_b:
            used_a.add(ai)
            used_b.add(bi)
            conns.append((cand_a[ai][3], cand_b[bi][3], score))
    return conns


def assemble_people(all_peaks: list, paf: np.ndarray) -> tuple:
    """PAF limb matching and person assembly. Returns (candidate (N, 4) of
    all peaks, subsets: one array of 20 floats a person: 18 peak ids (-1 =
    missing), total score, part count), people with < 4 parts or a score a
    part < 0.4 left out."""
    candidate = np.array([p for part in all_peaks for p in part],
                         np.float64).reshape(-1, 4)
    img_h = paf.shape[0]
    subsets: list = []

    for limb in range(len(LIMB_SEQ)):
        ka, kb = LIMB_SEQ[limb]
        conns = _limb_connections(paf, all_peaks[ka], all_peaks[kb], limb,
                                  img_h)
        for ida, idb, score in conns:
            found = [s for s in subsets if s[ka] == ida or s[kb] == idb]
            if len(found) == 1:
                s = found[0]
                if s[kb] != idb:
                    s[kb] = idb
                    s[19] += 1
                    s[18] += candidate[int(idb), 2] + score
                elif s[ka] < 0:
                    # the match was on kb: ka attaches only where its slot
                    # is unset (an assigned part is never overwritten)
                    s[ka] = ida
                    s[19] += 1
                    s[18] += candidate[int(ida), 2] + score
            elif len(found) == 2:
                s1, s2 = found
                # disjoint people joined by this limb: merge
                if not np.any((s1[:18] >= 0) & (s2[:18] >= 0)):
                    s1[:18] = np.where(s2[:18] >= 0, s2[:18], s1[:18])
                    s1[18] += s2[18] + score
                    s1[19] += s2[19]
                    subsets[:] = [s for s in subsets if s is not s2]
                else:
                    s1[kb] = idb
                    s1[19] += 1
                    s1[18] += candidate[int(idb), 2] + score
            else:
                s = np.full(20, -1.0)
                s[ka], s[kb] = ida, idb
                s[19] = 2
                s[18] = (candidate[int(ida), 2] + candidate[int(idb), 2]
                         + score)
                subsets.append(s)

    subsets = [s for s in subsets if s[19] >= 4 and s[18] / s[19] >= 0.4]
    return candidate, subsets


# ---------------------------------------------------------------------------
# detector (the controlnet_aux surface)
# ---------------------------------------------------------------------------


@dataclass
class Keypoint:
    x: float
    y: float


@dataclass
class BodyResult:
    keypoints: list          # 18 entries, Keypoint (normalized) or None
    total_score: float


@dataclass
class PoseResult:
    body: BodyResult


class NativePoseDetector:
    """The controlnet_aux OpenposeDetector surface that
    `extract_semantic_point.propagate_human_keypoint` uses (body only)."""

    STRIDE = 8

    def __init__(self, model: OpenPoseBody):
        self.model = model.eval()

    @classmethod
    def from_checkpoint(cls, path: str,
                        device=None) -> 'NativePoseDetector':
        """`body_pose_model.pth` at `path`, loaded strictly (device None:
        'cuda')."""
        model = OpenPoseBody()
        load_openpose_state(model, torch.load(path, map_location='cpu',
                                              weights_only=True))
        return cls(model.to(torch.device(device or 'cuda'), torch.float32))

    @property
    def device(self) -> torch.device:
        return self.model.model0.conv1_1.weight.device

    @torch.no_grad()
    def _maps(self, img_rgb: np.ndarray) -> tuple:
        """The scale search's forward passes: (paf, heatmap) numpy at the
        image's resolution, averaged over scales."""
        h, w = img_rgb.shape[:2]
        cfg = self.model.cfg
        bgr = torch.from_numpy(np.ascontiguousarray(
            img_rgb[:, :, ::-1], dtype=np.float32)).to(self.device)
        heat_acc = np.zeros((h, w, cfg.heat_channels), np.float32)
        paf_acc = np.zeros((h, w, cfg.paf_channels), np.float32)
        with fp32_math():
            for scale in SCALES:
                s = scale * BOXSIZE / h
                sh = max(int(round(h * s)), self.STRIDE)
                sw = max(int(round(w * s)), self.STRIDE)
                x = resize_cubic(bgr, sh, sw)
                ph = (-sh) % self.STRIDE
                pw = (-sw) % self.STRIDE
                # pad value 128 in uint8 space == 0 after / 256 - 0.5
                x = torch.nn.functional.pad(x / 256.0 - 0.5,
                                            (0, 0, 0, pw, 0, ph))
                paf, heat = self.model(x[None])
                # up by the stride to the padded input, crop, then to the
                # image's size
                paf = resize_cubic(paf, *x.shape[:2])[0, :sh, :sw]
                heat = resize_cubic(heat, *x.shape[:2])[0, :sh, :sw]
                paf_acc += resize_cubic(paf, h, w).cpu().numpy()
                heat_acc += resize_cubic(heat, h, w).cpu().numpy()
        n = len(SCALES)
        return paf_acc / n, heat_acc / n

    def detect_poses(self, img_rgb: np.ndarray) -> list:
        """(H, W, 3) uint8 / float RGB -> [PoseResult] (x, y normalised to
        [0, 1], None for an undetected keypoint)."""
        h, w = img_rgb.shape[:2]
        paf, heat = self._maps(np.asarray(img_rgb))
        peaks = find_peaks(heat)
        candidate, subsets = assemble_people(peaks, paf)
        results = []
        for s in subsets:
            kps = []
            for k in range(N_KEYPOINTS):
                idx = int(s[k])
                if idx < 0:
                    kps.append(None)
                else:
                    x, y = candidate[idx, 0], candidate[idx, 1]
                    kps.append(Keypoint(x / w, y / h))
            results.append(PoseResult(BodyResult(kps, float(s[18]))))
        return results
