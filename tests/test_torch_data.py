"""The port's data path against the JAX package's, on the CPU: the PNG
codec (utils/png.py, no PIL) against PIL, the array transforms against
PIL's (within one 8-bit level: PIL resamples in 8-bit fixed point),
`SingleVideoPointDataset` (pixels within one level, 1/127.5, of the JAX
dataset's on the same frames, through its native loader and its PIL
path; frames; conditions equal), `overlay_points` pixel-equal to the JAX
package's PIL drawing, the metrics equal, and the video writers."""

import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image

from videoswap_tpu.data import build_dataset as j_build_dataset
from videoswap_tpu.data.frame_point_dataset import \
    select_frame_idx as j_select_frame_idx
from videoswap_tpu.utils import metrics as jmetrics
from videoswap_tpu.utils.vis_util import overlay_points as j_overlay_points
from videoswap_torch.data import build_dataset
from videoswap_torch.data.frame_point_dataset import select_frame_idx
from videoswap_torch.data.transforms import (CenterCrop, Compose, Resize,
                                             T2I_Preprocess)
from videoswap_torch.utils import metrics
from videoswap_torch.utils.png import read_image, read_png, write_png
from videoswap_torch.utils.vis_util import (make_grid, overlay_points,
                                            save_video_to_dir)


def _smooth(h, w, c=3, seed=0):
    rs = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    out = [np.sin(xx / rs.uniform(3, 12) + rs.rand() * 6)
           + np.cos(yy / rs.uniform(3, 12)) for _ in range(c)]
    return np.clip(np.stack(out, -1) * 60 + 128 + rs.randn(h, w, c) * 8,
                   0, 255).astype(np.uint8)


def _png_filtered(img: np.ndarray) -> bytes:
    """An RGB PNG whose rows cycle through the five filter types."""
    h, w, c = img.shape
    raw = img.reshape(h, w * c).astype(np.int64)
    rows = []
    for y in range(h):
        kind, cur = y % 5, raw[y]
        prior = raw[y - 1] if y else np.zeros_like(cur)
        left = np.concatenate([np.zeros(c, np.int64), cur[:-c]])
        upleft = np.concatenate([np.zeros(c, np.int64), prior[:-c]])
        if kind == 0:
            pred = 0
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prior
        elif kind == 3:
            pred = (left + prior) // 2
        else:
            p = left + prior - upleft
            pa, pb, pc = abs(p - left), abs(p - prior), abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prior, upleft))
        rows.append(bytes([kind]) + ((cur - pred) % 256).astype(
            np.uint8).tobytes())

    def chunk(k, b):
        return struct.pack('>I', len(b)) + k + b + struct.pack(
            '>I', zlib.crc32(k + b) & 0xFFFFFFFF)
    return (b'\x89PNG\r\n\x1a\n'
            + chunk(b'IHDR', struct.pack('>IIBBBBB', w, h, 8, 2, 0, 0, 0))
            + chunk(b'IDAT', zlib.compress(b''.join(rows)))
            + chunk(b'IEND', b''))


def test_png_reads_every_filter_type(tmp_path):
    img = _smooth(23, 31)
    p = tmp_path / 'f.png'
    p.write_bytes(_png_filtered(img))
    np.testing.assert_array_equal(np.asarray(Image.open(p)), img)
    np.testing.assert_array_equal(read_png(str(p)), img)


@pytest.mark.parametrize('mode, shape', [('RGB', (40, 56, 3)),
                                         ('RGBA', (33, 17, 4)),
                                         ('L', (30, 20))])
def test_png_equals_pil(tmp_path, mode, shape):
    """PIL-written files (its adaptive row filters) decode alike; ours
    round-trip and PIL reads them; `read_image` gives PIL's RGB."""
    img = _smooth(shape[0], shape[1], shape[2] if len(shape) == 3 else 1)
    img = img.reshape(shape)
    p = tmp_path / 'pil.png'
    Image.fromarray(img, mode).save(p)
    np.testing.assert_array_equal(read_png(str(p)), np.asarray(Image.open(p)))
    np.testing.assert_array_equal(
        read_image(str(p)), np.asarray(Image.open(p).convert('RGB')))
    q = tmp_path / 'ours.png'
    write_png(str(q), img)
    np.testing.assert_array_equal(read_png(str(q)), img)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), img)


@pytest.mark.parametrize('mode', ['LA', 'P', 'I;16'])
def test_png_outside_what_it_reads_raises(tmp_path, mode):
    p = tmp_path / 'x.png'
    Image.fromarray(_smooth(9, 12)).convert(mode).save(p)
    with pytest.raises(ValueError, match='only 8-bit gray, RGB and RGBA'):
        read_png(str(p))


def test_read_image_takes_other_formats_through_pil(tmp_path):
    img = _smooth(16, 24)
    p = tmp_path / 'f.bmp'
    Image.fromarray(img).save(p)
    np.testing.assert_array_equal(read_image(str(p)), img)


@pytest.mark.parametrize('size', [[448, 768], 256, 40, [33, 47]])
def test_resize_within_one_level_of_pil(size):
    img = _smooth(96, 128, seed=1)
    out = Resize(size)(img)
    h, w = out.shape[:2]
    if isinstance(size, int):
        assert min(h, w) == size and w / h == pytest.approx(128 / 96, 0.05)
    ref = np.asarray(Image.fromarray(img).resize((w, h), Image.BILINEAR))
    assert out.dtype == np.uint8
    assert int(np.abs(out.astype(int) - ref).max()) <= 1


def test_crop_and_t2i_preprocess_equal_pil():
    img = _smooth(50, 70)
    np.testing.assert_array_equal(CenterCrop([32, 40])(img), np.asarray(
        Image.fromarray(img).crop((15, 9, 55, 41))))
    out = T2I_Preprocess(24, 36)(img)
    ref = np.asarray(Image.fromarray(img).resize((36, 24), Image.BILINEAR),
                     np.float32) / 255.0
    assert out.shape == (24, 36, 3)
    assert float(np.abs(out - ref).max()) <= 1 / 255 + 1e-6


@pytest.mark.parametrize('begin, end, n', [(0, 64, 16), (0, 4, 2), (0, 8, 1),
                                           (3, 10, 4), (0, 5, 8)])
def test_select_frame_idx_equals_jax(begin, end, n):
    assert select_frame_idx(begin, end, n) == j_select_frame_idx(begin, end,
                                                                 n)


@pytest.fixture(scope='module')
def clip_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp('clip')
    (root / 'frames').mkdir()
    for i in range(12):
        Image.fromarray(_smooth(72, 96, seed=10 + i)).save(
            root / 'frames' / f'{i:05d}.png')
    rs = np.random.RandomState(3)
    for name, (h, w) in (('TAP.pth', (48, 64)), ('TAP2.pth', (48, 64))):
        tracks = rs.rand(12, 5, 2) * [w, h]
        tracks[1::2, 4] = -1.0
        torch.save({'pred_tracks': torch.from_numpy(tracks).float(),
                    'point_embedding': torch.from_numpy(
                        rs.randn(5, 12)).float(),
                    'point_name2id': {'a': 0, 'b': 1, 'c': 2, 'd': 3,
                                      'e': 4}}, root / name)
    return root


def _dataset_opt(root, **kw):
    return dict({'type': 'SingleVideoPointDataset',
                 'path': str(root / 'frames'),
                 'tap_path': str(root / 'TAP.pth'), 'prompt': 'a cat',
                 'num_frames': 4, 'total_frames': 12,
                 'video_transform': [{'type': 'Resize', 'size': [48, 64]},
                                     {'type': 'ToTensor'},
                                     {'type': 'Normalize', 'mean': [0.5],
                                      'std': [0.5]}]}, **kw)


@pytest.mark.parametrize('native', [True, False])
def test_dataset_pixels_frames_and_conditions_equal_jax(clip_dir, native):
    ours = build_dataset(_dataset_opt(clip_dir))
    ref = j_build_dataset(_dataset_opt(clip_dir,
                                       no_native_loader=not native))
    assert ours.select_id == ref.select_id == [0, 3, 6, 9]
    assert ours.pixels.shape == ref.pixels.shape == (4, 48, 64, 3)
    assert float(np.abs(ours.pixels - ref.pixels).max()) <= 1 / 127.5 + 1e-6
    frames = ours.get_frames()
    assert frames.dtype == np.uint8
    ref_frames = np.stack([np.asarray(f) for f in ref.get_frames()])
    assert int(np.abs(frames.astype(int) - ref_frames).max()) <= 1
    for tap in (None, str(clip_dir / 'TAP2.pth')):
        a, b = ours.get_conditions(tap), ref.get_conditions(tap)
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    assert (ours.size_x, ours.size_y, len(ours)) == (ref.size_x, ref.size_y,
                                                     len(ref))


@pytest.mark.parametrize('index_list', [None, [0, 2, 4]])
def test_overlay_points_pixel_equal_to_jax(index_list):
    rs = np.random.RandomState(5)
    f, h, w = 3, 40, 56
    frames = rs.randint(0, 256, (f, h, w, 3)).astype(np.uint8)
    tracks = np.stack([rs.uniform(-8, w + 8, (f, 9)),
                       rs.uniform(-8, h + 8, (f, 9))], -1)
    tracks[0, :5] = [[0.2, 3.7], [4.5, 4.99], [5.0, 0.0], [w - 0.1, h - 0.1],
                     [-0.5, 10.0]]
    cond = {'pred_tracks': tracks.astype(np.float32),
            'index_list': index_list}
    ref = j_overlay_points([Image.fromarray(x) for x in frames], cond)
    out = overlay_points(frames, cond)
    np.testing.assert_array_equal(out, np.stack([np.asarray(x)
                                                 for x in ref]))
    assert (out != frames).any()


@pytest.mark.parametrize('radius', [1, 2, 3, 4, 7, 12])
def test_overlay_points_other_radii_equal_jax(radius):
    frames = np.zeros((1, 40, 40, 3), np.uint8)
    cond = {'pred_tracks': np.array([[[13.3, 17.8], [25.0, 9.5]]],
                                    np.float32)}
    ref = j_overlay_points([Image.fromarray(frames[0])], cond, radius=radius)
    np.testing.assert_array_equal(overlay_points(frames, cond, radius)[0],
                                  np.asarray(ref[0]))


def test_metrics_equal_jax():
    rs = np.random.RandomState(6)
    a, b = rs.rand(3, 24, 20, 3), rs.rand(3, 24, 20, 3)
    assert metrics.psnr(a, b) == jmetrics.psnr(a, b)
    assert metrics.ssim(a[0], b[0]) == jmetrics.ssim(a[0], b[0])
    assert metrics.video_psnr(a, b) == jmetrics.video_psnr(a, b)
    assert metrics.temporal_consistency(a) == \
        jmetrics.temporal_consistency(a)
    with pytest.raises(ValueError):
        metrics.video_psnr(a, b[:2])


def test_save_video_to_dir(tmp_path):
    frames = np.stack([_smooth(16, 24, seed=i) for i in range(3)])
    save_video_to_dir(frames, str(tmp_path), 'x', save_type='frame_gif')
    for i, f in enumerate(frames):
        np.testing.assert_array_equal(
            read_png(str(tmp_path / 'frames_x' / f'{i:05d}.png')), f)
    with Image.open(tmp_path / 'x.gif') as gif:
        assert gif.n_frames == 3
    save_video_to_dir(frames, str(tmp_path), 'y', save_type='video')
    assert (tmp_path / 'y.mp4').is_file() or (tmp_path / 'y.gif').is_file()
    grid = make_grid(frames, cols=2)
    assert grid.shape == (32, 48, 3)
    np.testing.assert_array_equal(grid[16:, :24], frames[2])
