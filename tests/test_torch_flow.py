"""The port's weight-free optical flow (videoswap_torch/preprocess/) against
the JAX package's (videoswap_tpu/preprocess/flow.py, matching_flow.py), fp32
on the CPU, on frames made from a numpy seed: a smooth texture moved by a
known translation, or a rotation, at 64x48 and at 70x50 (not a multiple of
the matching stride); then the extract_flow CLI's files and the
refusals of what is not ported.

Tolerances: the gray frames and the pyramid resizes within 2.4e-7
(jax.image.resize's antialiased bilinear against F.interpolate(antialias=
True): fp32 rounding of the same filter); the patch descriptors within 1e-6; the LK pyramid and
the whole matching flow within 1e-4 px (fp32 rounding through 40 LK
iterations; 1e-3 px at a few pixels of the matching flow); FFT peaks
equal. Where an argmax or argmin picks between
values closer than 1e-5 (a tie or a near-tie, which fp32 rounding may flip),
the test reads the JAX package's values and leaves those entries out, and
states their share.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from videoswap_tpu.atlas.data import load_input_data as j_load_input_data
from videoswap_tpu.preprocess import flow as jflow
from videoswap_tpu.preprocess import matching_flow as jmatch
from videoswap_torch import extract_flow, train_atlas
from videoswap_torch.preprocess import flow as tflow
from videoswap_torch.preprocess import matching_flow as tmatch

ROOT = Path(__file__).resolve().parents[1]
NEAR_TIE = 1e-5


@pytest.fixture(autouse=True, scope='module')
def _few_torch_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _texture(x, y, seed=0):
    """A smooth RGB texture of plane waves (wavelengths 6-25 px) at float
    pixel coordinates."""
    rs = np.random.RandomState(seed)
    out = np.zeros(x.shape + (3,), np.float64)
    for c in range(3):
        for _ in range(5):
            ang, ph = rs.rand(2) * 2 * np.pi
            k = 2 * np.pi / rs.uniform(6, 25)
            out[..., c] += np.sin(k * (np.cos(ang) * x + np.sin(ang) * y)
                                  + ph)
    return (0.5 + out / 10).astype(np.float32)


def _pair(h, w, motion):
    """(frame0, frame1, true flow of frame0's pixels): frame1 is frame0's
    content moved by `motion` ('shift', (dx, dy)) or ('rotate', degrees
    about the centre)."""
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    f0 = _texture(xs, ys)
    kind, arg = motion
    if kind == 'shift':
        dx, dy = arg
        f1 = _texture(xs - dx, ys - dy)
        true = np.broadcast_to(np.array([dx, dy]), (h, w, 2))
    else:
        th = np.deg2rad(arg)
        cx, cy = (w - 1) / 2, (h - 1) / 2
        # frame1(p) = frame0(R^-1 (p - c) + c)
        c, s = np.cos(th), np.sin(th)
        bx = c * (xs - cx) + s * (ys - cy) + cx
        by = -s * (xs - cx) + c * (ys - cy) + cy
        f1 = _texture(bx, by)
        fx = c * (xs - cx) - s * (ys - cy) + cx - xs
        fy = s * (xs - cx) + c * (ys - cy) + cy - ys
        true = np.stack([fx, fy], -1)
    return f0, f1, true.astype(np.float32)


MOTIONS = {'shift': ('shift', (3.4, -2.2)), 'rotate': ('rotate', 4.0)}
SIZES = {'64x48': (48, 64), '70x50': (50, 70)}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize('size', sorted(SIZES))
def test_resize_matches_jax_at_every_pyramid_level(size):
    """Every resize the pyramids make: the gray frame down to each level of
    pyramid_flow's four and of the matching refinement's two, and each
    level's flow up to the next; rgb and 2-channel maps too."""
    h, w = SIZES[size]
    f0, _, _ = _pair(h, w, MOTIONS['shift'])
    g = np.asarray(jflow._gray(jnp.asarray(f0)))
    np.testing.assert_allclose(tflow._gray(_t(f0)).numpy(), g, rtol=0,
                               atol=2.4e-7)
    shapes = tflow._levels(h, w, 4)
    assert shapes == [(max(h >> lv, 8), max(w >> lv, 8)) for lv in range(4)]
    rs = np.random.RandomState(1)
    for i, (lh, lw) in enumerate(shapes):
        for img in (g, f0, rs.randn(h, w, 2).astype(np.float32)):
            ref = np.asarray(jflow._resize(jnp.asarray(img[..., None]
                                                       if img.ndim == 2
                                                       else img), lh, lw))
            out = tflow._resize(_t(img), lh, lw).numpy()
            np.testing.assert_allclose(out, ref.reshape(out.shape), rtol=0,
                                       atol=2.4e-7, err_msg=f'{lh}x{lw}')
        if i:
            small = rs.randn(lh, lw, 2).astype(np.float32)
            up = shapes[i - 1]
            np.testing.assert_allclose(
                tflow._resize(_t(small), *up).numpy(),
                np.asarray(jflow._resize(jnp.asarray(small), *up)), rtol=0,
                atol=2.4e-7)


@pytest.mark.parametrize('size', sorted(SIZES))
def test_patch_features_matches_jax(size):
    h, w = SIZES[size]
    f0, _, _ = _pair(h, w, MOTIONS['shift'])
    ref = np.asarray(jmatch.patch_features(jnp.asarray(f0)))
    out = tmatch.patch_features(_t(f0)).numpy()
    assert out.shape == ref.shape == (h // 8, w // 8, 363)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        tmatch._grid_coords(6, 8, 8).numpy(),
        np.asarray(jmatch._grid_coords(6, 8, 8)))


def _second_gap(a, axis):
    """The gap between the largest and second largest values along axis."""
    s = np.sort(a, axis=axis)
    return np.take(s, -1, axis) - np.take(s, -2, axis)


@pytest.mark.parametrize('motion', sorted(MOTIONS))
def test_global_match_matches_jax_away_from_ties(motion):
    """The coarse matched flow and its confidence, where no forward match,
    and no match's backward match, is a near-tie in the JAX correlation
    (none is, in these frames): the confidence within 1e-5, the flow
    within 1e-5 of its largest entry (the propagation's softmax-weighted
    sums over every cell, fp32)."""
    f0, f1, _ = _pair(48, 64, MOTIONS[motion])
    j0, j1 = (jmatch.patch_features(jnp.asarray(f)) for f in (f0, f1))
    jflow_, jconf = (np.asarray(a) for a in jmatch._global_match(j0, j1, 8))
    tf, tc = tmatch._global_match(_t(np.asarray(j0)), _t(np.asarray(j1)), 8)
    n = j0.shape[0] * j0.shape[1]
    corr = np.asarray(j0).reshape(n, -1) @ np.asarray(j1).reshape(n, -1).T
    ties = (_second_gap(corr, 1) < NEAR_TIE) | (
        _second_gap(corr, 0)[corr.argmax(1)] < NEAR_TIE)
    assert ties.mean() == 0.0
    np.testing.assert_allclose(tc.numpy(), jconf, rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.numpy(), jflow_, rtol=0,
                               atol=1e-5 * max(np.abs(jflow_).max(), 1.0))
    assert (jconf > 0).mean() >= 0.5      # half the cells or more confident


def test_photometric_select_matches_jax_away_from_ties():
    """Four candidate flows (three constant, one random): the choice equal
    on every pixel whose two least smoothed errors are not a near-tie
    (their share stated: 2 of 3072 pixels here, under 1e-3), and the first
    candidate taken on exact ties (two equal candidates)."""
    f0, f1, _ = _pair(48, 64, MOTIONS['shift'])
    rs = np.random.RandomState(3)
    cands = np.stack([np.full((48, 64, 2), v, np.float32)
                      for v in ((3.4, -2.2), (3.0, -2.0), (3.4, -2.2))]
                     + [rs.randn(48, 64, 2).astype(np.float32) * 2])
    ref = np.asarray(jmatch._photometric_select(
        jnp.asarray(f0), jnp.asarray(f1), jnp.asarray(cands)))
    out = tmatch._photometric_select(_t(f0), _t(f1), _t(cands)).numpy()
    g0, g1 = jflow._gray(jnp.asarray(f0)), jflow._gray(jnp.asarray(f1))
    errs = np.stack([np.asarray(jflow.jax.scipy.signal.convolve2d(
        jnp.abs(jflow._warp(g1, jnp.asarray(c)) - g0),
        jnp.ones((7, 7)) / 49.0, mode='same')) for c in cands])
    gap = -_second_gap(-errs, 0)          # smallest two, as a gap <= 0
    distinct = np.abs(gap) >= NEAR_TIE
    exact_tie = gap == 0
    assert 0.5 < exact_tie.mean()
    assert ((~distinct) & (~exact_tie)).mean() < 1e-3
    np.testing.assert_array_equal(out[distinct | exact_tie],
                                  ref[distinct | exact_tie])
    # the box filter: zero-padded 'same', in fp32 sums
    e = np.abs(rs.randn(13, 11)).astype(np.float32)
    np.testing.assert_allclose(
        tflow.box_filter(_t(e), 7).numpy(),
        np.asarray(jflow.jax.scipy.signal.convolve2d(
            jnp.asarray(e), jnp.ones((7, 7)) / 49.0, mode='same')),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize('size', sorted(SIZES))
def test_phase_correlation_shifts_match_jax(size):
    """Noise moved by (5, -3) px with wraparound: the same peaks, the first
    at the shift."""
    h, w = SIZES[size]
    f0 = np.random.RandomState(5).rand(h, w, 3).astype(np.float32)
    f1 = np.roll(f0, (-3, 5), axis=(0, 1))
    ref = np.asarray(jmatch.phase_correlation_shifts(jnp.asarray(f0),
                                                     jnp.asarray(f1), k=3))
    out = tmatch.phase_correlation_shifts(_t(f0), _t(f1), k=3).numpy()
    np.testing.assert_array_equal(out, ref)
    np.testing.assert_array_equal(out[0], [5.0, -3.0])


@pytest.mark.parametrize('motion', sorted(MOTIONS))
def test_pyramid_flow_matches_jax(motion):
    f0, f1, true = _pair(48, 64, MOTIONS[motion])
    ref = np.asarray(jflow.pyramid_flow(jnp.asarray(f0), jnp.asarray(f1)))
    out = tflow.pyramid_flow(_t(f0), _t(f1)).numpy()
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-4)
    inner = (slice(8, -8), slice(8, -8))
    assert np.median(np.linalg.norm(out - true, axis=-1)[inner]) < 0.1


@pytest.mark.parametrize('case', ['shift-64x48', 'rotate-64x48',
                                  'shift-70x50'])
def test_global_matching_flow_matches_jax(case):
    """The whole matching flow, edge padding to the stride included:
    within 1e-3 px of the JAX package's everywhere and within 1e-4 px on
    all but 0.2% of the pixels (fp32 rounding that a few pixels' LK
    iterations amplify: 4.3e-4 px at most read here), and its median
    error against the true motion under 0.15 px (away from the border)."""
    motion, size = case.split('-')
    f0, f1, true = _pair(*SIZES[size], MOTIONS[motion])
    ref = np.asarray(jmatch.global_matching_flow(f0, f1))
    out = tmatch.global_matching_flow(_t(f0), _t(f1)).numpy()
    assert out.shape == ref.shape == f0.shape[:2] + (2,)
    d = np.linalg.norm(out - ref, axis=-1)
    assert d.max() < 1e-3 and (d > 1e-4).mean() < 2e-3
    inner = (slice(8, -8), slice(8, -8))
    assert np.median(np.linalg.norm(out - true, axis=-1)[inner]) < 0.15


def test_external_features_go_through_the_grid():
    """feat0 / feat1 from a coarser native grid: resized onto the match
    grid (antialiased bilinear, L2-normalised) as the JAX package does;
    one of the pair alone is refused."""
    f0, f1, _ = _pair(48, 64, MOTIONS['shift'])
    rs = np.random.RandomState(4)
    feat = rs.randn(3, 4, 16).astype(np.float32)
    np.testing.assert_allclose(tmatch._to_grid(feat, 6, 8).numpy(),
                               np.asarray(jmatch._to_grid(feat, 6, 8)),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match='together'):
        tmatch.global_matching_flow(_t(f0), _t(f1), feat0=feat)


def _write_frames(d: Path, frames):
    from PIL import Image
    d.mkdir(parents=True, exist_ok=True)
    for i, f in enumerate(frames):
        Image.fromarray((np.clip(f, 0, 1) * 255).round().astype(
            np.uint8)).save(d / f'{i:05d}.png')


def test_extract_flow_cli_writes_what_the_atlas_loader_reads(tmp_path,
                                                            capsys):
    """Three 40x30 frames: one [2, H, W, 2] float32 file per pair, the
    direct call's bits, the JAX CLI's range lines; the JAX package's
    load_input_data reads the files at another size (32x24) as the port's
    does."""
    h, w = 30, 40
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float64)
    frames = [_texture(xs - 1.5 * i, ys - 0.5 * i) for i in range(3)]
    _write_frames(tmp_path / 'frames', frames)
    _write_frames(tmp_path / 'masks', [np.zeros((h, w, 3))] * 3)
    written = extract_flow.cli(['--frame_dir', str(tmp_path / 'frames'),
                                '--out_dir', str(tmp_path / 'flows'),
                                '--method', 'lk', '--device', 'cpu'])
    assert [Path(p).name for p in written] == ['00000.npy', '00001.npy']
    printed = capsys.readouterr().out.strip().splitlines()
    for i, p in enumerate(written):
        fl = np.load(p)
        assert fl.shape == (2, h, w, 2) and fl.dtype == np.float32
        read = [extract_flow.read_frame(tmp_path / 'frames' / f'{j:05d}.png')
                for j in (i, i + 1)]
        np.testing.assert_array_equal(fl, tflow.compute_bidirectional_flow(
            *read, method='lk', device='cpu'))
        assert printed[i] == (f'{i:05d}.npy: flow range '
                              f'[{fl.min():.2f}, {fl.max():.2f}]')
        # forward and backward: the known motion, opposite signs
        np.testing.assert_allclose(np.median(fl[0, 8:-8, 8:-8], (0, 1)),
                                   [1.5, 0.5], atol=0.1)
        np.testing.assert_allclose(np.median(fl[1, 8:-8, 8:-8], (0, 1)),
                                   [-1.5, -0.5], atol=0.1)
    opt = {'frame_path': str(tmp_path / 'frames'),
           'mask_path': str(tmp_path / 'masks'),
           'flow_path': str(tmp_path / 'flows'),
           'res_x': 32, 'res_y': 24, 'max_frames': 72}
    from videoswap_torch.atlas.data import load_input_data
    ref, out = j_load_input_data(opt), load_input_data(opt)
    for k in ('flows', 'flows_rev', 'flow_masks', 'flow_masks_rev'):
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)
    assert 0 < ref['flow_masks'][:2].mean()


def test_auto_picks_what_the_jax_cli_picks(tmp_path, monkeypatch):
    """'auto' is 'matching' with no UniMatch checkpoint on disk and
    'unimatch' with one, as in the JAX package; 'unimatch' without a
    checkpoint raises FileNotFoundError, as the JAX package's does
    (tests/test_torch_unimatch.py runs it on a checkpoint)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv('VS_UNIMATCH_CKPT', '')
    assert tflow.resolve_method('auto') == 'matching'
    assert jflow.find_unimatch_checkpoint() is None
    assert tflow.find_unimatch_checkpoint() is None
    with pytest.raises(FileNotFoundError, match='gmflow-scale2-regrefine6'):
        tflow.resolve_method('unimatch')
    with pytest.raises(FileNotFoundError, match='gmflow-scale2-regrefine6'):
        jflow.compute_bidirectional_flow(np.zeros((16, 16, 3)),
                                         np.zeros((16, 16, 3)), 'unimatch')
    ckpt = tmp_path / 'pretrained_models' / \
        'gmflow-scale2-regrefine6-mixdata.pth'
    ckpt.parent.mkdir()
    ckpt.write_bytes(b'')
    assert tflow.find_unimatch_checkpoint() == \
        jflow.find_unimatch_checkpoint()
    assert tflow.resolve_method('auto') == 'unimatch'


def test_the_clis_refuse_what_is_not_ported_and_want_cuda(tmp_path):
    """--method unimatch without a checkpoint on disk is refused before
    anything runs; without --device cpu the CLIs want a CUDA device and
    raise on a machine without one."""
    with pytest.raises(FileNotFoundError, match='gmflow-scale2-regrefine6'):
        extract_flow.cli(['--frame_dir', str(tmp_path), '--out_dir',
                          str(tmp_path / 'o'), '--method', 'unimatch'])
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match='no CUDA device'):
        extract_flow.cli(['--frame_dir', str(tmp_path), '--out_dir',
                          str(tmp_path / 'o'), '--method', 'matching'])
    from videoswap_torch import propagate_point_displacement as ppd
    for argv in (['-opt', str(tmp_path / 'x.yml')], ):
        with pytest.raises(RuntimeError, match='no CUDA device'):
            train_atlas.main(argv)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ppd.main(['--atlas_config_path', 'a', '--atlas_model_path', 'b',
                  '--source_tap_path', 'c', '--source_point_path', 'd',
                  '--target_point_path', 'e'])


def test_python_m_runs_the_cli(tmp_path):
    """`python3 -m videoswap_torch.extract_flow` as a user runs it."""
    ys, xs = np.mgrid[0:24, 0:32].astype(np.float64)
    _write_frames(tmp_path / 'f', [_texture(xs - i, ys) for i in range(2)])
    env = dict(os.environ, OMP_NUM_THREADS='2')
    proc = subprocess.run(
        [sys.executable, '-m', 'videoswap_torch.extract_flow', '--frame_dir',
         str(tmp_path / 'f'), '--out_dir', str(tmp_path / 'o'), '--method',
         'matching', '--device', 'cpu'], capture_output=True, text=True,
        timeout=300, cwd=str(ROOT), env=env)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert proc.stdout.startswith('00000.npy: flow range')
    assert np.load(tmp_path / 'o' / '00000.npy').shape == (2, 24, 32, 2)
