"""The port's DIFT tracker against the JAX package's on the CPU, fp32: the
cosine maps, the sub-pixel fit and whole tracks on tests/test_preprocess.py's
clip (a textured image translated by known amounts, the keyframe in the
middle, the flow guidance on), with its patch-descriptor stand-in for the
featurizer. The JAX tracker runs once, in a module-scoped fixture.
"""

import numpy as np
import pytest
import torch

from tests.test_preprocess import _PatchFeaturizer
from videoswap_tpu.preprocess import tracker as jtracker
from videoswap_torch.preprocess import tracker as ttracker

SHIFTS = [(-4, -2), (-2, -1), (0, 0), (3, 1), (6, 2)]     # keyframe 2
POINTS = np.asarray([[30.0, 25.0], [50.0, 40.0], [20.0, 45.0]])


def _clip():
    base = np.random.RandomState(0).rand(64, 80, 3).astype(np.float32)
    return [np.roll(np.roll(base, dy, axis=0), dx, axis=1)
            for dx, dy in SHIFTS]


@pytest.fixture(scope='module')
def tracks():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    frames = _clip()
    ref = jtracker.DIFTTracker(_PatchFeaturizer()).track(
        frames, 2, POINTS, 'texture')
    out = ttracker.DIFTTracker(_PatchFeaturizer(), device='cpu').track(
        frames, 2, POINTS, 'texture')
    yield ref, out
    torch.set_num_threads(n)


def test_tracks_match_jax(tracks):
    """Every frame, before and after the keyframe, within 0.01 px of the
    JAX tracker's (no near-tie: the true match's cosine is 1, the runner-up
    < 0.999 on this clip)."""
    ref, out = tracks
    assert out.shape == ref.shape == (len(SHIFTS), len(POINTS), 2)
    assert out.dtype == np.float32
    assert np.abs(out - ref).max() <= 0.01


def test_tracks_recover_the_known_motion(tracks):
    _, out = tracks
    for fi, (dx, dy) in enumerate(SHIFTS):
        assert np.abs(out[fi] - (POINTS + [dx, dy])).max() <= 1.5


def test_tracks_take_given_features():
    """Features handed in (the CLI computes each frame's once) give the
    tracks the featurizer's own would."""
    frames = _clip()[:3]
    feat = _PatchFeaturizer()
    tracker = ttracker.DIFTTracker(feat, device='cpu')
    given = [feat.forward(f, '') for f in frames]
    np.testing.assert_array_equal(
        tracker.track(frames, 1, POINTS, 'texture', feats=given),
        tracker.track(frames, 1, POINTS, 'texture'))


def test_cos_maps_and_subpixel_match_jax():
    rs = np.random.RandomState(4)
    feat = rs.randn(9, 11, 32).astype(np.float32)
    vecs = rs.randn(3, 32).astype(np.float32)
    ref = jtracker._cos_maps(feat, vecs)
    out = ttracker._cos_maps(torch.from_numpy(feat),
                             torch.from_numpy(vecs)).numpy()
    assert np.abs(out - ref).max() <= 1e-6
    cos = ref[..., 0].astype(np.float32)
    for by, bx in ((4, 5), (0, 3), (8, 10), (2, 0)):
        assert ttracker._subpixel(cos, by, bx) == \
            jtracker._subpixel(cos, by, bx)


def test_no_thirdparty_cotracker(tmp_path):
    assert ttracker.load_thirdparty_cotracker(str(tmp_path / 'none')) is None
