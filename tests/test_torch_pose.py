"""The port's OpenPose body model and PAF decode against the JAX package's
on the CPU, fp32, with the same weights: the maps of the scale search
(the cubic input resize down, the stride-8 maps' resize up by 8 and to the
image's size: jax.image.resize's 'cubic', not PyTorch's bicubic), the
cubic filter alone both ways, the peak search and the person assembly on
tests/test_pose.py's synthetic two-person maps, the detector's results on
them, and the checkpoint's two key layouts.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tests.test_pose import TINY, _person_maps
from videoswap_tpu.preprocess import pose as J
from videoswap_torch.preprocess import pose as T

TINY_T = T.OpenPoseBodyConfig(**TINY.__dict__)
SCALES = (0.5, 1.0)


@pytest.fixture(scope='module')
def model():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    torch.manual_seed(0)
    m = T.OpenPoseBody(TINY_T).eval()
    yield m, J.convert_openpose_body(m.state_dict())
    torch.set_num_threads(n)


@pytest.mark.parametrize('hw', [(48, 40), (30, 64)])
def test_maps_match_jax(model, hw, monkeypatch):
    """Two scales (the shipped detector searches one)."""
    m, params = model
    monkeypatch.setattr(T, 'SCALES', SCALES)
    img = (np.random.RandomState(hw[0]).rand(*hw, 3) * 255).astype(np.uint8)
    ref = J.NativePoseDetector(params, cfg=TINY,
                               scale_search=SCALES)._maps(img)
    out = T.NativePoseDetector(m)._maps(img)
    for name, a, b in zip(('paf', 'heat'), out, ref):
        assert a.shape == b.shape == hw + ((38,) if name == 'paf' else
                                           (19,))
        assert np.abs(a - b).max() <= 1e-4 * np.abs(b).max(), name


@pytest.mark.parametrize('shape', [(20, 31), (80, 101), (37, 20), (74, 53)])
def test_cubic_resize_is_jaxs(shape):
    """jax.image.resize's 'cubic' down (antialiased) and up; PyTorch's
    bicubic (a = -0.75, clamped border) is not it."""
    x = np.random.RandomState(1).rand(37, 53, 3).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), shape + (3,), 'cubic'))
    out = T.resize_cubic(torch.from_numpy(x), *shape).numpy()
    assert np.abs(out - ref).max() <= 1e-5
    if shape[0] > 37:
        torch_bicubic = F.interpolate(
            torch.from_numpy(x).permute(2, 0, 1)[None], size=shape,
            mode='bicubic', align_corners=False)[0].permute(1, 2, 0)
        assert np.abs(torch_bicubic.numpy() - ref).max() > 1e-3


def _two_people():
    heat = np.zeros((64, 64, 19), np.float32)
    paf = np.zeros((64, 64, 38), np.float32)
    person_a = {1: (20, 10), 2: (12, 18), 3: (12, 30), 4: (12, 42),
                5: (28, 18)}
    person_b = {k: (x + 30, y + 14) for k, (x, y) in person_a.items()}
    _person_maps(heat, paf, person_a)
    _person_maps(heat, paf, person_b)
    return paf, heat


def test_peaks_and_assembly_match_jax():
    paf, heat = _two_people()
    peaks = T.find_peaks(heat)
    assert peaks == J.find_peaks(heat)
    cand, subsets = T.assemble_people(peaks, paf)
    jcand, jsubsets = J.assemble_people(J.find_peaks(heat), paf)
    np.testing.assert_array_equal(cand, jcand)
    assert len(subsets) == len(jsubsets) == 2
    for a, b in zip(subsets, jsubsets):
        np.testing.assert_array_equal(a, b)


def test_detect_poses_matches_jax(model):
    """detect_poses on the synthetic maps (each detector's `_maps` replaced
    by them): the same people, keypoints normalised to the image."""
    m, params = model
    paf, heat = _two_people()
    det_t = T.NativePoseDetector(m)
    det_j = J.NativePoseDetector(params, cfg=TINY)
    det_t._maps = det_j._maps = lambda img: (paf, heat)
    img = np.zeros((64, 64, 3), np.uint8)
    out, ref = det_t.detect_poses(img), det_j.detect_poses(img)
    assert len(out) == len(ref) == 2
    for a, b in zip(out, ref):
        assert a.body.total_score == b.body.total_score
        assert [None if k is None else (k.x, k.y) for k in a.body.keypoints] \
            == [None if k is None else (k.x, k.y) for k in b.body.keypoints]


def test_prefixless_keys_load_as_scoped(model, tmp_path):
    """The public file's prefix-less keys (`conv1_1.weight`) and the scoped
    ones give the same model; a key short raises; chip_smoke.py's synthetic
    body_pose_model.pth (the published key set) loads from its file."""
    m, _ = model
    sd = m.state_dict()
    flat = {k.split('.', 1)[1]: v for k, v in sd.items()}
    assert T.convert_openpose_body(flat).keys() == sd.keys()
    fresh = T.OpenPoseBody(TINY_T)
    T.load_openpose_state(fresh, flat)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
    with pytest.raises(RuntimeError, match='Mconv7_stage2_L2.bias'):
        T.load_openpose_state(T.OpenPoseBody(TINY_T), {
            k: v for k, v in flat.items() if k != 'Mconv7_stage2_L2.bias'})
    for name, scope in (('conv1_1', 'model0'), ('conv4_4_CPM', 'model0'),
                        ('conv5_5_CPM_L1', 'model1_1'),
                        ('Mconv7_stage6_L2', 'model6_2')):
        assert T._scope_for_layer(name) == J._scope_for_layer(name) == scope
    from tests.test_torch_cotracker import _chip_smoke
    full = _chip_smoke().synthetic_openpose_state()
    torch.save(full, tmp_path / 'body_pose_model.pth')
    det = T.NativePoseDetector.from_checkpoint(
        str(tmp_path / 'body_pose_model.pth'), 'cpu')
    assert det.model.cfg == T.OpenPoseBodyConfig()
    assert torch.equal(det.model.model6_2.Mconv7_stage6_L2.bias,
                       full['Mconv7_stage6_L2.bias'])
