"""Preprocessing: DIFT features and semantic point tracking (the DIFT
tracker, CoTracker, OpenPose) for TAP.pth files, and optical flow
(UniMatch, weight-free matching, pyramidal LK) for the atlas stage."""

from .dift import SDFeaturizer, dift_query
from .flow import compute_bidirectional_flow, pyramid_flow
from .pose import NativePoseDetector, OpenPoseBody, convert_openpose_body
from .tracker import DIFTTracker

__all__ = ['SDFeaturizer', 'dift_query', 'DIFTTracker', 'pyramid_flow',
           'compute_bidirectional_flow', 'NativePoseDetector',
           'OpenPoseBody', 'convert_openpose_body']
