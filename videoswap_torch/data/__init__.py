from .concept_dataset import ConceptImageDataset
from .frame_point_dataset import SingleVideoPointDataset
from .transforms import build_transform

from videoswap_torch.utils.registry import DATASET_REGISTRY


def build_dataset(opt: dict):
    """The dataset a config's `datasets` block names (its `type`)."""
    opt = dict(opt)
    return DATASET_REGISTRY.get(opt.pop('type'))(opt)


__all__ = ['ConceptImageDataset', 'SingleVideoPointDataset',
           'build_transform', 'build_dataset']
