from .adapter import AdapterConfig, SparsePointAdapter
from .unet3d import AnimateDiffUNet3DModel, UNet3DConfig

__all__ = [
    'AnimateDiffUNet3DModel', 'UNet3DConfig', 'SparsePointAdapter',
    'AdapterConfig',
]
