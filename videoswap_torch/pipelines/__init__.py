from .trainer import VideoSwapTrainer, sample_biased_timestep
from .videoswap_pipeline import VideoSwapPipeline, rescale_noise_cfg

__all__ = ['VideoSwapPipeline', 'rescale_noise_cfg', 'VideoSwapTrainer',
           'sample_biased_timestep']
