from .ddim import (DiffusionSchedule, add_noise, ddim_inverse_step,
                   ddim_inverse_timesteps, ddim_step, ddim_timesteps,
                   get_velocity, make_schedule)
from .dpm import dpm_pp_2m_step, dpm_timesteps

__all__ = [
    'DiffusionSchedule', 'make_schedule', 'ddim_timesteps',
    'ddim_inverse_timesteps', 'ddim_step', 'ddim_inverse_step', 'add_noise',
    'get_velocity', 'dpm_timesteps', 'dpm_pp_2m_step',
]
