from .ddim import (DiffusionSchedule, add_noise, ddim_inverse_step,
                   ddim_inverse_timesteps, ddim_step, ddim_timesteps,
                   get_velocity, make_schedule)

__all__ = [
    'DiffusionSchedule', 'make_schedule', 'ddim_timesteps',
    'ddim_inverse_timesteps', 'ddim_step', 'ddim_inverse_step', 'add_noise',
    'get_velocity',
]
