from .ddim import (DiffusionSchedule, ddim_inverse_step,
                   ddim_inverse_timesteps, ddim_step, ddim_timesteps,
                   make_schedule)

__all__ = [
    'DiffusionSchedule', 'make_schedule', 'ddim_timesteps',
    'ddim_inverse_timesteps', 'ddim_step', 'ddim_inverse_step',
]
