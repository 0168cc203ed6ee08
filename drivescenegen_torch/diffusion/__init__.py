from drivescenegen_torch.diffusion.schedule import (  # noqa: F401
    DiffusionSchedule,
    make_schedule,
)
from drivescenegen_torch.diffusion.samplers import (  # noqa: F401
    ddpm_sample,
    ddim_sample,
    ddpm_timesteps,
    ddim_timesteps,
)
