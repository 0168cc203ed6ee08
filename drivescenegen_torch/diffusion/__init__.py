from drivescenegen_torch.diffusion.cfg import (  # noqa: F401
    apply_cond_dropout,
    make_guided_denoise,
)
from drivescenegen_torch.diffusion.schedule import (  # noqa: F401
    DiffusionSchedule,
    make_schedule,
)
from drivescenegen_torch.diffusion.samplers import (  # noqa: F401
    ddpm_sample,
    ddim_sample,
    ddpm_timesteps,
    ddim_timesteps,
    dpmpp_2m_coefficients,
    dpmpp_2m_sample,
    dpmpp_2m_sde_sample,
)
