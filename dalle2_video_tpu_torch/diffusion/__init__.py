from dalle2_video_tpu_torch.diffusion.schedule import (
    DiffusionSchedule,
    extract,
    make_beta_schedule,
)

__all__ = ["DiffusionSchedule", "extract", "make_beta_schedule"]
