from dalle2_video_tpu_torch.diffusion.schedule import (
    NAT,
    DiffusionSchedule,
    approx_standard_normal_cdf,
    discretized_gaussian_log_likelihood,
    extract,
    make_beta_schedule,
    normal_kl,
)

__all__ = [
    "NAT",
    "DiffusionSchedule",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "extract",
    "make_beta_schedule",
    "normal_kl",
]
