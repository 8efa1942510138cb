"""Low-resolution cascade conditioning, the sampling half (port of
dalle2_video_tpu/engine/conditioner.py: make_noise_schedule, noise_video).
The training-time blur/noise augmentation (lowres_condition) belongs to the
training slice."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dalle2_video_tpu_torch.diffusion import DiffusionSchedule
from dalle2_video_tpu_torch.utils.keys import RowKeys


@dataclasses.dataclass(frozen=True)
class LowresConditionerConfig:
    downsample_first: bool = True
    use_blur: bool = True
    blur_prob: float = 0.5
    blur_sigma: float = 0.6
    blur_kernel_size: int = 3
    use_noise: bool = False
    input_video_range: Tuple[float, float] = (0.0, 1.0)
    auto_normalize: bool = True


def make_noise_schedule(device: torch.device = torch.device("cpu")) -> DiffusionSchedule:
    """The conditioner's own schedule: linear, 1000 steps."""
    return DiffusionSchedule.create("linear", timesteps=1000, device=device)


def noise_video(
    keys: RowKeys,
    cond_video: torch.Tensor,
    schedule: DiffusionSchedule,
    cfg: LowresConditionerConfig,
    noise_levels: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Imagen-style noising of the conditioning video at ``noise_levels``
    (b,). ``noise`` replaces the per-row draw (tests inject it)."""
    _, k_n = keys.split()
    if cfg.auto_normalize:
        cond_video = cond_video * 2.0 - 1.0
    if noise is None:
        noise = k_n.normal(cond_video.shape, cond_video.device, cond_video.dtype)
    cond_video = schedule.q_sample(cond_video, noise_levels, noise)
    if cfg.auto_normalize:
        cond_video = (cond_video + 1.0) * 0.5
    return cond_video, noise_levels
