"""Low-resolution cascade conditioning (port of
dalle2_video_tpu/engine/conditioner.py): the conditioner's noise schedule,
Imagen-style noising (``noise_video``) and the training-time build of an SR
stage's conditioning video (``lowres_condition``: nearest down, a blur
coin, nearest up, optional noising).

Every random draw can be injected -- the blur coin, the noise levels and
the noise -- so tests can hand the port the JAX package's draws; what is
not injected comes from ``generator``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from dalle2_video_tpu_torch.diffusion import DiffusionSchedule
from dalle2_video_tpu_torch.ops.video import (
    gaussian_blur_video,
    resize_video,
    resize_video_time,
)
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
    keys: Optional[RowKeys],
    cond_video: torch.Tensor,
    schedule: DiffusionSchedule,
    cfg: LowresConditionerConfig,
    noise_levels: torch.Tensor,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Imagen-style noising of the conditioning video at ``noise_levels``
    (b,). ``noise`` replaces the per-row draw from ``keys`` (tests and the
    training path inject it; ``keys`` may then be None)."""
    if cfg.auto_normalize:
        cond_video = cond_video * 2.0 - 1.0
    if noise is None:
        _, k_n = keys.split()
        noise = k_n.normal(cond_video.shape, cond_video.device, cond_video.dtype)
    cond_video = schedule.q_sample(cond_video, noise_levels, noise)
    if cfg.auto_normalize:
        cond_video = (cond_video + 1.0) * 0.5
    return cond_video, noise_levels


def lowres_condition(
    video: torch.Tensor,
    cfg: LowresConditionerConfig,
    *,
    target_frame_size: int,
    downsample_frame_size: Optional[int] = None,
    target_frame_number: Optional[int] = None,
    downsample_frame_number: Optional[int] = None,
    noise_schedule: Optional[DiffusionSchedule] = None,
    should_blur: bool = True,
    generator: Optional[torch.Generator] = None,
    blur: Optional[bool] = None,
    noise_levels: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """An SR stage's conditioning video (and its noise levels when
    ``cfg.use_noise``). ``blur`` is the whole-batch blur coin; ``noise_levels``
    (b,) and ``noise`` the noising draws. Each is drawn from ``generator``
    when not given."""
    if cfg.downsample_first and downsample_frame_size is not None:
        video = resize_video(video, downsample_frame_size,
                             clamp_range=cfg.input_video_range)
    if cfg.downsample_first and downsample_frame_number is not None:
        video = resize_video_time(video, downsample_frame_number)

    if cfg.use_blur and should_blur and cfg.blur_prob > 0:
        if blur is None:
            blur = bool(torch.rand((), generator=generator,
                                   device=video.device) < cfg.blur_prob)
        if blur:
            video = gaussian_blur_video(video, cfg.blur_kernel_size, cfg.blur_sigma)

    video = resize_video(video, target_frame_size, clamp_range=cfg.input_video_range)
    if target_frame_number is not None:
        video = resize_video_time(video, target_frame_number)

    if not cfg.use_noise:
        return video, None
    if noise_schedule is None:
        raise ValueError("lowres_condition: use_noise needs the noise schedule")
    if noise_levels is None:
        noise_levels = noise_schedule.sample_random_times(video.shape[0], generator)
    if noise is None:
        noise = torch.randn(video.shape, generator=generator, device=video.device,
                            dtype=video.dtype)
    return noise_video(None, video, noise_schedule, cfg, noise_levels, noise)
