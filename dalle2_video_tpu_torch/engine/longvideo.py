"""Long video by sliding-window extension (port of
dalle2_video_tpu/engine/longvideo.py).

The decoder samples clips of its training length T only. A longer video is
a chain of windows: window 0 is a plain cascade sample, and every later
window is a conditional sample whose first ``overlap`` frames are clamped to
the tail of what is already generated (inpainting by replacement, or by
reconstruction guidance), advancing the video by T - overlap frames. Under
``replace`` the frames already emitted never change. Windows stay on the
device and the video grows by one concatenation per window.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

from dalle2_video_tpu_torch.engine.decoder import VideoDecoder
from dalle2_video_tpu_torch.utils.keys import RowKeys


def plan_windows(decoder: VideoDecoder, n_frames: int, overlap: Optional[int],
                 inpaint_method: str = "replace",
                 stop_at_unet_number: Optional[int] = None) -> Tuple[int, int, int]:
    """(window length T, overlap, number of windows) of a long-video
    request, refused before anything is sampled where it cannot run: an
    overlap outside (0, T), fewer than T frames, or windows past the first
    whose ``inpaint_method`` the decoder refuses (``check_inpaint``)."""
    t_win = decoder.config.frame_numbers[(stop_at_unet_number or decoder.config.num_unets) - 1]
    if overlap is None:
        overlap = max(1, t_win // 4)
    if not 0 < overlap < t_win:
        raise ValueError(f"overlap must be in (0, {t_win}), got {overlap}")
    if n_frames < t_win:
        raise ValueError(
            f"n_frames ({n_frames}) must be >= the decoder window ({t_win}); "
            f"use decoder.sample + resize_video_time for shorter clips")
    n_windows = 1 + math.ceil(max(0, n_frames - t_win) / (t_win - overlap))
    if n_windows > 1:
        decoder.check_inpaint(inpaint_method, 1, stop_at_unet_number)
    return t_win, overlap, n_windows


def generate_long_video(
    decoder: VideoDecoder,
    keys: RowKeys,
    *,
    n_frames: int,
    overlap: Optional[int] = None,
    video_embed: Optional[torch.Tensor] = None,
    batch_size: int = 1,
    cond_scale: float = 1.0,
    inpaint_method: str = "replace",
    inpaint_guidance_weight: float = 10.0,
    max_batch_size: Optional[int] = None,
    negative_video_embed: Optional[torch.Tensor] = None,
    stop_at_unet_number: Optional[int] = None,
    sample_timesteps: Union[None, int, Sequence[Optional[int]]] = None,
    draws: Optional[Sequence[Dict[str, Any]]] = None,
) -> torch.Tensor:
    """(b, n_frames, S, S, C) from a decoder trained on T-frame clips (T =
    the last sampled stage's frame number), T <= n_frames. ``overlap``
    defaults to T // 4. ``keys`` holds one key per row; window j samples from
    the j-th of an independent split of them, so the whole video is a
    function of each row's own key. ``draws[j]`` (optional) holds injected
    draws for window j's ``decoder.sample`` (init_noises, known_noises)."""
    t_win, overlap, n_windows = plan_windows(decoder, n_frames, overlap, inpaint_method,
                                             stop_at_unet_number)
    stride = t_win - overlap
    if video_embed is not None:
        batch_size = video_embed.shape[0]
    window_keys = keys.split(n_windows)
    common = dict(video_embed=video_embed, batch_size=batch_size, cond_scale=cond_scale,
                  max_batch_size=max_batch_size, negative_video_embed=negative_video_embed,
                  stop_at_unet_number=stop_at_unet_number, sample_timesteps=sample_timesteps)
    window_draws = lambda j: {} if draws is None else dict(draws[j])

    video = decoder.sample(window_keys[0], **common, **window_draws(0))
    s = video.shape[2]
    # the known frames of every later window: its leading `overlap` frames
    mask = torch.zeros((1, t_win, 1, 1, 1), device=video.device)
    mask[:, :overlap] = 1.0
    pad = video.new_zeros((video.shape[0], stride, s, s, video.shape[-1]))
    for j in range(1, n_windows):
        known = torch.cat([video[:, -overlap:], pad], dim=1)
        win = decoder.sample(window_keys[j], inpaint_video=known, inpaint_mask=mask,
                             inpaint_method=inpaint_method,
                             inpaint_guidance_weight=inpaint_guidance_weight,
                             **common, **window_draws(j))
        video = torch.cat([video, win[:, overlap:]], dim=1)
    return video[:, :n_frames]
