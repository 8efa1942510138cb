"""Video tensor ops in the JAX layout (B, T, H, W, C) (port of
dalle2_video_tpu/ops/video.py).

Nearest resizing uses ``F.interpolate(mode="nearest-exact")``: it takes
source index floor((i + 0.5) * in / out), as ``jax.image.resize`` does.
``mode="nearest"`` takes floor(i * in / out) and disagrees with the
reference on 128->64, 90->16, 7->3 and 3->7.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

__all__ = [
    "resize_video",
    "resize_video_time",
    "gaussian_blur_video",
    "pixel_unshuffle_spatial",
    "pixel_shuffle_spatial",
    "paired_random_crop",
]


def _frames_nchw(x: torch.Tensor) -> torch.Tensor:
    """(B, T, H, W, C) -> (B*T, C, H, W) view in channels_last memory."""
    b, t, h, w, c = x.shape
    return x.reshape(b * t, h, w, c).permute(0, 3, 1, 2)


def resize_video(
    x: torch.Tensor,
    size: int,
    method: str = "nearest",
    clamp_range: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Resize every frame to (size, size); time preserved."""
    if method != "nearest":
        raise NotImplementedError(f"resize method {method!r} is not ported")
    b, t, h, w, c = x.shape
    if h == size and w == size and clamp_range is None:
        return x
    if (h, w) != (size, size):
        y = F.interpolate(_frames_nchw(x), size=(size, size), mode="nearest-exact")
        x = y.permute(0, 2, 3, 1).reshape(b, t, size, size, c)
    if clamp_range is not None:
        x = x.clamp(clamp_range[0], clamp_range[1])
    return x


def resize_video_time(
    x: torch.Tensor, num_frames: int, method: str = "nearest"
) -> torch.Tensor:
    """Resample the frame axis to ``num_frames`` (temporal SR conditioning)."""
    if method != "nearest":
        raise NotImplementedError(f"resize method {method!r} is not ported")
    b, t, h, w, c = x.shape
    if t == num_frames:
        return x
    y = x.reshape(b, t, h * w * c).transpose(1, 2)  # (b, hwc, t)
    y = F.interpolate(y, size=num_frames, mode="nearest-exact")
    return y.transpose(1, 2).reshape(b, num_frames, h, w, c)


def _gaussian_kernel1d(kernel_size: int, sigma: float, device) -> torch.Tensor:
    x = torch.arange(kernel_size, dtype=torch.float32, device=device) - (kernel_size - 1) / 2.0
    g = torch.exp(-(x**2) / (2.0 * sigma**2))
    return g / g.sum()


def gaussian_blur_video(
    x: torch.Tensor, kernel_size: int = 3, sigma: float = 0.6
) -> torch.Tensor:
    """Per-frame separable Gaussian blur with reflect padding."""
    b, t, h, w, c = x.shape
    k = _gaussian_kernel1d(kernel_size, sigma, x.device).to(x.dtype)
    pad = kernel_size // 2
    y = F.pad(_frames_nchw(x), (pad, pad, pad, pad), mode="reflect")
    kh = k.reshape(1, 1, kernel_size, 1).expand(c, 1, kernel_size, 1)
    kw = k.reshape(1, 1, 1, kernel_size).expand(c, 1, 1, kernel_size)
    y = F.conv2d(y, kh, groups=c)
    y = F.conv2d(y, kw, groups=c)
    return y.permute(0, 2, 3, 1).reshape(b, t, h, w, c)


def pixel_unshuffle_spatial(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B,T,H,W,C) -> (B,T,H/f,W/f,C*f*f); channel order (s1, s2, c)."""
    b, t, h, w, c = x.shape
    f = factor
    x = x.reshape(b, t, h // f, f, w // f, f, c).permute(0, 1, 2, 4, 3, 5, 6)
    return x.reshape(b, t, h // f, w // f, f * f * c)


def pixel_shuffle_spatial(x: torch.Tensor, factor: int = 2) -> torch.Tensor:
    """(B,T,H,W,C*f*f) -> (B,T,H*f,W*f,C); channel order (c, s1, s2)."""
    b, t, h, w, cf = x.shape
    f = factor
    c = cf // (f * f)
    x = x.reshape(b, t, h, w, c, f, f).permute(0, 1, 2, 5, 3, 6, 4)
    return x.reshape(b, t, h * f, w * f, c)


def paired_random_crop(
    video: torch.Tensor,
    crop: int,
    lowres: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
    offsets: Optional[Sequence[torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """A random ``crop`` x ``crop`` spatial window per sample, the same
    window for the video and its low-res conditioning video (both (B, T, H,
    W, C) at one size). The offsets (oh, ow), each (B,) in [0, H - crop] /
    [0, W - crop], are drawn from ``generator`` (oh first) on the video's
    device unless given in ``offsets``."""
    b, _, h, w, _ = video.shape
    dev = video.device
    if offsets is None:
        oh = torch.randint(0, h - crop + 1, (b,), generator=generator, device=dev)
        ow = torch.randint(0, w - crop + 1, (b,), generator=generator, device=dev)
    else:
        oh, ow = (torch.as_tensor(o).to(dev, torch.long) for o in offsets)
    if not (oh.shape == ow.shape == (b,)):
        raise ValueError(f"crop offsets must be ({b},) each")
    ar = torch.arange(crop, device=dev)
    rows = (oh[:, None] + ar)[:, :, None]  # (b, crop, 1)
    cols = (ow[:, None] + ar)[:, None, :]  # (b, 1, crop)
    bi = torch.arange(b, device=dev)[:, None, None]

    def take(v):
        # (b, h, w, t, c) indexed by (b, crop, crop) -> (b, crop, crop, t, c)
        return v.permute(0, 2, 3, 1, 4)[bi, rows, cols].permute(0, 3, 1, 2, 4).contiguous()

    return take(video), (None if lowres is None else take(lowres))
