"""Video tensor ops in the JAX layout (B, T, H, W, C) (port of
dalle2_video_tpu/ops/video.py).

The resizes take every ``jax.image.resize`` method. Nearest uses
``F.interpolate(mode="nearest-exact")``: it takes source index floor((i +
0.5) * in / out), as ``jax.image.resize`` does. ``mode="nearest"`` takes
floor(i * in / out) and disagrees with the reference on 128->64, 90->16,
7->3 and 3->7. The others (``linear`` / ``bilinear`` / ``trilinear`` /
``triangle``, ``cubic`` / ``bicubic`` / ``tricubic``, ``lanczos3``,
``lanczos5``) are computed as JAX's ``scale_and_translate`` computes them,
antialiased as its default: per resized axis an (in, out) weight matrix of
the kernel at the sample positions (the kernel widened by in / out when
the axis shrinks), normalised by its column sums, zeroed where the sum is
tiny or the sample falls outside [-0.5, in - 0.5], and one contraction of
the axis with it. ``F.interpolate`` would compute other functions: its
bicubic takes a = -0.75 (JAX's Keys cubic -0.5), its antialiased paths
treat the edges otherwise.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence, Tuple

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


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    """R. G. Keys' cubic convolution kernel, a = -0.5."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _lanczos(radius: float) -> Callable[[torch.Tensor], torch.Tensor]:
    def kernel(x: torch.Tensor) -> torch.Tensor:
        y = radius * torch.sin(math.pi * x) * torch.sin(math.pi * x / radius)
        out = torch.where(x > 1e-3, y / torch.where(x != 0, math.pi**2 * x * x,
                                                    torch.ones_like(x)), torch.ones_like(x))
        return torch.where(x > radius, torch.zeros_like(x), out)

    return kernel


_KERNELS: Dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "linear": _triangle, "cubic": _keys_cubic, "lanczos3": _lanczos(3.0),
    "lanczos5": _lanczos(5.0)}
_ALIASES = {"bilinear": "linear", "trilinear": "linear", "triangle": "linear",
            "bicubic": "cubic", "tricubic": "cubic"}
METHODS = ("nearest", *_KERNELS, *_ALIASES)


def _kernel_of(method: str) -> Optional[Callable[[torch.Tensor], torch.Tensor]]:
    """None for nearest, else the method's kernel; an unknown method raises
    as ``jax.image.resize`` does."""
    if method == "nearest":
        return None
    name = _ALIASES.get(method, method)
    if name not in _KERNELS:
        raise ValueError(f'Unknown resize method "{method}"')
    return _KERNELS[name]


def resize_weights(in_size: int, out_size: int, kernel: Callable[[torch.Tensor], torch.Tensor],
                   device=None) -> torch.Tensor:
    """The (in_size, out_size) f32 weight matrix of JAX's
    ``compute_weight_mat`` at scale out / in, no translation, antialiased."""
    inv_scale = 1.0 / (out_size / in_size)
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(out_size, dtype=torch.float32, device=device) + 0.5) * inv_scale - 0.5
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = kernel((sample[None, :] - src[:, None]).abs() / kernel_scale)
    total = w.sum(dim=0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(torch.finfo(torch.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def _resize_axes(x: torch.Tensor, sizes: Dict[int, int], kernel) -> torch.Tensor:
    """Each axis a of ``sizes`` resized to sizes[a]: one contraction of the
    axis with its weight matrix (integer inputs are taken as f32)."""
    if not x.is_floating_point():
        x = x.to(torch.float32)
    for axis, size in sizes.items():
        w = resize_weights(x.shape[axis], size, kernel, x.device).to(x.dtype)
        x = torch.movedim(torch.movedim(x, axis, -1) @ w, -1, axis)
    return x


def resize_video(
    x: torch.Tensor,
    size: int,
    method: str = "nearest",
    clamp_range: Optional[Tuple[float, float]] = None,
) -> torch.Tensor:
    """Resize every frame to (size, size); time preserved."""
    kernel = _kernel_of(method)
    b, t, h, w, c = x.shape
    if h == size and w == size and clamp_range is None:
        return x
    if (h, w) != (size, size):
        if kernel is None:
            y = F.interpolate(_frames_nchw(x), size=(size, size), mode="nearest-exact")
            x = y.permute(0, 2, 3, 1).reshape(b, t, size, size, c)
        else:
            x = _resize_axes(x, {a: size for a, n in ((2, h), (3, w)) if n != size}, kernel)
    if clamp_range is not None:
        x = x.clamp(clamp_range[0], clamp_range[1])
    return x


def resize_video_time(
    x: torch.Tensor, num_frames: int, method: str = "nearest"
) -> torch.Tensor:
    """Resample the frame axis to ``num_frames`` (temporal SR conditioning)."""
    kernel = _kernel_of(method)
    b, t, h, w, c = x.shape
    if t == num_frames:
        return x
    if kernel is not None:
        return _resize_axes(x, {1: num_frames}, kernel)
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
