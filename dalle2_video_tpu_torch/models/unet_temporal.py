"""UnetTemporalConv, the frame-wise spatial unet + temporal conv mixer
(port of dalle2_video_tpu/models/unet_temporal.py; ``arch: temporal_conv``).

A UNet3D with per-frame attention (``joint_time_attention=False``; every
conv is already space-only), then a (3, 1, 1) conv over the frame axis
added as a residual. The temporal conv starts at zero, so the model starts
as exactly the per-frame unet. Same call signature as UNet3D; module names
``unet2d`` and ``temporal_conv`` as in the JAX tree.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig


class TemporalConv(nn.Module):
    """(k, 1, 1) conv over the frame axis, SAME padding, zero init; its
    ``conv`` is the flax ``nn.Conv`` (kernel (k, in, out) -> Conv1d
    (out, in, k))."""

    def __init__(self, features: int, kernel_size: int = 3):
        super().__init__()
        self.conv = nn.Conv1d(features, features, kernel_size, padding=(kernel_size - 1) // 2)
        nn.init.zeros_(self.conv.weight)
        nn.init.zeros_(self.conv.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        y = x.permute(0, 2, 3, 4, 1).reshape(b * h * w, c, t)
        y = self.conv(y.to(self.conv.weight.dtype))
        return y.reshape(b, h, w, c, t).permute(0, 4, 1, 2, 3)


class UnetTemporalConv(nn.Module):
    """Per-frame spatial unet + residual temporal conv mixer."""

    def __init__(self, cfg: UNet3DConfig, per_frame_embeds: bool = False):
        super().__init__()
        self.cfg = cfg
        self.unet2d = UNet3D(dataclasses.replace(cfg, joint_time_attention=False),
                             per_frame_embeds)
        self.temporal_conv = TemporalConv(cfg.resolved_channels_out)

    def forward(self, x, time, **kwargs):
        out = self.unet2d(x, time, **kwargs)
        return out + self.temporal_conv(out)
