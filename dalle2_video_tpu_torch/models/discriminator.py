"""PatchGAN discriminator of VQGAN-VAE training (port of
dalle2_video_tpu/models/discriminator.py) and the hinge losses.

The taming-transformers NLayerDiscriminator's shape: a pyramid of 4x4 convs
with padding (1, 1) (stride 2 but for the last layer), LeakyReLU 0.2,
channels capped at 8x the base width, a 1-channel logit map; frames are
folded into the batch. The norm is flax ``nn.GroupNorm`` (epsilon 1e-6,
not torch's 1e-5), computed by ``F.group_norm``: the JAX module runs it
outside any Pallas kernel. Parameter names follow flax's (``Conv_<i>``,
``GroupNorm_<i>``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle2_video_tpu_torch.models.layers import kernel_init_
from dalle2_video_tpu_torch.models.vae import _drawing_from
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device


def _conv(c_in: int, c_out: int, stride: int, bias: bool = True) -> nn.Conv2d:
    conv = nn.Conv2d(c_in, c_out, 4, stride, padding=1, bias=bias)
    kernel_init_(conv.weight, c_in * 16)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


class PatchDiscriminator(nn.Module):
    """(B, T, H, W, C) video -> (B*T, H', W', 1) patch realness logits."""

    def __init__(self, base_dim: int = 64, num_layers: int = 3, groups: int = 8,
                 channels: int = 3, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_layers = num_layers
        with _drawing_from(generator):
            self.Conv_0 = _conv(channels, base_dim, 2)
            c = base_dim
            for i in range(1, num_layers + 1):
                co = base_dim * min(2**i, 8)
                setattr(self, f"Conv_{i}", _conv(c, co, 2 if i < num_layers else 1, bias=False))
                setattr(self, f"GroupNorm_{i - 1}", nn.GroupNorm(min(groups, co), co, eps=1e-6))
                c = co
            setattr(self, f"Conv_{num_layers + 1}", _conv(c, 1, 1))
        self.to(resolve_device(device))

    def forward(self, video: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = video.shape
        x = video.reshape(b * t, h, w, c).permute(0, 3, 1, 2)
        x = F.leaky_relu(self.Conv_0(x), 0.2)
        for i in range(1, self.num_layers + 1):
            x = getattr(self, f"GroupNorm_{i - 1}")(getattr(self, f"Conv_{i}")(x))
            x = F.leaky_relu(x, 0.2)
        return getattr(self, f"Conv_{self.num_layers + 1}")(x).permute(0, 2, 3, 1)


def hinge_d_loss(logits_real: torch.Tensor, logits_fake: torch.Tensor) -> torch.Tensor:
    """Discriminator hinge loss (taming-transformers' default)."""
    return 0.5 * (F.relu(1.0 - logits_real).mean() + F.relu(1.0 + logits_fake).mean())


def hinge_g_loss(logits_fake: torch.Tensor) -> torch.Tensor:
    """The generator's adversarial term: push the fake logits up."""
    return -logits_fake.mean()
