"""The VAE interface of a latent diffusion stage (port of
dalle2_video_tpu/models/vae.py): ``NullVAE`` (pixel space) and
``ConvVAE``, a frame-wise conv autoencoder.

Every VAE exposes ``encoded_dim``, ``downsample_factor``,
``get_encoded_fmap_size``, ``encode``, ``decode`` and ``is_latent``;
``VideoDecoder(config, vaes=...)`` runs a stage in the latent space of a VAE
that ``is_latent``. Videos are channels-last (b, t, h, w, c); the VAEs are
space-only (each frame on its own, no temporal mixing), as the JAX modules.
Their convs are the port's ``SpatialConv`` (the 4x4 stride-2 convs with the
torch-style floor pad) and the x2 upsample is the nearest resize of
``ops/video.py`` (``jax.image.resize``'s nearest). The parameters take the
JAX package's layout by name (``encoder.down0``, ``to_latent``,
``decoder.from_latent``, ``up{i}``, ``to_out``), so ``weights.load_from_jax``
carries a JAX ``init_params`` tree across.
"""

from __future__ import annotations

import contextlib
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle2_video_tpu_torch.models.layers import SpatialConv
from dalle2_video_tpu_torch.ops.video import resize_video
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import init_from


def _drawing_from(generator: Optional[torch.Generator]):
    """Initialise from ``generator`` when given, else from torch's default
    generator, as any module does."""
    return contextlib.nullcontext() if generator is None else init_from(generator)


class NullVAE(nn.Module):
    """Identity VAE: pixel-space diffusion (no parameters)."""

    def __init__(self, channels: int = 3):
        super().__init__()
        self.channels = channels

    @property
    def encoded_dim(self) -> int:
        return self.channels

    @property
    def downsample_factor(self) -> int:
        return 1

    def get_encoded_fmap_size(self, size: int) -> int:
        return size

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        return video

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return latents

    @property
    def is_latent(self) -> bool:
        return False


class _ConvEncoder(nn.Module):
    def __init__(self, channels: int, latent_dim: int, base_dim: int, num_down: int):
        super().__init__()
        self.num_down = num_down
        c = channels
        for i in range(num_down):
            self.add_module(f"down{i}", SpatialConv(c, base_dim * 2**i, 4, stride=2))
            c = base_dim * 2**i
        self.to_latent = SpatialConv(c, latent_dim, 3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.num_down):
            x = F.silu(getattr(self, f"down{i}")(x))
        return self.to_latent(x)


class _ConvDecoder(nn.Module):
    def __init__(self, channels: int, latent_dim: int, base_dim: int, num_down: int):
        super().__init__()
        self.num_down = num_down
        c = base_dim * 2 ** (num_down - 1)
        self.from_latent = SpatialConv(latent_dim, c, 3)
        for i in reversed(range(num_down)):
            self.add_module(f"up{i}", SpatialConv(c, base_dim * 2**i, 3))
            c = base_dim * 2**i
        self.to_out = SpatialConv(c, channels, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        x = self.from_latent(z)
        for i in reversed(range(self.num_down)):
            h, w = x.shape[2], x.shape[3]
            if h != w:
                raise ValueError(f"frames must be square, got {h} x {w}")
            x = F.silu(getattr(self, f"up{i}")(resize_video(x, 2 * h)))
        return self.to_out(x)


class ConvVAE(nn.Module):
    """Frame-wise conv autoencoder with the VQGanVAE interface; the
    downsample factor is 2 ** num_down. Built on ``device`` (CUDA by
    default), its weights drawn from ``generator`` (a CPU generator) when
    one is given."""

    def __init__(self, channels: int = 3, latent_dim: int = 4, base_dim: int = 64,
                 num_down: int = 2, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.latent_dim = channels, latent_dim
        self.base_dim, self.num_down = base_dim, num_down
        with _drawing_from(generator):
            self.encoder = _ConvEncoder(channels, latent_dim, base_dim, num_down)
            self.decoder = _ConvDecoder(channels, latent_dim, base_dim, num_down)
        self.to(resolve_device(device))

    @property
    def encoded_dim(self) -> int:
        return self.latent_dim

    @property
    def downsample_factor(self) -> int:
        return 2**self.num_down

    def get_encoded_fmap_size(self, size: int) -> int:
        return size // self.downsample_factor

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        return self.encoder(video)

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(latents)

    @property
    def is_latent(self) -> bool:
        return True
