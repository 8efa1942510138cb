"""VQ-VAE for latent video diffusion (port of
dalle2_video_tpu/models/vqvae.py): ``VectorQuantizer``,
``ema_codebook_update`` and ``VQVAE``, the frame-wise conv encoder and
decoder of ``models/vae.py`` around a vector-quantised bottleneck, with the
VAE interface ``VideoDecoder`` runs a latent stage through.

The nearest code is found with the JAX module's expanded distance
||z||^2 - 2 z c^T + ||c||^2 (one (n, K) product), not ``torch.cdist``, so
near ties fall the same way; ``argmin`` takes the first minimum on both
sides. The codebook learns by the embed + beta * commit loss terms by
default; with ``ema=True`` the embed term is dropped and the codebook is a
buffer (no gradient) that the VQGAN trainer moves with
``ema_codebook_update`` (van den Oord et al., appendix A.1). Gradients reach
the encoder through the straight-through estimator
``quant = z + (quant - z).detach()``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle2_video_tpu_torch.models.vae import _ConvDecoder, _ConvEncoder, _drawing_from
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device


class VectorQuantizer(nn.Module):
    """z (..., latent_dim) -> (quantized, indices, vq_loss). The codebook
    (K, d) starts as flax ``variance_scaling(1.0, "fan_in", "uniform")``
    on that shape, whose fan-in is K (its second-to-last axis)."""

    def __init__(self, codebook_size: int = 512, latent_dim: int = 4, beta: float = 0.25,
                 ema: bool = False):
        super().__init__()
        self.codebook_size, self.latent_dim = codebook_size, latent_dim
        self.beta, self.ema = beta, ema
        bound = math.sqrt(3.0 / codebook_size)
        init = torch.empty(codebook_size, latent_dim).uniform_(-bound, bound)
        if ema:
            self.register_buffer("codebook", init)
        else:
            self.codebook = nn.Parameter(init)

    def forward(self, z: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        codebook = self.codebook
        flat = z.reshape(-1, self.latent_dim)
        d = ((flat**2).sum(1, keepdim=True) - 2.0 * flat @ codebook.T
             + (codebook**2).sum(1)[None, :])
        idx = torch.argmin(d, dim=1)
        quant = codebook[idx].reshape(z.shape)
        commit = ((quant.detach() - z) ** 2).mean()
        if self.ema:
            vq_loss = self.beta * commit
        else:
            vq_loss = ((quant - z.detach()) ** 2).mean() + self.beta * commit
        quant = z + (quant - z).detach()
        return quant, idx.reshape(z.shape[:-1]), vq_loss


@torch.no_grad()
def ema_codebook_update(codebook: torch.Tensor, cluster_size: torch.Tensor,
                        embed_avg: torch.Tensor, z: torch.Tensor, idx: torch.Tensor, *,
                        decay: float = 0.99, eps: float = 1e-5
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One EMA codebook step: codebook (K, d), cluster_size (K,), embed_avg
    (K, d), z (..., d) the encoder's outputs before quantisation, idx (...)
    their codes -> (new codebook, new cluster_size, new embed_avg), with the
    counts' Laplace smoothing."""
    k, dim = codebook.shape
    flat = z.reshape(-1, dim).float()
    onehot = F.one_hot(idx.reshape(-1), k).float()
    counts = onehot.sum(0)
    sums = onehot.T @ flat
    cluster_size = decay * cluster_size + (1.0 - decay) * counts
    embed_avg = decay * embed_avg + (1.0 - decay) * sums
    n = cluster_size.sum()
    smoothed = (cluster_size + eps) / (n + k * eps) * n
    return (embed_avg / smoothed[:, None]).to(codebook.dtype), cluster_size, embed_avg


class VQVAE(nn.Module):
    """The VAE interface with a quantised bottleneck: ``encode`` gives the
    quantised latents (b, t, s, s, latent_dim) diffusion sees. Built on
    ``device`` (CUDA by default), its weights drawn from ``generator`` (a
    CPU generator) when one is given."""

    def __init__(self, channels: int = 3, latent_dim: int = 4, base_dim: int = 64,
                 num_down: int = 2, codebook_size: int = 512, codebook_ema: bool = False,
                 ema_decay: float = 0.99, *, device: DeviceLike = None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.channels, self.latent_dim = channels, latent_dim
        self.base_dim, self.num_down = base_dim, num_down
        self.codebook_size, self.codebook_ema = codebook_size, codebook_ema
        self.ema_decay = ema_decay
        with _drawing_from(generator):
            self.encoder = _ConvEncoder(channels, latent_dim, base_dim, num_down)
            self.vq = VectorQuantizer(codebook_size, latent_dim, ema=codebook_ema)
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

    @property
    def is_latent(self) -> bool:
        return True

    def encode(self, video: torch.Tensor) -> torch.Tensor:
        quant, _, _ = self.vq(self.encoder(video))
        return quant

    def decode(self, latents: torch.Tensor) -> torch.Tensor:
        return self.decoder(latents)

    def codebook_indices(self, video: torch.Tensor) -> torch.Tensor:
        _, idx, _ = self.vq(self.encoder(video))
        return idx

    def loss(self, video: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Reconstruction (l2) + VQ loss, and its parts."""
        quant, _, vq_loss = self.vq(self.encoder(video))
        recon_loss = ((self.decoder(quant) - video) ** 2).mean()
        return recon_loss + vq_loss, {"recon": recon_loss, "vq": vq_loss}
