"""Gaussian diffusion schedule: the DDPM math of sampling and training
(port of dalle2_video_tpu/diffusion/schedule.py).

Buffers are computed in numpy float64 and stored as float32 tensors on the
schedule's device, as the JAX package does. Training adds the random
timesteps, the elementwise losses with p2 reweighting, and the
Improved-DDPM VLB helpers (``normal_kl``, the discretized Gaussian
log-likelihood).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = [
    "make_beta_schedule",
    "DiffusionSchedule",
    "extract",
    "normal_kl",
    "approx_standard_normal_cdf",
    "discretized_gaussian_log_likelihood",
    "NAT",
]

# nats <-> bits conversion used by the Improved-DDPM VLB term.
NAT = 1.0 / np.log(2.0)


def make_beta_schedule(name: str, timesteps: int) -> np.ndarray:
    """cosine (Nichol & Dhariwal, s=0.008), linear, quadratic, jsd, sqrt."""
    if name == "cosine":
        s = 0.008
        steps = timesteps + 1
        x = np.linspace(0, timesteps, steps, dtype=np.float64)
        alphas_cumprod = np.cos(((x / timesteps) + s) / (1 + s) * np.pi * 0.5) ** 2
        alphas_cumprod = alphas_cumprod / alphas_cumprod[0]
        betas = 1.0 - (alphas_cumprod[1:] / alphas_cumprod[:-1])
        return np.clip(betas, 0.0, 0.999)

    scale = 1000.0 / timesteps
    beta_start = scale * 0.0001
    beta_end = scale * 0.02
    if name == "linear":
        betas = np.linspace(beta_start, beta_end, timesteps, dtype=np.float64)
    elif name == "quadratic":
        betas = np.linspace(beta_start**0.5, beta_end**0.5, timesteps,
                            dtype=np.float64) ** 2
    elif name == "jsd":
        betas = 1.0 / np.linspace(timesteps, 1, timesteps, dtype=np.float64)
    elif name == "sqrt":
        betas = np.sqrt(np.linspace(beta_start, beta_end, timesteps, dtype=np.float64))
    else:
        raise ValueError(f"unknown beta schedule {name!r}")
    return np.clip(betas, 0.0, 0.999)


def extract(buf: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """buf[t] reshaped to (b, 1, ..., 1) with ``ndim`` dims."""
    out = buf[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


@dataclasses.dataclass(frozen=True)
class DiffusionSchedule:
    betas: torch.Tensor
    alphas_cumprod: torch.Tensor
    alphas_cumprod_prev: torch.Tensor
    sqrt_alphas_cumprod: torch.Tensor
    sqrt_one_minus_alphas_cumprod: torch.Tensor
    sqrt_recip_alphas_cumprod: torch.Tensor
    sqrt_recipm1_alphas_cumprod: torch.Tensor
    posterior_variance: torch.Tensor
    posterior_log_variance_clipped: torch.Tensor
    posterior_mean_coef1: torch.Tensor
    posterior_mean_coef2: torch.Tensor
    p2_loss_weight: torch.Tensor
    num_timesteps: int
    loss_type: str = "l2"

    @staticmethod
    def create(beta_schedule: str = "cosine", timesteps: int = 1000,
               device: torch.device = torch.device("cpu"), loss_type: str = "l2",
               p2_loss_weight_gamma: float = 0.0,
               p2_loss_weight_k: float = 1.0) -> "DiffusionSchedule":
        betas = make_beta_schedule(beta_schedule, timesteps)
        alphas = 1.0 - betas
        acp = np.cumprod(alphas)
        acp_prev = np.concatenate([[1.0], acp[:-1]])
        post_var = betas * (1.0 - acp_prev) / (1.0 - acp)
        f32 = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float32,
                                        device=device)
        return DiffusionSchedule(
            betas=f32(betas),
            alphas_cumprod=f32(acp),
            alphas_cumprod_prev=f32(acp_prev),
            sqrt_alphas_cumprod=f32(np.sqrt(acp)),
            sqrt_one_minus_alphas_cumprod=f32(np.sqrt(1.0 - acp)),
            # floor keeps the reciprocals finite if alpha_cumprod hits 0
            sqrt_recip_alphas_cumprod=f32(np.sqrt(1.0 / np.maximum(acp, 1e-20))),
            sqrt_recipm1_alphas_cumprod=f32(
                np.sqrt(1.0 / np.maximum(acp, 1e-20) - 1.0)
            ),
            posterior_variance=f32(post_var),
            posterior_log_variance_clipped=f32(
                np.log(np.clip(post_var, 1e-20, None))
            ),
            posterior_mean_coef1=f32(betas * np.sqrt(acp_prev) / (1.0 - acp)),
            posterior_mean_coef2=f32((1.0 - acp_prev) * np.sqrt(alphas) / (1.0 - acp)),
            p2_loss_weight=f32(
                (p2_loss_weight_k + acp / (1.0 - acp)) ** -p2_loss_weight_gamma),
            num_timesteps=int(timesteps),
            loss_type=str(loss_type),
        )

    # forward process ---------------------------------------------------- #
    def sample_random_times(self, batch: int, generator: torch.Generator = None
                            ) -> torch.Tensor:
        """(batch,) int64 timesteps uniform in [0, T), on the schedule's
        device."""
        return torch.randint(0, self.num_timesteps, (batch,), generator=generator,
                             device=self.betas.device)

    def q_sample(self, x_start, t, noise):
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_start
                + extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * noise)

    def q_posterior(self, x_start, x_t, t):
        """q(x_{t-1} | x_t, x_0): (mean, variance, log_variance)."""
        nd = x_t.ndim
        mean = (extract(self.posterior_mean_coef1, t, nd) * x_start
                + extract(self.posterior_mean_coef2, t, nd) * x_t)
        var = extract(self.posterior_variance, t, nd)
        log_var = extract(self.posterior_log_variance_clipped, t, nd)
        return mean, var, log_var

    # parameterization conversions --------------------------------------- #
    def predict_start_from_noise(self, x_t, t, noise):
        nd = x_t.ndim
        return (extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_recipm1_alphas_cumprod, t, nd) * noise)

    def predict_noise_from_start(self, x_t, t, x0):
        nd = x_t.ndim
        return ((extract(self.sqrt_recip_alphas_cumprod, t, nd) * x_t - x0)
                / extract(self.sqrt_recipm1_alphas_cumprod, t, nd))

    def calculate_v(self, x_start, t, noise):
        nd = x_start.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * noise
                - extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * x_start)

    def predict_start_from_v(self, x_t, t, v):
        nd = x_t.ndim
        return (extract(self.sqrt_alphas_cumprod, t, nd) * x_t
                - extract(self.sqrt_one_minus_alphas_cumprod, t, nd) * v)

    # losses -------------------------------------------------------------- #
    def loss_fn(self, pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
        """Elementwise l1 / l2 / huber(delta=1) loss, no reduction."""
        if self.loss_type == "l1":
            return (pred - target).abs()
        if self.loss_type == "l2":
            return (pred - target) ** 2
        if self.loss_type == "huber":
            d = pred - target
            ad = d.abs()
            return torch.where(ad < 1.0, 0.5 * d * d, ad - 0.5)
        raise ValueError(f"unknown loss type {self.loss_type!r}")

    def p2_reweigh_loss(self, loss: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return loss * extract(self.p2_loss_weight, t, loss.ndim)


# Improved-DDPM VLB helpers ------------------------------------------------ #
def normal_kl(mean1, logvar1, mean2, logvar2):
    """KL(N(mean1, var1) || N(mean2, var2)) per element, in nats."""
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + (mean1 - mean2) ** 2 * torch.exp(-logvar2))


def approx_standard_normal_cdf(x):
    return 0.5 * (1.0 + torch.tanh(np.sqrt(2.0 / np.pi) * (x + 0.044715 * x**3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales, thres: float = 0.999):
    """Log-likelihood of an image discretized to 256 bins under a Gaussian
    (Ho et al.'s diffusion_utils_2)."""
    centered_x = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered_x + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered_x - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_cdf_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -thres, log_cdf_plus,
                       torch.where(x > thres, log_one_minus_cdf_min, log_cdf_delta))
