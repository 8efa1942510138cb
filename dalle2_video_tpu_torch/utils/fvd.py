"""Frechet Video Distance (FVD) harness (port of dalle2_video_tpu/utils/fvd.py).

FVD is the Frechet distance between Gaussian fits of video features from a
fixed encoder:

    d^2 = |mu1 - mu2|^2 + tr(S1 + S2 - 2 (S1 S2)^(1/2))

The statistics are host work in float64 and stay NumPy here, as in the JAX
module: ``feature_stats``, ``frechet_distance`` (the trace of the square
root through the symmetric ``eigh`` form, eigenvalues clipped at 0, no
regularisation), ``fvd_from_features`` and ``compute_fvd`` with a pluggable
``embed_fn(videos (N, T, H, W, C) in [0, 1]) -> (N, D)``.

The canonical encoder is an I3D pretrained on Kinetics-400, which this
repository does not hold. The in-repo extractor is ``vivit_embed_fn``
(the counterpart of scripts/eval_quality.py's): a fixed-seed ViViT
(``models/vivit.py``) at 16 frames x 64^2 on the caller's device. Its
seed-0 init is torch's, not the JAX script's ``PRNGKey(0)`` init, so the
port's FVDs compare with each other only, not with the JAX script's; the
provenance string it returns says so. A video of another geometry is
resized to the extractor's first: time by nearest (``resize_video_time``),
space by ``SPACE_METHOD`` (``resize_video``, antialiased when it shrinks).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import numpy as np
import torch

from dalle2_video_tpu_torch.models.vivit import ViViT, ViViTConfig
from dalle2_video_tpu_torch.ops.video import resize_video, resize_video_time
from dalle2_video_tpu_torch.utils.device import DeviceLike, resolve_device
from dalle2_video_tpu_torch.utils.keys import init_from

# the extractor of scripts/eval_quality.py::vivit_embed_fn
EXTRACTOR = ViViTConfig(dim=256, num_frames=16, frame_size=64, patch_size=16, depth=2,
                        heads=4, dim_head=32, scale_dim_conv=2)
SPACE_METHOD = "linear"


def feature_stats(features: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """(N, D) features -> (mean (D,), covariance (D, D))."""
    f = np.asarray(features, dtype=np.float64)
    assert f.ndim == 2 and f.shape[0] > 1, "need (N>1, D) features"
    mu = f.mean(axis=0)
    sigma = np.cov(f, rowvar=False)
    return mu, np.atleast_2d(sigma)


def _sqrtm_product_trace(s1: np.ndarray, s2: np.ndarray) -> float:
    """tr((S1 S2)^(1/2)) via the symmetric form A = S1^(1/2) S2 S1^(1/2):
    S1 S2 and A are similar matrices, so the trace of the square root is
    the sum of the square roots of A's eigenvalues (real, >= 0 up to
    noise, clipped at 0)."""
    w1, v1 = np.linalg.eigh((s1 + s1.T) / 2)
    w1 = np.clip(w1, 0.0, None)
    root1 = (v1 * np.sqrt(w1)) @ v1.T
    a = root1 @ ((s2 + s2.T) / 2) @ root1
    eig = np.linalg.eigvalsh((a + a.T) / 2)
    return float(np.sqrt(np.clip(eig, 0.0, None)).sum())


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray) -> float:
    """Frechet distance between two Gaussians (the FID / FVD formula)."""
    diff = np.asarray(mu1, np.float64) - np.asarray(mu2, np.float64)
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2)
                 - 2.0 * _sqrtm_product_trace(np.asarray(sigma1), np.asarray(sigma2)))


def fvd_from_features(real: np.ndarray, fake: np.ndarray) -> float:
    """FVD between two (N, D) feature sets."""
    mu_r, s_r = feature_stats(real)
    mu_f, s_f = feature_stats(fake)
    return frechet_distance(mu_r, s_r, mu_f, s_f)


def embed_all(videos, embed_fn: Callable, batch_size: int = 16) -> np.ndarray:
    """``embed_fn`` over ``videos`` in batches of ``batch_size``, as (N, D)."""
    return np.concatenate([np.asarray(embed_fn(videos[s:s + batch_size]))
                           for s in range(0, len(videos), batch_size)], axis=0)


def compute_fvd(real_videos, fake_videos, embed_fn: Callable, batch_size: int = 16) -> float:
    """End to end: embed both video sets in batches, then FVD. videos: (N,
    T, H, W, C) in [0, 1]; ``embed_fn`` -> (n, D) per batch."""
    return fvd_from_features(embed_all(real_videos, embed_fn, batch_size),
                             embed_all(fake_videos, embed_fn, batch_size))


def vivit_embed_fn(device: DeviceLike = None,
                   ckpt: Optional[str] = None) -> Tuple[Callable, str]:
    """(embed_fn, provenance): the ``EXTRACTOR`` ViViT on ``device`` (CUDA by
    default), its weights from a CPU generator seeded 0 through torch's
    initialisers, or (``ckpt``: a trained tower, scripts/eval_quality.py's
    ``--vivit``) the ViViT state in the checkpoint directory at ``ckpt``
    (``train/checkpoint.py``: a bare state dict, or a training state's
    params, loaded strictly). ``embed_fn`` takes (N, T, H, W, C) videos in
    [0, 1] (NumPy or torch, any geometry: resized to the extractor's as the
    module docstring says) and returns (N, 256) float32 NumPy features,
    computed in f32 under no_grad."""
    dev = resolve_device(device)
    with init_from(torch.Generator().manual_seed(0)):
        vivit = ViViT(EXTRACTOR)
    if ckpt:
        from dalle2_video_tpu_torch.train.checkpoint import load_params_subtree

        vivit.load_state_dict(load_params_subtree(ckpt, which="latest", prefer_ema=False),
                              strict=True)
        provenance = f"trained ({ckpt})"
    else:
        provenance = ("fixed-seed random init (seed 0, torch's initialisers on the port's "
                      "ViViT: comparable with this port's FVDs only, not with the JAX "
                      "script's PRNGKey(0) init)")
    vivit = vivit.to(dev).eval().requires_grad_(False)
    cfg = EXTRACTOR

    @torch.no_grad()
    def embed(videos) -> np.ndarray:
        v = torch.as_tensor(videos).to(dev, torch.float32)
        v = resize_video_time(v, cfg.num_frames)
        v = resize_video(v, cfg.frame_size, method=SPACE_METHOD)
        return vivit(v).cpu().numpy()

    return embed, provenance
