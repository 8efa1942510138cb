"""The one contrastive helper the sampling path needs (port of
dalle2_video_tpu/utils/contrastive.py::l2_normalize)."""

from __future__ import annotations

import torch


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    # eps 1e-8 as the reference CLIPLoss normalize (the layers' l2norm for
    # cosine-sim attention keeps 1e-12, like torch F.normalize)
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)
