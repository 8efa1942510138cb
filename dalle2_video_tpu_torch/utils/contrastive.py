"""Contrastive CLIP loss and retrieval metrics (port of
dalle2_video_tpu/utils/contrastive.py).

``clip_loss`` is the symmetric InfoNCE over l2-normalised, flattened
embeddings with logits scaled by exp(temperature) (a learned log-scale,
init 5.0); ``retrieval_metrics`` the top-k accuracy over the cosine
similarity matrix, a pair's rank counting every tie against it (``>=``).
``sharded_clip_loss`` needs a device mesh: it raises until data-parallel
training is ported.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-8) -> torch.Tensor:
    # eps 1e-8 as the reference CLIPLoss normalize (the layers' l2norm for
    # cosine-sim attention keeps 1e-12, like torch F.normalize)
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def clip_loss(x: torch.Tensor, y: torch.Tensor, temperature: torch.Tensor,
              return_logits: bool = False):
    """Symmetric InfoNCE of paired (b, ...) embeddings x, y: the mean of the
    x->y and y->x cross-entropies against the diagonal."""
    b = x.shape[0]
    x = l2_normalize(x.reshape(b, -1))
    y = l2_normalize(y.reshape(b, -1))
    logits = (x @ y.T) * torch.exp(temperature)
    targets = torch.arange(b, device=logits.device)
    loss = 0.5 * (F.cross_entropy(logits, targets) + F.cross_entropy(logits.T, targets))
    return (logits, loss) if return_logits else loss


def sharded_clip_loss(*args, **kwargs):
    raise NotImplementedError(
        "sharded_clip_loss needs a device mesh: data-parallel training is not ported "
        "yet (one device only; use clip_loss)")


def retrieval_metrics(z: torch.Tensor, y: torch.Tensor,
                      topk: Tuple[int, ...] = (1, 10)) -> Dict[str, torch.Tensor]:
    """{"top<k>": share of rows whose pair ranks within k} (0-dim f32 tensors);
    a k at or past the batch gives 1.0."""
    b = z.shape[0]
    z = l2_normalize(z.reshape(b, -1))
    y = l2_normalize(y.reshape(b, -1))
    sim = z @ y.T
    ranks = (sim >= sim.diagonal()[:, None]).sum(dim=1)
    return {f"top{k}": (ranks <= k).float().mean() for k in topk}
