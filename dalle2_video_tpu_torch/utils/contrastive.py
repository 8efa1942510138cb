"""Contrastive CLIP loss and retrieval metrics (port of
dalle2_video_tpu/utils/contrastive.py).

``clip_loss`` is the symmetric InfoNCE over l2-normalised, flattened
embeddings with logits scaled by exp(temperature) (a learned log-scale,
init 5.0); ``retrieval_metrics`` the top-k accuracy over the cosine
similarity matrix, a pair's rank counting every tie against it (``>=``).
``sharded_clip_loss`` is the global-batch loss over a mesh's data axis
(each rank's rows; every rank holds the global loss).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from dalle2_video_tpu_torch.parallel.collectives import gather_sharded, psum
from dalle2_video_tpu_torch.parallel.mesh import DATA_AXIS


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


def sharded_clip_loss(x: torch.Tensor, y: torch.Tensor, temperature: torch.Tensor, mesh,
                      axis: str = DATA_AXIS) -> torch.Tensor:
    """Global-batch symmetric CLIP loss; x, y are this rank's rows of the
    batch split over ``axis``. Each rank gathers both towers, computes its
    (local_b, global_b) logit rows against offset-diagonal targets, and the
    summed losses are added over the axis and divided by the global batch:
    ``clip_loss`` of the gathered batch, on every rank. Backward: the sum's
    cotangent is taken once per rank (``psum``), the gathers' cotangents
    summed over the ranks (``gather_sharded``), so each rank's gradient in
    its rows is the single-device gradient, and in a replicated input (the
    temperature) its part of it (the data-parallel step sums the parts)."""
    if mesh is None:
        raise ValueError("sharded_clip_loss needs a mesh (parallel.mesh.create_mesh); "
                         "use clip_loss on one device")
    group = mesh.group(axis)
    lb = x.shape[0]
    xs = l2_normalize(x.reshape(lb, -1))
    ys = l2_normalize(y.reshape(lb, -1))
    x_all = gather_sharded(xs, group, dim=0)
    y_all = gather_sharded(ys, group, dim=0)
    scale = torch.exp(temperature)
    targets = mesh.index(axis) * lb + torch.arange(lb, device=xs.device)
    loss = 0.5 * (F.cross_entropy((xs @ y_all.T) * scale, targets, reduction="sum")
                  + F.cross_entropy((ys @ x_all.T) * scale, targets, reduction="sum"))
    return psum(loss, group) / (lb * mesh.shape[axis])


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
