"""Sequence-parallel joint attention (port of
dalle2_video_tpu/parallel/sp_attention.py).

The attention is multi-query (one shared kv head of dim ~32), so exact
sequence parallelism is almost free: each rank of the mesh's ``model``
axis takes its block of the token axis of q, runs the flash-MQA kernels
(row 1 forward, row 2 backward) on its query rows against the full k / v
with the replicated learned null kv prepended, and the outputs are
gathered back along the token axis.

The activations around the attention are replicated over the model axis
(every model rank runs the same unet on the same batch rows), so k and v
are already whole on every rank: where JAX's shard_map all-gathers its k
/ v blocks, the port uses them as they are, and the forward's one
collective is the output's gather (b * n * h * d elements a layer). That
also sets the backward (``parallel/collectives.py``): the output's
cotangent is the same on every rank (each takes its block, no sum), q's
block cotangents are gathered whole, and k's, v's and the null kv's
partial cotangents (each rank's query rows) are summed over the axis once
each. The gradient is the single-device gradient, on every rank.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from dalle2_video_tpu_torch.ops.flash_mqa import mqa_attention
from dalle2_video_tpu_torch.parallel.collectives import (
    gather_replicated,
    shard_replicated,
    sum_cotangent,
)
from dalle2_video_tpu_torch.parallel.mesh import MODEL_AXIS, Mesh, global_batch


def sequence_parallel_mqa(
    q: torch.Tensor,  # (b, n, h, d), replicated over `axis`
    k: torch.Tensor,  # (b, n, d) single kv head (real tokens, NO null kv)
    v: torch.Tensor,  # (b, n, d)
    mesh: Mesh,
    *,
    sm_scale: float,
    axis: str = MODEL_AXIS,
    null_kv: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,  # each (b, 1, d)
) -> torch.Tensor:
    """Exact MQA attention with the token axis split over ``axis``: the same
    (b, n, h, d) as single-device attention, on every rank of the axis.
    Differentiable end to end (the flash kernels bring their backward; the
    route follows the global batch, ``parallel.mesh.global_batch``)."""
    group = mesh.group(axis)
    q_loc = shard_replicated(q, group, dim=1)
    k_all = sum_cotangent(k, group)
    v_all = sum_cotangent(v, group)
    if null_kv is not None:
        nk, nv = (sum_cotangent(t, group) for t in null_kv)
        k_all = torch.cat([nk, k_all], dim=1)
        v_all = torch.cat([nv, v_all], dim=1)
    out = mqa_attention(q_loc, k_all, v_all, sm_scale=sm_scale,
                        route_batch=global_batch(q.shape[0]))
    return gather_replicated(out, group, dim=1)
