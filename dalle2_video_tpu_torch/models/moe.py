"""Mixture-of-experts feed-forward (port of dalle2_video_tpu/models/moe.py).

``MoEFF`` replaces the prior's dense feed-forward: pre-norm, residual, a
top-2 mixture of ``num_experts`` experts. Routing is the JAX package's,
dense and static: the router's softmax in f32, the top-2 gates normalised
over the kept pair, each (token, choice) given a slot in its expert's queue
by a cumsum over the choice-major one-hot (so every top-1 choice takes a
slot before any top-2 choice), a static capacity ceil(g * cf / e) per
expert for g tokens, and tokens past it dropped for that expert -- they
ride the residual. Dispatch and combine are one-hot einsums over stacked
expert weights (e, d, h), the JAX parameters' own layout.

The Switch load-balance loss E * sum_e(f_e * p_e) (f_e the share of tokens
whose first choice is e, p_e the mean router probability) is returned
beside the output, where the JAX module sows it; the prior adds
``moe_aux_weight`` times its mean over the layers to the loss.

Ties in the router: ``jax.lax.top_k`` takes the lower index first; a
stable descending sort does the same here (``torch.topk`` promises no
order among equal values). The experts' weights are initialised as flax's
``lecun_normal`` on the 3-D shape, whose fan-in counts the expert axis:
a truncated normal of std 1 / sqrt(d * e) (and 1 / sqrt(h * e) for the
second), not 1 / sqrt(d).

Expert parallelism (the JAX ``moe_sharding_tree``: the expert axis over
the mesh, all-to-all dispatch) is not ported: the whole layer runs on one
device. It waits, with the prior's GPipe pipeline, for ``ROADMAP.md``
queue 1 item 3 (point-to-point and all-to-all transfers over NCCL).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn as nn

from dalle2_video_tpu_torch.models.layers import Dense, ScaleOnlyLayerNorm
from dalle2_video_tpu_torch.ops.as_jax import gelu_as_jax, silu_as_jax

# flax's truncated_normal variance scaling divides the std by this: the std
# of a unit normal truncated to [-2, 2]
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor) -> None:
    """flax ``lecun_normal()`` for a weight of shape (..., fan_in_axis,
    out): fan_in = shape[-2] times every leading axis (the receptive field
    of variance_scaling), a normal truncated at two of its stds."""
    fan_in = math.prod(weight.shape[:-1])
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(weight, std=std, a=-2.0 * std, b=2.0 * std)


def capacity(tokens: int, num_experts: int, capacity_factor: float) -> int:
    """Slots per expert: ceil(tokens * capacity_factor / num_experts), at
    least 1 (the JAX expression, in Python floats)."""
    return max(int(-(-tokens * capacity_factor // num_experts)), 1)


class MoEFF(nn.Module):
    """(b, n, dim) -> ((b, n, dim), the load-balance aux, a 0-dim f32)."""

    def __init__(self, dim: int, num_experts: int, mult: int = 4,
                 capacity_factor: float = 2.0, swiglu: bool = True):
        super().__init__()
        self.dim, self.num_experts = dim, num_experts
        self.capacity_factor, self.swiglu = capacity_factor, swiglu
        inner = dim * mult
        self.norm = ScaleOnlyLayerNorm(dim)
        self.router = Dense(dim, num_experts, bias=False)
        self.experts_w1 = nn.Parameter(torch.empty(num_experts, dim, inner * (2 if swiglu else 1)))
        self.experts_w2 = nn.Parameter(torch.empty(num_experts, inner, dim))
        lecun_normal_(self.experts_w1)
        lecun_normal_(self.experts_w2)

    def route(self, y: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
        """(g, d) normed tokens -> dispatch (g, e, cap), combine (g, e, cap),
        the router probabilities (g, e) and the chosen experts (g, k)."""
        g, e = y.shape[0], self.num_experts
        k = min(2, e)
        cap = capacity(g, e, self.capacity_factor)
        probs = torch.softmax(self.router(y).float(), dim=-1)
        gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        gate_vals, gate_idx = gate_vals[:, :k], gate_idx[:, :k]
        gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True)
        sel = (gate_idx[..., None] == torch.arange(e, device=y.device)).float()  # (g, k, e)
        flat = sel.transpose(0, 1).reshape(k * g, e)  # choice-major
        pos = (torch.cumsum(flat, dim=0) * flat - 1.0).reshape(k, g, e).transpose(0, 1)
        keep_sel = sel * ((pos >= 0) & (pos < cap)).float()
        slot = (pos * sel).sum(-1)  # (g, k); a dropped choice's slot lies past cap
        slot_oh = (slot[..., None] == torch.arange(cap, device=y.device)).float()
        dispatch = torch.einsum("gke,gkc->gec", keep_sel, slot_oh)
        combine = torch.einsum("gke,gkc->gec", keep_sel * gate_vals[..., None], slot_oh)
        return dispatch, combine, probs, gate_idx

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        b, n, d = x.shape
        e = self.num_experts
        y = self.norm(x).reshape(b * n, d)
        dispatch, combine, probs, gate_idx = self.route(y)
        xe = torch.einsum("gd,gec->ecd", y, dispatch.to(y.dtype))
        h = torch.einsum("ecd,edh->ech", xe, self.experts_w1.to(xe.dtype))
        if self.swiglu:
            a, gate = h.chunk(2, dim=-1)
            h = a * silu_as_jax(gate)
        else:
            h = gelu_as_jax(h)
        ye = torch.einsum("ech,ehd->ecd", h, self.experts_w2.to(h.dtype))
        out = torch.einsum("ecd,gec->gd", ye, combine.to(ye.dtype))
        f_e = (gate_idx[:, 0:1] == torch.arange(e, device=x.device)).float().mean(0)
        aux = e * torch.sum(f_e * probs.mean(0))
        return x + out.reshape(b, n, d), aux
