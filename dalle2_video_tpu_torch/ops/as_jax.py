"""Plain element-wise ops rounded where the JAX package's programs round.

In a dtype narrower than f32 (bf16 sampling and training), XLA:CPU runs
each ``jnp`` op in f32 and rounds its result to the activation dtype; the
port's plain paths follow the same chain, so that they agree with the JAX
package to the rounding, not only to its tolerance. The chains were read
off the compiled JAX programs (``jax.jit(f).lower(x).compile().as_text()``
on bf16 inputs); where the jitted program and the op-by-op one differ
(GELU), these follow the jitted one, which is what the JAX sampler and
trainer run. In f32 there is no rounding to follow and each function is
the port's plain f32 expression, unchanged.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


# the bf16 constant of jax.nn.gelu(approximate=False): 1 / sqrt(2) rounded
_GELU_SQRT_HALF = 0.70703125


def _rounds(dtype: torch.dtype) -> bool:
    return dtype not in (torch.float32, torch.float64)


def softmax_as_jax(s: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` in the input dtype: exp(s - max) rounded to it,
    the sum accumulated in f32 and rounded (``jnp.sum`` upcasts bf16), the
    quotient rounded."""
    e = torch.exp(s - s.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def silu_as_jax(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.silu``: x * (1 / (1 + exp(-x))), each op rounded to x's
    dtype (the jitted program keeps every rounding)."""
    if not _rounds(x.dtype):
        return F.silu(x)
    return x * (1 / (1 + torch.exp(-x)))


def gelu_as_jax(x: torch.Tensor) -> torch.Tensor:
    """``flax.linen.gelu(approximate=False)`` as jitted: (x * 0.5) rounded,
    times erfc(-x * 0.70703125) -- the product kept in f32 into the f32
    erfc, whose result is rounded -- the product rounded."""
    if not _rounds(x.dtype):
        return F.gelu(x)
    e = torch.special.erfc(x.float() * -_GELU_SQRT_HALF).to(x.dtype)
    return (x * 0.5) * e


def groupnorm_as_flax(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                      groups: int, eps: float) -> torch.Tensor:
    """``flax.linen.GroupNorm`` over x (B, L, C): f32 statistics from x, the
    one-pass variance max(E[x^2] - E[x]^2, 0), (x - mean) * (rsqrt(var +
    eps) * gamma) + beta in f32, rounded once to the promoted dtype of x,
    gamma and beta."""
    b, l, c = x.shape
    out = torch.promote_types(torch.promote_types(x.dtype, gamma.dtype), beta.dtype)
    xf = x.float().reshape(b, l, groups, c // groups)
    mean = xf.mean((1, 3), keepdim=True)
    var = ((xf * xf).mean((1, 3), keepdim=True) - mean * mean).clamp_min(0.0)
    shape = (1, 1, groups, c // groups)
    mul = torch.rsqrt(var + eps) * gamma.float().reshape(shape)
    return ((xf - mean) * mul + beta.float().reshape(shape)).reshape(b, l, c).to(out)


def groupnorm_film_silu_as_jax(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                               scale: Optional[torch.Tensor], shift: Optional[torch.Tensor],
                               groups: int, eps: float) -> torch.Tensor:
    """The JAX Block3D's plain tail (``norm_impl`` xla) on x (B, L, C):
    flax GroupNorm, then FiLM y * (scale + 1) + shift and ``nn.silu`` as
    ops in the activation dtype; scale / shift (B, C) or None."""
    y = groupnorm_as_flax(x, gamma, beta, groups, eps)
    if scale is not None:
        y = y * (scale[:, None, :] + 1.0)
    if shift is not None:
        y = y + shift[:, None, :]
    return silu_as_jax(y)
