"""Fused GroupNorm -> FiLM -> SiLU forward (port of
dalle2_video_tpu/ops/pallas/groupnorm_film.py, forward only).

y = silu(xhat * A + B), A = gamma * (scale + 1), B = beta * (scale + 1) +
shift, over x (B, L, C) with G groups. For a CUDA tensor the wrapper
launches the two-pass kernel in ``csrc/groupnorm_film.cu`` (one call = one
counted launch: stats pass + apply pass); for a CPU tensor it uses
``groupnorm_film_reference``, the two-pass math of the JAX package's
``_reference_math``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    require_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    name="groupnorm_film_silu_fwd",
    source="groupnorm_film.cu",
    symbol="d2v_groupnorm_film_silu_fwd",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/groupnorm_film.py:132",
)
_THREADS = 256
_MAX_APPLY_BLOCKS = 8 * 132  # ~8 blocks per H100 SM in all, split over B


def _shape_ok(c: int, groups: int, vec: int) -> bool:
    """The kernel's rule: C holds whole 16-byte vectors and divides one
    block-stride of them (so each thread's channels stay fixed)."""
    if groups <= 0 or groups > 32 or _THREADS % groups or c % groups or c > 1024:
        return False
    return c % vec == 0 and (_THREADS * vec) % c == 0


def groupnorm_film_reference(x, gamma, beta, scale, shift, groups: int,
                             eps: float, return_stats: bool = False):
    """Plain version (two-pass statistics in f32); output in x.dtype."""
    b, l, c = x.shape
    xf = x.float().reshape(b, l, groups, c // groups)
    mean = xf.mean(dim=(1, 3), keepdim=True)
    var = xf.var(dim=(1, 3), keepdim=True, unbiased=False)
    rstd = torch.rsqrt(var + eps)
    xhat = ((xf - mean) * rstd).reshape(b, l, c)
    z = xhat * gamma.float()[None, None, :] + beta.float()[None, None, :]
    if scale is not None:
        z = z * (scale.float()[:, None, :] + 1.0)
    if shift is not None:
        z = z + shift.float()[:, None, :]
    y = (z * torch.sigmoid(z)).to(x.dtype)
    if not return_stats:
        return y
    per_c = lambda s: s.reshape(b, groups, 1).expand(b, groups, c // groups).reshape(b, c)
    return y, per_c(mean), per_c(rstd)


def groupnorm_film_silu(
    x: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    groups: int = 8,
    eps: float = 1e-5,
    block_l: Optional[int] = None,
    interpret: bool = False,
    return_stats: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """x (B, L, C); gamma, beta (C,); scale, shift (B, C) or None (= 0).
    Returns y (B, L, C) in x.dtype [, mean, rstd (B, C) f32, the
    per-channel broadcast of each group's statistics]."""
    del block_l, interpret  # TPU tuning only
    if x.ndim != 3:
        raise ValueError(f"groupnorm_film_silu: x must be (B, L, C), got {x.shape}")
    b, l, c = x.shape
    if c % groups:
        raise ValueError(f"groupnorm_film_silu: C={c} not divisible by G={groups}")
    if x.device.type == "cpu":
        return groupnorm_film_reference(x, gamma, beta, scale, shift, groups,
                                        eps, return_stats)
    vec = 16 // x.element_size()
    if not _shape_ok(c, groups, vec):
        raise ValueError(f"groupnorm_film_silu: kernel does not take C={c}, G={groups}")
    cast = lambda t: None if t is None else t.to(x.dtype).contiguous()
    gamma, beta, scale, shift = cast(gamma), cast(beta), cast(scale), cast(shift)
    params = [t for t in (gamma, beta, scale, shift) if t is not None]
    require_cuda("groupnorm_film_silu", [x, *params], (torch.float32, torch.bfloat16))
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("groupnorm_film_silu: gamma and beta must be (C,)")
    for t in (scale, shift):
        if t is not None and t.shape != (b, c):
            raise ValueError("groupnorm_film_silu: scale and shift must be (B, C)")
    # ~8k elements per stats block, at most 256 chunks per batch row
    n_chunks = max(1, min(256, (l * c) // (_THREADS * 32), l))
    apply_blocks = max(1, min(-(-(l * c) // (vec * _THREADS)),
                              max(1, _MAX_APPLY_BLOCKS // b)))
    y = torch.empty_like(x)
    mean = torch.empty((b, c), device=x.device, dtype=torch.float32)
    rstd = torch.empty_like(mean)
    partial = torch.empty((b, n_chunks, groups, 2), device=x.device,
                          dtype=torch.float32)
    ptr = lambda t: None if t is None else t.data_ptr()
    KERNEL.launch(
        x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ptr(scale), ptr(shift),
        y.data_ptr(), mean.data_ptr(), rstd.data_ptr(), partial.data_ptr(),
        b, l, c, groups, n_chunks, apply_blocks, dtype_code(x.dtype),
        float(eps), stream_ptr(x.device),
    )
    return (y, mean, rstd) if return_stats else y
