"""Tiny-context cross-attention forward (port of
dalle2_video_tpu/ops/pallas/cross_attention.py).

softmax(q k^T * sm_scale) v per (batch, head) with the whole context (m <= 16
keys) held on chip. For a CUDA tensor the wrapper launches the kernel in
``csrc/cross_attention.cu``; for a CPU tensor it uses
``cross_attention_reference``, einsums and a softmax in the input dtype.

The kernel is forward-only by design, as in the JAX package (training keeps
the plain path, ``cross_attention_impl: xla``). For a CUDA tensor that
needs a gradient the wrapper raises rather than return a result that has
silently lost it.
"""

from __future__ import annotations

import ctypes

import torch

from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    forbid_grad,
    require_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    name="cross_attention_fwd",
    source="cross_attention.cu",
    symbol="d2v_cross_attention_fwd",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/cross_attention.py:43",
)
MAX_M = 16  # kMaxM in csrc/cross_attention.cu
SUPPORTED_D = (32, 64)


def softmax_as_jax(s: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """``jax.nn.softmax`` in the input dtype: exp(s - max) rounded to it,
    the sum accumulated in f32 and rounded (``jnp.sum`` upcasts bf16), the
    quotient rounded."""
    e = torch.exp(s - s.amax(dim, keepdim=True))
    return e / e.sum(dim, keepdim=True)


def cross_attention_reference(q, k, v, sm_scale: float) -> torch.Tensor:
    """Plain version: q (b, n, h, d), k/v (b, m, h, d), in their dtype as the
    JAX package's plain path computes it (bf16 products accumulate in f32
    and round). The kernel checks on the card pass f32 copies and round."""
    s = torch.einsum("bnhd,bmhd->bhnm", q * sm_scale, k)
    return torch.einsum("bhnm,bmhd->bnhd", softmax_as_jax(s, dim=-1), v)


def cross_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    sm_scale: float, block_n: int = 1024,
                    interpret: bool = False) -> torch.Tensor:
    """q (b, n, h, d); k, v (b, m, h, d). Returns (b, n, h, d)."""
    del block_n, interpret  # TPU tuning only
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"cross_attention: bad shapes {q.shape} {k.shape} {v.shape}")
    b, n, h, d = q.shape
    m = k.shape[1]
    if k.shape[0] != b or k.shape[2:] != (h, d):
        raise ValueError(f"cross_attention: q {q.shape} and k {k.shape} disagree")
    if q.device.type == "cpu":
        return cross_attention_reference(q, k, v, sm_scale)
    forbid_grad("cross_attention", [q, k, v],
                "the CUDA kernel is forward-only; training uses cross_attention_impl: xla")
    k, v = k.contiguous(), v.contiguous()
    require_cuda("cross_attention", [q, k, v], (torch.float32, torch.bfloat16))
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("cross_attention: q, k, v must share a dtype")
    if m > MAX_M:
        raise ValueError(f"cross_attention: context of {m} keys exceeds {MAX_M}")
    if d not in SUPPORTED_D:
        raise ValueError(f"cross_attention: head dim {d} not in {SUPPORTED_D}")
    out = torch.empty_like(q)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, n, h, m, d, dtype_code(q.dtype), float(sm_scale),
        stream_ptr(q.device),
    )
    return out
