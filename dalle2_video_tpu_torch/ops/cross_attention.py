"""Tiny-context cross-attention forward (port of
dalle2_video_tpu/ops/pallas/cross_attention.py).

softmax(q k^T * sm_scale) v per (batch, head) with the whole context (m <= 16
keys) held on chip. For a CUDA tensor the wrapper launches the kernel in
``csrc/cross_attention.cu``; for a CPU tensor it uses
``fused_cross_attention_reference``, the JAX kernel's function step by step.

Row 5 has two plain versions, one for each of the JAX routes of
``CrossAttention`` that the kernel may stand in for:

* ``fused_cross_attention_reference`` -- ``impl="flash"``, the Pallas
  kernel ``fused_cross_attention`` (``_kernel``): f32 logits from the
  product, times sm_scale in f32, ``jax.nn.softmax`` in f32, p rounded to
  v's dtype, p v in f32, one rounding of the output. The kernel computes
  this function, and the checks hold it to it.
* ``cross_attention_reference`` -- ``impl="xla"``, the einsums: q * scale
  rounded, the logits rounded, the softmax in the input dtype
  (``softmax_as_jax``).

In f32 the two are the same function up to the order of f32 roundings.
The third JAX route, ``impl="broadcast"``, is ``broadcast_cross_attention``
here: plain PyTorch, no kernel (the JAX route is XLA ops too).

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
from dalle2_video_tpu_torch.ops.as_jax import softmax_as_jax

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


def _masked(s: torch.Tensor, mask) -> torch.Tensor:
    """The logits s (b, h, n, m) with the keys outside ``mask`` (b, m) at
    the dtype's lowest value (the JAX ``jnp.where(mask, sim, finfo.min)``)."""
    if mask is None:
        return s
    return s.masked_fill(~mask[:, None, None, :], torch.finfo(s.dtype).min)


def cross_attention_reference(q, k, v, sm_scale: float, mask=None) -> torch.Tensor:
    """The xla route (``CrossAttention(impl="xla")``): q (b, n, h, d), k/v
    (b, m, h, d), in their dtype as the JAX package's einsum path computes
    it (bf16 products accumulate in f32 and round, the softmax in bf16).
    ``mask`` (b, m), True where a key is attended to."""
    s = _masked(torch.einsum("bnhd,bmhd->bhnm", q * sm_scale, k), mask)
    return torch.einsum("bhnm,bmhd->bnhd", softmax_as_jax(s, dim=-1), v)


def broadcast_cross_attention(q, k, v, sm_scale: float, mask=None) -> torch.Tensor:
    """The broadcast route (``CrossAttention(impl="broadcast")``, JAX
    layers.py:336-352: ``sum(q[:, None] * (k * scale)[:, :, None], -1)``,
    ``jax.nn.softmax`` over the context axis, ``sum(p[..., None] * v, 1)``)
    with the roundings of the jitted JAX program in a narrow dtype: k times
    the scale (itself rounded to the dtype, a weak-typed constant) rounded;
    the q . k products and their sum in f32, the logits rounded; s - max
    rounded, its exp summed in f32 unrounded and the sum rounded, the
    quotient of the rounded exp by it rounded; the p . v products and their
    sum in f32, rounded once. ``mask`` (b, m) as the einsum route's. In f32
    there is nothing to round and this is the plain softmax attention."""
    dt = q.dtype
    ks = k * torch.tensor(sm_scale, dtype=dt)
    s = torch.einsum("bnhd,bmhd->bhnm", q.float(), ks.float()).to(dt)
    s = _masked(s, mask)
    z = s - s.amax(-1, keepdim=True)
    e = torch.exp(z.float())
    p = e.to(dt) / e.sum(-1, keepdim=True).to(dt)
    return torch.einsum("bhnm,bmhd->bnhd", p.float(), v.float()).to(dt)


def fused_cross_attention_reference(q, k, v, sm_scale: float,
                                    work: torch.dtype = torch.float32) -> torch.Tensor:
    """The flash route (``CrossAttention(impl="flash")``), the JAX kernel's
    function: q (b, n, h, d), k/v (b, m, h, d). The logits in ``work`` from
    the upcast inputs, times sm_scale after the product, softmax as
    ``jax.nn.softmax`` (exp(s - max), then divided by the sum), p rounded to
    v's dtype, p v in ``work``, the output rounded once. ``work=torch.float64``
    computes the same function in f64 after the rounding of p: the oracle
    the checks hold the kernel and this version to."""
    s = torch.einsum("bnhd,bmhd->bhnm", q.to(work), k.to(work)) * sm_scale
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(v.dtype).to(work)
    return torch.einsum("bhnm,bmhd->bnhd", p, v.to(work)).to(q.dtype)


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
        return fused_cross_attention_reference(q, k, v, sm_scale)
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
