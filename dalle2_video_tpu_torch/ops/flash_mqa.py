"""Flash multi-query attention, forward and backward (port of
dalle2_video_tpu/ops/pallas/flash_mqa.py).

``flash_mqa_fwd`` computes softmax(q k^T * sm_scale) v over one shared kv
head; ``flash_mqa_bwd`` its dq, dk, dv from the forward's saved row
logsumexp. For a CUDA tensor each launches its hand-written kernel
(``csrc/flash_mqa.cu``, ``csrc/flash_mqa_bwd.cu``); for a CPU tensor each
uses its plain PyTorch version (``flash_mqa_reference``,
``flash_mqa_bwd_reference``). There is no other path: a CUDA tensor the
kernel does not take raises.

``flash_mqa`` is the differentiable entry point (the JAX ``custom_vjp``):
when a gradient is needed it runs the forward with ``save_lse=True`` and
the backward kernel; under ``no_grad`` it is exactly the serving call.
The kernel runs at every batch size (JAX's "batch 1 -> XLA scan" rule is a
TPU timing choice).

The TPU tuning arguments (block_q, block_k, inner_kv, use_exp2, interpret)
are accepted and ignored.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple, Union

import torch

from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    forbid_grad,
    require_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    name="flash_mqa_fwd",
    source="flash_mqa.cu",
    symbol="d2v_flash_mqa_fwd",
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/flash_mqa.py:481",
)
BWD_KERNEL = CudaKernel(
    name="flash_mqa_bwd",
    source="flash_mqa_bwd.cu",
    symbol="d2v_flash_mqa_bwd",
    argtypes=[ctypes.c_void_p] * 10 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/flash_mqa.py:332",
)
SUPPORTED_D = (16, 32, 64)
_BWD_KEYS_PER_BLOCK = 128  # kKeys in csrc/flash_mqa_bwd.cu
_BWD_TARGET_BLOCKS = 8 * 132  # ~8 dk/dv blocks per H100 SM
BWD_CHUNK = 1024  # query rows per step of flash_mqa_bwd_reference


def flash_mqa_reference(q, k, v, sm_scale: float, save_lse: bool = False):
    """Plain version: q (b, n_q, d), k/v (b, n_kv, d), all math in f32."""
    s = torch.einsum("bnd,bmd->bnm", q.float() * sm_scale, k.float())
    out = torch.softmax(s, dim=-1) @ v.float()
    out = out.to(q.dtype)
    if save_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


def flash_mqa_bwd_reference(q, k, v, out, lse, g, sm_scale: float,
                            chunk: int = BWD_CHUNK):
    """Plain backward in f32, one (chunk, n_kv) tile of query rows at a time
    (the JAX package's _bwd_xla_scan), so the card can hold it at the
    training shape. P = exp(s - lse) from the saved lse, delta =
    rowsum(g * out). Returns dq, dk, dv in the input dtypes."""
    kf, vf = k.float(), v.float()
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, q.shape[1], chunk):
        sl = slice(r0, r0 + chunk)
        qc, gc = q[:, sl].float(), g[:, sl].float()
        delta = (gc * out[:, sl].float()).sum(-1, keepdim=True)
        p = torch.exp(torch.einsum("bcd,bmd->bcm", qc * sm_scale, kf)
                      - lse[:, sl, None].float())
        ds = p * (torch.einsum("bcd,bmd->bcm", gc, vf) - delta)
        dq[:, sl] = torch.einsum("bcm,bmd->bcd", ds, kf) * sm_scale
        dk += torch.einsum("bcm,bcd->bmd", ds, qc) * sm_scale
        dv += torch.einsum("bcm,bcd->bmd", p, gc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _check_shapes(name, q, k, v):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: q {q.shape} and k {k.shape} disagree")


def _require_kernel_inputs(name, tensors):
    forbid_grad(name, tensors, "flash_mqa is the differentiable entry point")
    require_cuda(name, tensors, (torch.float32, torch.bfloat16))
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"{name}: q, k, v (and g, out) must share a dtype")
    d = tensors[0].shape[-1]
    if d not in SUPPORTED_D:
        raise ValueError(f"{name}: head dim {d} not in {SUPPORTED_D}")


def flash_mqa_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    sm_scale: float = 1.0,
    save_lse: bool = False,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
    inner_kv: int = 1,
    use_exp2: bool = False,
    interpret: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """q (b, n_q, d) with heads folded into rows; k, v (b, n_kv, d).
    Returns out (b, n_q, d) [, lse (b, n_q) f32]. Not differentiable: see
    ``flash_mqa``."""
    del block_q, block_k, inner_kv, use_exp2, interpret  # TPU tuning only
    _check_shapes("flash_mqa_fwd", q, k, v)
    b, n_q, d = q.shape
    if q.device.type == "cpu":
        return flash_mqa_reference(q, k, v, sm_scale, save_lse)
    _require_kernel_inputs("flash_mqa_fwd", [q, k, v])
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_q), device=q.device, dtype=torch.float32)
           if save_lse else None)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, n_q, k.shape[1], d, dtype_code(q.dtype), float(sm_scale),
        stream_ptr(q.device),
    )
    return (out, lse) if save_lse else out


def flash_mqa_bwd(q, k, v, out, lse, g, *, sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (input dtypes) of ``flash_mqa_fwd`` given its ``out``, its
    ``lse`` and g = dL/dout. delta = rowsum(g * out) is a plain f32 op, as
    the JAX package computes it in XLA."""
    _check_shapes("flash_mqa_bwd", q, k, v)
    if out.shape != q.shape or g.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError("flash_mqa_bwd: out and g must be (b, n_q, d), lse (b, n_q)")
    if q.device.type == "cpu":
        return flash_mqa_bwd_reference(q, k, v, out, lse, g, sm_scale)
    _require_kernel_inputs("flash_mqa_bwd", [q, k, v, out, g])
    require_cuda("flash_mqa_bwd", [lse], (torch.float32,))
    b, n_q, d = q.shape
    n_kv = k.shape[1]
    delta = (g.float() * out.float()).sum(-1)
    kv_blocks = b * -(-n_kv // _BWD_KEYS_PER_BLOCK)
    n_split = max(1, min(-(-_BWD_TARGET_BLOCKS // kv_blocks), n_q))
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = torch.empty((n_split, b, n_kv, 2 * d), device=q.device,
                          dtype=torch.float32)
    BWD_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        partial.data_ptr(), b, n_q, n_kv, d, n_split, dtype_code(q.dtype),
        float(sm_scale), stream_ptr(q.device),
    )
    return dq, dk, dv


class _FlashMQA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale):
        out, lse = flash_mqa_fwd(q, k, v, sm_scale=sm_scale, save_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale = sm_scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_mqa_bwd(q, k, v, out, lse, g.contiguous(),
                                   sm_scale=ctx.sm_scale)
        return dq, dk, dv, None


def flash_mqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: float = 1.0, **tuning) -> torch.Tensor:
    """Differentiable flash MQA (see module docstring); shapes as
    ``flash_mqa_fwd``."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMQA.apply(q, k, v, float(sm_scale))
    return flash_mqa_fwd(q, k, v, sm_scale=sm_scale, **tuning)


def mqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, **tuning) -> torch.Tensor:
    """q (b, n, h, d); k, v (b, m, d) (null kv already prepended).
    Returns (b, n, h, d). Heads are folded token-major ((n, h) -> n*h rows,
    a free reshape): every head shares the kv, so row order is immaterial.
    The backward uses the same fold."""
    b, n, h, d = q.shape
    out = flash_mqa(q.reshape(b, n * h, d), k.contiguous(), v.contiguous(),
                    sm_scale=sm_scale, **tuning)
    return out.reshape(b, n, h, d)
