"""Flash multi-query attention forward (port of
dalle2_video_tpu/ops/pallas/flash_mqa.py, forward only).

``flash_mqa_fwd`` computes softmax(q k^T * sm_scale) v over one shared kv
head. For a CUDA tensor it launches the hand-written kernel in
``csrc/flash_mqa.cu``; for a CPU tensor it uses ``flash_mqa_reference``, the
plain PyTorch version (an einsum with softmax in float32). There is no other
path: a CUDA tensor the kernel does not take raises.

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
SUPPORTED_D = (16, 32, 64)


def flash_mqa_reference(q, k, v, sm_scale: float, save_lse: bool = False):
    """Plain version: q (b, n_q, d), k/v (b, n_kv, d), all math in f32."""
    s = torch.einsum("bnd,bmd->bnm", q.float() * sm_scale, k.float())
    out = torch.softmax(s, dim=-1) @ v.float()
    out = out.to(q.dtype)
    if save_lse:
        return out, torch.logsumexp(s, dim=-1)
    return out


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
    Returns out (b, n_q, d) [, lse (b, n_q) f32]."""
    del block_q, block_k, inner_kv, use_exp2, interpret  # TPU tuning only
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"flash_mqa_fwd: bad shapes {q.shape} {k.shape} {v.shape}")
    b, n_q, d = q.shape
    if k.shape[0] != b or k.shape[2] != d:
        raise ValueError(f"flash_mqa_fwd: q {q.shape} and k {k.shape} disagree")
    if q.device.type == "cpu":
        return flash_mqa_reference(q, k, v, sm_scale, save_lse)
    require_cuda("flash_mqa_fwd", [q, k, v], (torch.float32, torch.bfloat16))
    if not (q.dtype == k.dtype == v.dtype):
        raise ValueError("flash_mqa_fwd: q, k, v must share a dtype")
    if d not in SUPPORTED_D:
        raise ValueError(f"flash_mqa_fwd: head dim {d} not in {SUPPORTED_D}")
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


def mqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, **tuning) -> torch.Tensor:
    """q (b, n, h, d); k, v (b, m, d) (null kv already prepended).
    Returns (b, n, h, d). Heads are folded token-major ((n, h) -> n*h rows,
    a free reshape): every head shares the kv, so row order is immaterial."""
    b, n, h, d = q.shape
    out = flash_mqa_fwd(q.reshape(b, n * h, d), k.contiguous(), v.contiguous(),
                        sm_scale=sm_scale, **tuning)
    return out.reshape(b, n, h, d)
