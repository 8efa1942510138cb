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
The backward follows the JAX package's ``bwd_impl="auto"`` rule
(``bwd_rounds``): at batch >= 2 in bf16 it computes ``_bwd_pallas``'s
arithmetic (the pre-scaled q, dS and P rounded to bf16 before their
products) on the tensor cores; in f32 (the same arithmetic, where rounding
to f32 changes nothing) and at batch 1 (``_bwd_xla_scan``, whose delta is
rowsum(P * dP), never read from out) all-f32 math on the CUDA cores.
``BWD_KERNEL.routes`` counts which route each launch took.

The forward computes what the JAX kernel computes (``_flash_mqa_kernel``):
in bf16 the pre-scaled q is rounded to bf16, the running max moves once
per ``block_k`` keys (``auto_fwd_blocks``, the JAX wrapper's rule, when it
is None), each block's probabilities are rounded to bf16 before the second
product, and the denominator is the f32 sum of those rounded values (the
JAX kernel's ones column). In f32 the block size changes only the order of
f32 roundings. The other TPU tuning arguments (block_q, inner_kv, use_exp2,
interpret) are accepted and ignored.
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
    argtypes=[ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/flash_mqa.py:481",
)
BWD_KERNEL = CudaKernel(
    name="flash_mqa_bwd",
    source="flash_mqa_bwd.cu",
    symbol="d2v_flash_mqa_bwd",
    argtypes=[ctypes.c_void_p] * 10 + [ctypes.c_int] * 8
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/flash_mqa.py:332",
)
SUPPORTED_D = (16, 32, 64)
KEY_TILE = {torch.bfloat16: 128, torch.float32: 16}  # keys per kernel tile
BWD_CHUNK = 1024  # query rows per step of flash_mqa_bwd_reference
NEG_INF = -1e30  # the JAX kernel's initial running max
TILE_BYTES = 2**28  # f32 logits per pass of the plain forwards (bounds memory)


def row_chunk(b: int, block_k: int) -> int:
    """Query rows per pass of a plain forward: rows are independent, so it
    takes as many at once as keep one (b, rows, block_k) f32 tile in
    TILE_BYTES."""
    return max(1, TILE_BYTES // (4 * b * block_k))


def auto_fwd_blocks(n_q: int, n_kv: int) -> Tuple[int, int]:
    """The JAX package's forward (block_q, block_k) rule
    (``ops/pallas/flash_mqa.py::_auto_fwd_blocks``): block_q 1024 from 8192
    query rows; block_k 2048 from 16384 keys, 1024 from 4096, else 512."""
    block_q = 1024 if n_q >= 8192 else 512
    if n_kv >= 16384:
        block_k = 2048
    elif n_kv >= 4096:
        block_k = 1024
    else:
        block_k = 512
    return block_q, block_k


def flash_mqa_reference(q, k, v, sm_scale: float, save_lse: bool = False,
                        block_k: Optional[int] = None, work=torch.float32):
    """Plain version: q (b, n_q, d), k/v (b, n_kv, d). f32: all math in f32,
    one softmax over every key. Otherwise ``_flash_mqa_kernel`` step by
    step: qs = q * sm_scale rounded to q's dtype; per block of ``block_k``
    keys (default ``auto_fwd_blocks``) m' = max(m, rowmax(s)), p = exp(s -
    m') rounded to q's dtype, acc = acc * exp(m - m') + p [v | 1] in f32;
    out = acc_v / l, lse = m + log(l). Keys past n_kv contribute nothing
    (the JAX kernel's edge padding with a zeroed ones row). Query rows are
    taken in chunks (``row_chunk``). ``work=torch.float64`` computes the
    same function with every step after the roundings in f64: the oracle
    the checks hold the kernel and this version to."""
    if q.dtype == torch.float32:
        s = torch.einsum("bnd,bmd->bnm", q.float() * sm_scale, k.float())
        out = (torch.softmax(s, dim=-1) @ v.float()).to(q.dtype)
        if save_lse:
            return out, torch.logsumexp(s, dim=-1)
        return out
    b, n_q, d = q.shape
    n_kv = k.shape[1]
    if block_k is None:
        block_k = auto_fwd_blocks(n_q, n_kv)[1]
    qs = (q.float() * sm_scale).to(q.dtype)
    kf, vf = k.to(work), v.to(work)
    out = torch.empty_like(q)
    lse = torch.empty((b, n_q), dtype=torch.float32, device=q.device)
    rows = row_chunk(b, block_k)
    for r0 in range(0, n_q, rows):
        qc = qs[:, r0:r0 + rows].to(work)
        m = torch.full(qc.shape[:2] + (1,), NEG_INF, dtype=work, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, dtype=work, device=q.device)
        for c0 in range(0, n_kv, block_k):
            s = qc @ kf[:, c0:c0 + block_k].transpose(1, 2)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next).to(q.dtype).to(work)
            alpha = torch.exp(m - m_next)
            acc = acc * alpha + p @ vf[:, c0:c0 + block_k]
            l = l * alpha + p.sum(-1, keepdim=True)
            m = m_next
        out[:, r0:r0 + rows] = (acc / l).to(q.dtype)
        lse[:, r0:r0 + rows] = (m + torch.log(l))[..., 0]
    return (out, lse) if save_lse else out


def _route_batch(q: torch.Tensor, batch: Optional[int]) -> int:
    return q.shape[0] if batch is None else batch


def bwd_rounds(q: torch.Tensor, batch: Optional[int] = None) -> bool:
    """The JAX package's ``bwd_impl="auto"`` (flash_mqa.py:468): batch >= 2
    takes ``_bwd_pallas``, whose products take the pre-scaled q, dS and P
    rounded to the input dtype; batch 1 the all-f32 ``_bwd_xla_scan``. In
    f32 the roundings change nothing, so only a 16-bit batch >= 2 rounds.
    The batch is the one the JAX program traces: ``batch`` when given (the
    global batch under a data mesh, whose ranks hold fewer rows each), else
    q's."""
    return _route_batch(q, batch) >= 2 and q.dtype in (torch.bfloat16, torch.float16)


def bwd_delta_from_out(q: torch.Tensor, batch: Optional[int] = None) -> bool:
    """Where delta is rowsum(g * out), as ``_bwd_pallas`` takes it (batch
    >= 2; ``batch`` as in ``bwd_rounds``). ``_bwd_xla_scan`` (batch 1)
    never reads out: its delta is rowsum(P * dP) of its f32 P and dP, which
    a bf16 out would perturb."""
    return _route_batch(q, batch) >= 2


def flash_mqa_bwd_reference(q, k, v, out, lse, g, sm_scale: float,
                            chunk: int = BWD_CHUNK, batch: Optional[int] = None):
    """Plain backward, one (chunk, n_kv) tile of query rows at a time, so
    the card can hold it at the training shape. P = exp(s - lse) from the
    saved lse, delta as ``bwd_delta_from_out`` says, every sum in f32. Where
    ``bwd_rounds(q)``, the arithmetic of ``_bwd_pallas``: qs = q * sm_scale
    rounded to the input dtype, s = qs k^T, and dS (for dq, dk) and P (for
    dv) rounded to the input dtype before their products; else all f32.
    Returns dq, dk, dv in the input dtypes. ``batch``: the route's batch
    (``bwd_rounds``)."""
    rnd = (lambda t: t.to(q.dtype).float()) if bwd_rounds(q, batch) else (lambda t: t)
    from_out = bwd_delta_from_out(q, batch)
    kf, vf = k.float(), v.float()
    qs = rnd(q.float() * sm_scale)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.zeros_like(dk)
    for r0 in range(0, q.shape[1], chunk):
        sl = slice(r0, r0 + chunk)
        qc, gc = qs[:, sl], g[:, sl].float()
        p = torch.exp(torch.einsum("bcd,bmd->bcm", qc, kf) - lse[:, sl, None].float())
        dp = torch.einsum("bcd,bmd->bcm", gc, vf)
        delta = ((gc * out[:, sl].float()) if from_out else (p * dp)).sum(-1, keepdim=True)
        ds = rnd(p * (dp - delta))
        dq[:, sl] = torch.einsum("bcm,bmd->bcd", ds, kf) * sm_scale
        dk += torch.einsum("bcm,bcd->bmd", ds, qc)
        dv += torch.einsum("bcm,bcd->bmd", rnd(p), gc)
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
    Returns out (b, n_q, d) [, lse (b, n_q) f32]. ``block_k`` (default
    ``auto_fwd_blocks``) is the keys per running-max update; the kernel
    takes a multiple of its tile (``KEY_TILE``). Not differentiable: see
    ``flash_mqa``."""
    del block_q, inner_kv, use_exp2, interpret  # TPU tuning only
    _check_shapes("flash_mqa_fwd", q, k, v)
    b, n_q, d = q.shape
    if block_k is None:
        block_k = auto_fwd_blocks(n_q, k.shape[1])[1]
    if q.device.type == "cpu":
        return flash_mqa_reference(q, k, v, sm_scale, save_lse, block_k)
    _require_kernel_inputs("flash_mqa_fwd", [q, k, v])
    tile = KEY_TILE[q.dtype]
    if block_k <= 0 or block_k % tile:
        raise ValueError(f"flash_mqa_fwd: block_k {block_k} is not a multiple of the "
                         f"kernel's {tile}-key tile")
    out = torch.empty_like(q)
    lse = (torch.empty((b, n_q), device=q.device, dtype=torch.float32)
           if save_lse else None)
    KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        b, n_q, k.shape[1], d, dtype_code(q.dtype), block_k, float(sm_scale),
        stream_ptr(q.device),
    )
    return (out, lse) if save_lse else out


def flash_mqa_bwd(q, k, v, out, lse, g, *, sm_scale: float, batch: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (input dtypes) of ``flash_mqa_fwd`` given its ``out``, its
    ``lse`` and g = dL/dout, on the route ``bwd_rounds`` picks. Where
    ``bwd_delta_from_out``, delta = rowsum(g * out) is a plain op, as the
    JAX package computes it in XLA, and so is qs = bf16(q * sm_scale) on the
    tensor-core route; at batch 1 the kernel computes delta itself.
    ``batch``: the route's batch (``bwd_rounds``)."""
    _check_shapes("flash_mqa_bwd", q, k, v)
    if out.shape != q.shape or g.shape != q.shape or lse.shape != q.shape[:2]:
        raise ValueError("flash_mqa_bwd: out and g must be (b, n_q, d), lse (b, n_q)")
    if q.device.type == "cpu":
        return flash_mqa_bwd_reference(q, k, v, out, lse, g, sm_scale, batch=batch)
    _require_kernel_inputs("flash_mqa_bwd", [q, k, v, out, g])
    require_cuda("flash_mqa_bwd", [lse], (torch.float32,))
    b, n_q, d = q.shape
    n_kv = k.shape[1]
    route = "tensor_cores" if bwd_rounds(q, batch) else "cuda_cores"
    tensor_cores = route == "tensor_cores"
    from_out = bwd_delta_from_out(q, batch)
    if tensor_cores:
        q = (q.float() * sm_scale).to(q.dtype)  # this route's kernel takes qs
    delta = ((g.float() * out.float()).sum(-1) if from_out
             else torch.empty((b, n_q), device=q.device, dtype=torch.float32))
    # the kernel's library plans its query splits; partial is sized by it
    n_split = BWD_KERNEL.query("d2v_flash_mqa_bwd_splits", b, n_q, n_kv, d, int(tensor_cores))
    if n_split <= 0:
        raise ValueError(f"flash_mqa_bwd: no split plan for b={b} n_q={n_q} n_kv={n_kv} d={d}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    partial = torch.empty((n_split, b, n_kv, 2 * d), device=q.device,
                          dtype=torch.float32)
    BWD_KERNEL.launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        partial.data_ptr(), b, n_q, n_kv, d, n_split, dtype_code(q.dtype),
        int(tensor_cores), int(not from_out), float(sm_scale), stream_ptr(q.device),
        route=route,
    )
    return dq, dk, dv


def fwd_residuals(q, k, v, *, sm_scale: float, block_k: Optional[int] = None,
                  batch: Optional[int] = None):
    """The forward's out and the lse its backward takes, as the JAX
    custom_vjp saves them: where ``bwd_rounds`` (``_bwd_pallas``), the
    forward's own lse, m + log of the sum of the rounded probabilities; else
    (batch 1, ``_bwd_xla_scan``, which recomputes an f32 softmax) the exact
    f32 logsumexp, from the f32 forward on f32 copies (the same in f32).
    ``batch``: the route's batch (``bwd_rounds``)."""
    out, lse = flash_mqa_fwd(q, k, v, sm_scale=sm_scale, save_lse=True, block_k=block_k)
    if not bwd_rounds(q, batch) and q.dtype != torch.float32:
        lse = flash_mqa_fwd(q.float(), k.float(), v.float(), sm_scale=sm_scale,
                            save_lse=True)[1]
    return out, lse


class _FlashMQA(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, sm_scale, block_k, batch):
        out, lse = fwd_residuals(q, k, v, sm_scale=sm_scale, block_k=block_k, batch=batch)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.sm_scale, ctx.batch = sm_scale, batch
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_mqa_bwd(q, k, v, out, lse, g.contiguous(),
                                   sm_scale=ctx.sm_scale, batch=ctx.batch)
        return dq, dk, dv, None, None, None


def flash_mqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              sm_scale: float = 1.0, route_batch: Optional[int] = None,
              **tuning) -> torch.Tensor:
    """Differentiable flash MQA (see module docstring); shapes as
    ``flash_mqa_fwd``. ``route_batch`` is the batch the backward's route
    follows (``bwd_rounds``; q's batch by default)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return _FlashMQA.apply(q, k, v, float(sm_scale), tuning.get("block_k"), route_batch)
    return flash_mqa_fwd(q, k, v, sm_scale=sm_scale, **tuning)


def mqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  sm_scale: float, route_batch: Optional[int] = None,
                  **tuning) -> torch.Tensor:
    """q (b, n, h, d); k, v (b, m, d) (null kv already prepended).
    Returns (b, n, h, d). Heads are folded token-major ((n, h) -> n*h rows,
    a free reshape): every head shares the kv, so row order is immaterial.
    The backward uses the same fold; ``route_batch`` as in ``flash_mqa``."""
    b, n, h, d = q.shape
    out = flash_mqa(q.reshape(b, n * h, d), k.contiguous(), v.contiguous(),
                    sm_scale=sm_scale, route_batch=route_batch, **tuning)
    return out.reshape(b, n, h, d)
