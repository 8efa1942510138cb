"""Fused GroupNorm -> FiLM -> SiLU, forward and backward (port of
dalle2_video_tpu/ops/pallas/groupnorm_film.py).

y = silu(xhat * A + B), A = gamma * (scale + 1), B = beta * (scale + 1) +
shift, over x (B, L, C) with G groups. For a CUDA tensor the forward
launches the two-pass kernel in ``csrc/groupnorm_film.cu`` (one call = one
counted launch: stats pass + apply pass) and the backward the three-pass
kernel in ``csrc/groupnorm_film_bwd.cu``; for a CPU tensor they use
``groupnorm_film_reference`` (the two-pass math of the JAX package's
``_reference_math``) and ``groupnorm_film_bwd_reference`` (the formula of
its ``_bwd_kernel``).

``groupnorm_film_silu`` is differentiable (the JAX ``custom_vjp``): when a
gradient is needed it saves x and the forward's per-channel mean / rstd,
and its backward returns dx from the kernel and chains the (B, C) dA, dB
into the gamma / beta / FiLM gradients in plain PyTorch, as ``_vjp_bwd``
does in XLA. Every gradient comes back in the dtype the caller passed.
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
    name="groupnorm_film_silu_fwd",
    source="groupnorm_film.cu",
    symbol="d2v_groupnorm_film_silu_fwd",
    argtypes=[ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
    + [ctypes.c_float, ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/groupnorm_film.py:132",
)
BWD_KERNEL = CudaKernel(
    name="groupnorm_film_silu_bwd",
    source="groupnorm_film_bwd.cu",
    symbol="d2v_groupnorm_film_silu_bwd",
    argtypes=[ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/groupnorm_film.py:276",
)
_THREADS = 256
_MAX_APPLY_BLOCKS = 8 * 132  # ~8 blocks per H100 SM in all, split over B


def _shape_ok(c: int, groups: int, vec: int) -> bool:
    """The kernels' rule: C holds whole 16-byte vectors and divides one
    block-stride of them (so each thread's channels stay fixed)."""
    if groups <= 0 or groups > 32 or _THREADS % groups or c % groups or c > 1024:
        return False
    return c % vec == 0 and (_THREADS * vec) % c == 0


def _grid(b: int, l: int, c: int, vec: int, max_chunks: int) -> Tuple[int, int]:
    """(chunks per batch row for the sums pass, blocks per batch row for
    the elementwise pass)."""
    n_chunks = max(1, min(max_chunks, (l * c) // (_THREADS * 32), l))
    blocks = max(1, min(-(-(l * c) // (vec * _THREADS)),
                        max(1, _MAX_APPLY_BLOCKS // b)))
    return n_chunks, blocks


def fold_ab(gamma, beta, scale, shift, dtype, batch: int
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A, B (batch, C) f32 from the parameters as the kernels see them (cast
    to the activation dtype). scale / shift None count as 0."""
    g32, b32 = gamma.to(dtype).float(), beta.to(dtype).float()
    s1 = 1.0 if scale is None else scale.to(dtype).float() + 1.0
    a_vec = g32[None, :] * s1
    b_vec = b32[None, :] * s1
    if shift is not None:
        b_vec = b_vec + shift.to(dtype).float()
    c = gamma.shape[0]
    return a_vec.expand(batch, c).contiguous(), b_vec.expand(batch, c).contiguous()


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


def groupnorm_film_bwd_reference(x, g, a_vec, b_vec, mean, rstd, groups: int):
    """Plain backward: the JAX ``_bwd_kernel`` formula in f32, written out.
    a_vec, b_vec, mean, rstd are (B, C) f32. Returns dx (x.dtype) and the
    (B, C) f32 dA = sum_L dz * xhat, dB = sum_L dz."""
    b, l, c = x.shape
    xhat = (x.float() - mean[:, None, :]) * rstd[:, None, :]
    z = xhat * a_vec[:, None, :] + b_vec[:, None, :]
    sig = torch.sigmoid(z)
    dz = g.float() * sig * (1.0 + z * (1.0 - sig))
    t1, t2 = dz.sum(1), (dz * xhat).sum(1)
    n_el = l * (c // groups)

    def group_fold(t):  # sum over the group of A * t, broadcast per channel
        s = (a_vec * t).reshape(b, groups, c // groups).sum(-1, keepdim=True)
        return (s.expand(b, groups, c // groups) / n_el).reshape(b, c)

    s1, s2 = group_fold(t1), group_fold(t2)
    dx = rstd[:, None, :] * (a_vec[:, None, :] * dz - s1[:, None, :]
                             - xhat * s2[:, None, :])
    return dx.to(x.dtype), t2, t1


def _validate(x, gamma, beta, scale, shift, groups):
    if x.ndim != 3:
        raise ValueError(f"groupnorm_film_silu: x must be (B, L, C), got {x.shape}")
    b, l, c = x.shape
    if c % groups:
        raise ValueError(f"groupnorm_film_silu: C={c} not divisible by G={groups}")
    if gamma.shape != (c,) or beta.shape != (c,):
        raise ValueError("groupnorm_film_silu: gamma and beta must be (C,)")
    for t in (scale, shift):
        if t is not None and t.shape != (b, c):
            raise ValueError("groupnorm_film_silu: scale and shift must be (B, C)")


def _require_kernel_shape(name, x, groups):
    c = x.shape[2]
    if not _shape_ok(c, groups, 16 // x.element_size()):
        raise ValueError(f"{name}: kernel does not take C={c}, G={groups}")


def _forward(x, gamma, beta, scale, shift, groups, eps):
    """(y, mean, rstd): the kernel for a CUDA tensor, the plain version for
    a CPU tensor."""
    if x.device.type == "cpu":
        return groupnorm_film_reference(x, gamma, beta, scale, shift, groups,
                                        eps, return_stats=True)
    forbid_grad("groupnorm_film_silu", [x, gamma, beta, scale, shift],
                "return_stats=True gives no gradient")
    _require_kernel_shape("groupnorm_film_silu", x, groups)
    b, l, c = x.shape
    cast = lambda t: None if t is None else t.to(x.dtype).contiguous()
    gamma, beta, scale, shift = cast(gamma), cast(beta), cast(scale), cast(shift)
    params = [t for t in (gamma, beta, scale, shift) if t is not None]
    require_cuda("groupnorm_film_silu", [x, *params], (torch.float32, torch.bfloat16))
    # ~8k elements per stats block, at most 256 chunks per batch row
    n_chunks, apply_blocks = _grid(b, l, c, 16 // x.element_size(), 256)
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
    return y, mean, rstd


def groupnorm_film_bwd(x, g, a_vec, b_vec, mean, rstd, groups: int,
                       kernel: CudaKernel = BWD_KERNEL
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dx (x.dtype), dA, dB (B, C) f32 of the fused forward, given g =
    dL/dy, A, B and the forward's per-channel mean / rstd (all (B, C) f32).
    ``kernel`` is the entry that counts the launch: the fused Block3D's
    backward launches the same kernel under its own table row."""
    b, l, c = x.shape
    if g.shape != x.shape:
        raise ValueError(f"groupnorm_film_bwd: g {g.shape} vs x {x.shape}")
    if any(t.shape != (b, c) for t in (a_vec, b_vec, mean, rstd)):
        raise ValueError("groupnorm_film_bwd: A, B, mean, rstd must be (B, C)")
    if x.device.type == "cpu":
        return groupnorm_film_bwd_reference(x, g, a_vec, b_vec, mean, rstd, groups)
    forbid_grad("groupnorm_film_bwd", [x, g, a_vec, b_vec], "no double backward")
    _require_kernel_shape("groupnorm_film_bwd", x, groups)
    require_cuda("groupnorm_film_bwd", [x, g], (torch.float32, torch.bfloat16))
    vecs = [t.contiguous() for t in (a_vec, b_vec, mean, rstd)]
    require_cuda("groupnorm_film_bwd", vecs, (torch.float32,))
    if g.dtype != x.dtype:
        raise ValueError("groupnorm_film_bwd: g and x must share a dtype")
    # ~8k elements per sums block, at most 512 chunks per batch row
    n_chunks, dx_blocks = _grid(b, l, c, 16 // x.element_size(), 512)
    dx = torch.empty_like(x)
    da = torch.empty((b, c), device=x.device, dtype=torch.float32)
    db = torch.empty_like(da)
    partial = torch.empty((b, n_chunks, 2, c), device=x.device, dtype=torch.float32)
    kernel.launch(
        x.data_ptr(), g.data_ptr(), *(t.data_ptr() for t in vecs),
        dx.data_ptr(), da.data_ptr(), db.data_ptr(), partial.data_ptr(),
        b, l, c, groups, n_chunks, dx_blocks, dtype_code(x.dtype),
        stream_ptr(x.device),
    )
    return dx, da, db


class _GroupNormFilmSiLU(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, gamma, beta, scale, shift, groups, eps):
        y, mean, rstd = _forward(x, gamma, beta, scale, shift, groups, eps)
        ctx.save_for_backward(x, gamma, beta, scale, shift, mean, rstd)
        ctx.groups = groups
        return y

    @staticmethod
    def backward(ctx, gy):
        x, gamma, beta, scale, shift, mean, rstd = ctx.saved_tensors
        a_vec, b_vec = fold_ab(gamma, beta, scale, shift, x.dtype, x.shape[0])
        dx, da, db = groupnorm_film_bwd(x, gy.contiguous(), a_vec, b_vec, mean,
                                        rstd, ctx.groups)
        need = ctx.needs_input_grad
        s1 = 1.0 if scale is None else scale.to(x.dtype).float() + 1.0
        dgamma = (da * s1).sum(0).to(gamma.dtype) if need[1] else None
        dbeta = (db * s1).sum(0).to(beta.dtype) if need[2] else None
        dscale = dshift = None
        if scale is not None and need[3]:
            dscale = (da * gamma.to(x.dtype).float()[None, :]
                      + db * beta.to(x.dtype).float()[None, :]).to(scale.dtype)
        if shift is not None and need[4]:
            dshift = db.to(shift.dtype)
        return dx if need[0] else None, dgamma, dbeta, dscale, dshift, None, None


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
    per-channel broadcast of each group's statistics; not differentiable]."""
    del block_l, interpret  # TPU tuning only
    _validate(x, gamma, beta, scale, shift, groups)
    inputs = (x, gamma, beta, scale, shift)
    if (not return_stats and torch.is_grad_enabled()
            and any(t is not None and t.requires_grad for t in inputs)):
        return _GroupNormFilmSiLU.apply(*inputs, groups, eps)
    y, mean, rstd = _forward(x, gamma, beta, scale, shift, groups, eps)
    return (y, mean, rstd) if return_stats else y
