"""Fused Block3D: 3x3 conv + bias + GroupNorm + FiLM + SiLU, forward and
backward (port of dalle2_video_tpu/ops/pallas/fused_block.py).

Forward, as the JAX module does it:
  1. one kernel: the 3x3 conv with a bias-and-statistics epilogue -- y in
     the activation dtype, and per (batch row, channel) sums of y and y^2
     over (T, H, W) taken from the f32 value before the rounding
     (``csrc/conv3x3.cu`` built with the epilogue; its partial sums are
     reduced in a fixed order, no atomics, so two calls agree bit for bit);
  2. glue on (B, Co) vectors: group mean / rstd from the sums in the JAX
     one-pass form E[y^2] - mean^2, and the GroupNorm affine, FiLM and mean
     folded into one per-channel affine;
  3. silu(y * A'' + B'') on the (B, T*H*W, Co) view, plain PyTorch (XLA
     glue in the JAX package).
The JAX kernel works on the TPU's pixel-pair packed layout, whose two lanes
of a pair carry the same channel; its per-lane vectors are per-channel
vectors here, and its lane fold (``fold``) is already done.

Backward (``fused_block3d`` is an ``autograd.Function``, the JAX
custom_vjp): the GroupNorm-FiLM-SiLU backward kernel of
``csrc/groupnorm_film_bwd.cu`` on the (B, T*H*W, Co) view with the
forward's per-channel mean / rstd (the JAX row reuses that kernel's body
on its packed view; here it counts its launches as ``GN_BWD_KERNEL``);
dgamma, dbeta, dscale, dshift from its (B, Co) sums; dbias in closed form
from those sums and the forward's Σy, with no extra pass; dx from the conv
kernel on the flipped, transposed weight and dW from the weight-gradient
kernel (``ops/spatial_conv.py``).

For a CPU tensor each kernel call takes its plain version. Rounding points
follow the JAX module: the conv output is stored in the activation dtype
and the backward reads that stored value; vectors stay f32.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from dalle2_video_tpu_torch.ops import groupnorm_film as gn
from dalle2_video_tpu_torch.ops import spatial_conv as sc
from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    forbid_grad,
    require_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    name="conv3x3_bias_stats",
    source="conv3x3.cu",
    symbol="d2v_conv3x3_bias_stats",
    argtypes=[ctypes.c_void_p] * 7 + [ctypes.c_int] * 12 + [ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/fused_block.py:124",
    defines=sc.CONV_DEFINES,
)
GN_BWD_KERNEL = CudaKernel(
    name="fused_block_gn_bwd",
    source=gn.BWD_KERNEL.source,
    symbol=gn.BWD_KERNEL.symbol,
    argtypes=gn.BWD_KERNEL.argtypes,
    replaces="dalle2_video_tpu/ops/pallas/fused_block.py:204",
    defines=gn.DEFINES,
)


def conv_bias_stats_reference(x, w, bias, batch: int):
    """Plain version: the conv of f32 copies plus the f32 bias, the sums of
    y and y^2 per (batch row, channel) from that f32 value, then y rounded
    to x's dtype. x (B*T, H, W, C), w OIHW, bias (Co,)."""
    y = F.conv2d(sc._nchw(x.float()), w.to(x.dtype).float(), padding=1)
    y = y.permute(0, 2, 3, 1) + bias.float()
    rows = y.reshape(batch, -1, y.shape[-1])
    return y.to(x.dtype), rows.sum(1), (rows * rows).sum(1)


def conv_bias_stats(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor, batch: int
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B*T, H, W, C), w (Co, C, 3, 3), bias (Co,) -> y (B*T, H, W, Co) in
    x's dtype, and Σy, Σy² (B, Co) f32 over each batch row's (T, H, W)."""
    co, c = w.shape[:2]
    sc._check("conv_bias_stats", x, c)
    if w.shape[2:] != (3, 3) or bias.shape != (co,):
        raise ValueError("conv_bias_stats: w must be (Co, C, 3, 3) and bias (Co,)")
    n, h, wd, _ = x.shape
    if batch <= 0 or n % batch:
        raise ValueError(f"conv_bias_stats: {n} frames do not split into {batch} rows")
    if x.device.type == "cpu":
        return conv_bias_stats_reference(x, w, bias, batch)
    forbid_grad("conv_bias_stats", [x, w, bias], "fused_block3d is the differentiable entry point")
    wk = sc.kernel_weight(w, x.dtype)
    sc._require_conv_inputs("conv_bias_stats", [x, wk], c, co, sc.CONV_BK, sc.CONV_BN)
    bias32 = bias.float().contiguous()
    require_cuda("conv_bias_stats", [bias32], (torch.float32,))
    plan = sc.plan_args(x, co, batch)  # the statistics partials are per (batch row, tile)
    tiles = plan[3]
    y = torch.empty((n, h, wd, co), device=x.device, dtype=x.dtype)
    s = torch.empty((batch, co), device=x.device, dtype=torch.float32)
    ss = torch.empty_like(s)
    partial = torch.empty((batch, tiles, 2, co), device=x.device, dtype=torch.float32)
    KERNEL.launch(x.data_ptr(), wk.data_ptr(), bias32.data_ptr(), y.data_ptr(),
                  s.data_ptr(), ss.data_ptr(), partial.data_ptr(), n, h, wd, c, co, batch,
                  *plan, dtype_code(x.dtype), stream_ptr(x.device))
    return y, s, ss


# --------------------------------------------------------------- glue math
def _group_sum(v: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, Co) -> each group's sum broadcast back to its channels."""
    b, co = v.shape
    s = v.reshape(b, groups, co // groups).sum(-1, keepdim=True)
    return s.expand(b, groups, co // groups).reshape(b, co)


def stats_to_mean_rstd(s, ss, groups: int, n_g: int, eps: float):
    """Per-channel broadcasts of each group's mean and rstd from the
    per-channel sums (the JAX ``_stats_to_mean_rstd``; n_g = T*H*W*Co/G)."""
    mean = _group_sum(s, groups) / n_g
    var = _group_sum(ss, groups) / n_g - mean * mean
    return mean, torch.rsqrt(var + eps)


def fold_ab(gamma, beta, scale, shift, batch: int):
    """A = gamma (scale + 1), B = beta (scale + 1) + shift, (B, Co) f32 from
    the parameters as they are (the JAX ``_fold_ab_lanes``, whose math is f32
    on the raw parameters); scale / shift None count as 0."""
    return gn.fold_ab(gamma, beta, scale, shift, torch.float32, batch)


def _forward(x, w, bias, gamma, beta, scale, shift, groups, eps):
    b, t, h, wd, c = x.shape
    co = w.shape[0]
    y, s, ss = conv_bias_stats(x.reshape(b * t, h, wd, c), w, bias, b)
    mean, rstd = stats_to_mean_rstd(s, ss, groups, t * h * wd * (co // groups), eps)
    a_vec, b_vec = fold_ab(gamma, beta, scale, shift, b)
    a2 = rstd * a_vec  # the mean folded into the affine: z = y A'' + B''
    b2 = b_vec - mean * a2
    z = torch.addcmul(b2[:, None, :], y.reshape(b, t * h * wd, co).float(), a2[:, None, :])
    out = F.silu(z).to(x.dtype).reshape(b, t, h, wd, co)
    return out, y, s, mean, rstd


class _FusedBlock3D(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias, gamma, beta, scale, shift, groups, eps):
        out, y, s, mean, rstd = _forward(x, w, bias, gamma, beta, scale, shift, groups, eps)
        ctx.save_for_backward(x, w, bias, gamma, beta, scale, shift, y, s, mean, rstd)
        ctx.groups = groups
        return out

    @staticmethod
    def backward(ctx, g):
        x, w, bias, gamma, beta, scale, shift, y, s, mean, rstd = ctx.saved_tensors
        groups = ctx.groups
        b, t, h, wd, c = x.shape
        co = w.shape[0]
        r = t * h * wd
        need = ctx.needs_input_grad

        # GroupNorm + FiLM + SiLU backward on the stored conv output
        a_vec, b_vec = fold_ab(gamma, beta, scale, shift, b)
        dy, da, db = gn.groupnorm_film_bwd(
            y.reshape(b, r, co), g.to(y.dtype).reshape(b, r, co).contiguous(),
            a_vec, b_vec, mean, rstd, groups, kernel=GN_BWD_KERNEL)
        s1 = 1.0 if scale is None else scale.float() + 1.0
        dgamma = (da * s1).sum(0).to(gamma.dtype) if need[3] else None
        dbeta = (db * s1).sum(0).to(beta.dtype) if need[4] else None
        dscale = dshift = None
        if scale is not None and need[5]:
            dscale = (da * gamma.float()[None, :] + db * beta.float()[None, :]).to(scale.dtype)
        if shift is not None and need[6]:
            dshift = db.to(shift.dtype)

        # dbias = Σ over (T, H, W) of dy, in closed form (JAX :324-337):
        # Σ dy = rstd (A Σdz - R S1 - S2 Σxhat), Σxhat = rstd (Σy - R mean)
        dbias = None
        if need[2]:
            n_g = r * co // groups
            s1_c = _group_sum(a_vec * db, groups) / n_g
            s2_c = _group_sum(a_vec * da, groups) / n_g
            sum_xhat = rstd * (s - r * mean)
            dbias = (rstd * (a_vec * db - r * s1_c - s2_c * sum_xhat)).sum(0).to(bias.dtype)

        # the conv's backward: kernel dx on the adjoint weight, kernel dW
        dy = dy.reshape(b * t, h, wd, co)
        dx = dw = None
        if need[0]:
            dx = sc.conv3x3(dy, sc.transposed_weight(w)).to(x.dtype).reshape(b, t, h, wd, c)
        if need[1]:
            dw = sc.conv3x3_wgrad(x.reshape(b * t, h, wd, c), dy).to(w.dtype)
        return dx, dw, dbias, dgamma, dbeta, dscale, dshift, None, None


def fused_block3d(
    x: torch.Tensor,
    w: torch.Tensor,
    bias: torch.Tensor,
    gamma: torch.Tensor,
    beta: torch.Tensor,
    scale: Optional[torch.Tensor] = None,
    shift: Optional[torch.Tensor] = None,
    groups: int = 8,
    eps: float = 1e-5,
) -> torch.Tensor:
    """x (B, T, H, W, C); w (Co, C, 3, 3) OIHW, cast to x's dtype; bias,
    gamma, beta (Co,); scale, shift (B, Co) or None (= 0). Returns
    (B, T, H, W, Co) in x's dtype; differentiable in all seven tensors."""
    b, co = x.shape[0], w.shape[0]
    if x.ndim != 5 or co % groups:
        raise ValueError(f"fused_block3d: x {tuple(x.shape)}, Co={co}, G={groups}")
    if gamma.shape != (co,) or beta.shape != (co,):
        raise ValueError("fused_block3d: gamma and beta must be (Co,)")
    for v in (scale, shift):
        if v is not None and v.shape != (b, co):
            raise ValueError("fused_block3d: scale and shift must be (B, Co)")
    inputs = (x, w, bias, gamma, beta, scale, shift)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _FusedBlock3D.apply(*inputs, groups, eps)
    return _forward(*inputs, groups, eps)[0]
