"""UNet3D building blocks (port of dalle2_video_tpu/models/layers.py).

Layout (B, T, H, W, C) at every public call. Every conv is space-only, run
as ``F.conv2d`` over the folded (B*T) batch on a channels_last view, so the
JAX layout costs no transpose.

Module and parameter names follow the flax tree (``to_q``, ``null_kv``,
``project.Conv_0``, ``norm.LayerNorm_0`` ...), so ``weights.params_from_jax``
maps the JAX parameters across by name. The ``impl`` knob strings are the
JAX package's: ``"xla"`` is the plain PyTorch path; ``"pallas"`` and
``"fused"`` (Block3D norm), ``"pallas_small"`` (SpatialConv) and ``"flash"``
(attention) are the hand-written CUDA kernels;
``"auto"`` picks flash on CUDA from 4096 joint tokens and the plain path
below, as the JAX rule does.

Initialisers are the JAX package's: Dense and conv kernels U(+-1/sqrt(fan_in))
(``torch_kernel_init``), zero biases, N(0, 1) learned null embeddings, the
ICNR upsample, and (in ``unet3d.py``) the zero output conv.

The kernel paths are differentiable: ``groupnorm_film_silu``,
``mqa_attention`` and ``fused_block3d`` run their backward kernels under
autograd, ``conv3x3_spatial_xbwd`` the plain conv's backward. The
cross-attention kernel is forward-only (training uses ``impl="xla"``). The
plain attention paths compute in the activation dtype, as the JAX package's
do.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle2_video_tpu_torch.ops.cross_attention import (
    cross_attention,
    cross_attention_reference,
    softmax_as_jax,
)
from dalle2_video_tpu_torch.ops.flash_mqa import mqa_attention
from dalle2_video_tpu_torch.ops.fused_block import fused_block3d
from dalle2_video_tpu_torch.ops.groupnorm_film import (
    groupnorm_film_reference,
    groupnorm_film_silu,
)
from dalle2_video_tpu_torch.ops.spatial_conv import conv3x3_spatial_xbwd
from dalle2_video_tpu_torch.ops.video import resize_video

FLASH_MIN_TOKENS = 4096  # "auto" threshold (JAX layers.py:538-544)


def l2norm(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(eps)


def kernel_init_(weight: torch.Tensor, fan_in: int) -> None:
    """U(+-1/sqrt(fan_in)): the JAX package's ``torch_kernel_init``
    (variance_scaling(1/3, fan_in, uniform))."""
    bound = 1.0 / math.sqrt(fan_in)
    with torch.no_grad():
        weight.uniform_(-bound, bound)


class Dense(nn.Linear):
    """nn.Linear that casts its input to the parameter dtype (the bf16
    sampling copy of a module takes f32 conditioning inputs); JAX init."""

    def reset_parameters(self) -> None:
        kernel_init_(self.weight, self.in_features)
        if self.bias is not None:
            nn.init.zeros_(self.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.linear(x.to(self.weight.dtype), self.weight, self.bias)


class LayerNorm(nn.LayerNorm):
    """flax nn.LayerNorm (eps 1e-6 by default); casts input to param dtype."""

    def __init__(self, dim: int, eps: float = 1e-6, bias: bool = True):
        super().__init__(dim, eps=eps, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.to(self.weight.dtype))


class ScaleOnlyLayerNorm(nn.Module):
    """dalle2-pytorch LayerNorm: learned scale, no bias, eps 1e-5."""

    def __init__(self, dim: int):
        super().__init__()
        self.LayerNorm_0 = LayerNorm(dim, eps=1e-5, bias=False)

    def forward(self, x):
        return self.LayerNorm_0(x)


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * -(math.log(10000.0) / (half - 1))
    )
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], dim=-1)


def _same_pads(k: int, stride: int) -> Tuple[int, int]:
    if stride == 1:  # flax "SAME"
        return (k - 1) // 2, k // 2
    return (k - stride) // 2, (k - stride + 1) // 2  # torch-style floor pad


# The opt-in conv paths' site rules, kept verbatim from the JAX package
# (layers.py SpatialConv / Block3D). Their weight bounds come from the TPU's
# VMEM (the packed (12C, 2Co) kernel matrix had to fit beside the A blocks)
# and are kept for parity, so the same sites take the same path on the card;
# revisiting them for Hopper is a performance change of its own.
PALLAS_SMALL_MAX_BYTES = 13 * 1024 * 1024
FUSED_MAX_BYTES = 8 * 1024 * 1024


def _packed_matrix_bytes(c: int, co: int, dtype: torch.dtype) -> int:
    return 12 * c * 2 * co * torch.empty((), dtype=dtype).element_size()


def pallas_small_site(h: int, w: int, c: int, co: int, kernel_size: int,
                      stride: int, dtype: torch.dtype) -> bool:
    """SpatialConv(impl="pallas_small") takes the conv kernel here."""
    return (kernel_size == 3 and stride == 1 and h * w <= 256 and w % 2 == 0
            and c % 64 == 0 and co % 64 == 0
            and _packed_matrix_bytes(c, co, dtype) <= PALLAS_SMALL_MAX_BYTES)


def fused_site(w: int, c: int, co: int, groups: int, dtype: torch.dtype) -> bool:
    """Block3D(norm_impl="fused") takes the fused block here."""
    return (w % 2 == 0 and co % groups == 0 and c % 64 == 0 and co % 64 == 0
            and _packed_matrix_bytes(c, co, dtype) <= FUSED_MAX_BYTES)


class SpatialConv(nn.Module):
    """Space-only (1, k, k) video conv as a 2D conv over the folded B*T.

    impl "pallas_small" runs qualifying 3x3 sites (``pallas_small_site``)
    through the conv kernel (ops/spatial_conv.py) with the plain conv's
    backward, adding the bias after it in the promoted dtype, as the JAX
    path does; every other site is the plain conv. Same parameters."""

    def __init__(self, in_features: int, features: int, kernel_size: int = 3,
                 stride: int = 1, bias: bool = True, impl: str = "xla",
                 zero_init: bool = False):
        super().__init__()
        if impl not in ("xla", "pallas_small"):
            raise NotImplementedError(f"SpatialConv impl {impl!r} is not ported yet")
        self.impl = impl
        self.kernel_size = kernel_size
        self.features = features
        self.stride = stride
        self.pads = _same_pads(kernel_size, stride)
        self.Conv_0 = nn.Conv2d(in_features, features, kernel_size, stride,
                                padding=0, bias=bias)
        if zero_init:
            nn.init.zeros_(self.Conv_0.weight)
        else:
            kernel_init_(self.Conv_0.weight, in_features * kernel_size * kernel_size)
        if bias:
            nn.init.zeros_(self.Conv_0.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, h, w, c = x.shape
        conv = self.Conv_0
        if self.impl == "pallas_small":
            # the JAX path promotes x, kernel and bias to one dtype
            dt = torch.promote_types(x.dtype, conv.weight.dtype)
            if conv.bias is not None:
                dt = torch.promote_types(dt, conv.bias.dtype)
            if pallas_small_site(h, w, c, self.features, self.kernel_size, self.stride, dt):
                y = conv3x3_spatial_xbwd(x.reshape(b * t, h, w, c).to(dt), conv.weight.to(dt))
                if conv.bias is not None:
                    y = y + conv.bias.to(dt)
                return y.reshape(b, t, h, w, self.features)
        y = x.reshape(b * t, h, w, c).permute(0, 3, 1, 2).to(conv.weight.dtype)
        lo, hi = self.pads
        if lo == hi:
            y = F.conv2d(y, conv.weight, conv.bias, self.stride, padding=lo)
        else:
            y = F.conv2d(F.pad(y, (lo, hi, lo, hi)), conv.weight, conv.bias, self.stride)
        y = y.permute(0, 2, 3, 1)
        return y.reshape(b, t, y.shape[1], y.shape[2], self.features)


class Block3D(nn.Module):
    """conv(1,3,3) -> GroupNorm -> FiLM scale/shift -> SiLU.

    norm_impl "pallas" runs the GroupNorm tail through the fused CUDA kernel
    (ops/groupnorm_film.py); "xla" uses the same math in plain PyTorch;
    "fused" runs the whole block -- conv, bias, statistics, normalise, FiLM,
    SiLU -- through ops/fused_block.py at qualifying sites (``fused_site``)
    and elsewhere falls back to ``SpatialConv(conv_impl)`` and the plain
    GroupNorm, as the JAX block does. Same parameters on every path."""

    def __init__(self, dim_in: int, dim_out: int, groups: int = 8,
                 norm_impl: str = "xla", conv_impl: str = "xla"):
        super().__init__()
        if norm_impl not in ("xla", "pallas", "fused"):
            raise NotImplementedError(f"Block3D norm_impl {norm_impl!r} is not ported yet")
        self.groups = groups
        self.norm_impl = norm_impl
        self.dim_out = dim_out
        self.project = SpatialConv(dim_in, dim_out, 3, impl=conv_impl)
        self.norm = nn.GroupNorm(groups, dim_out, eps=1e-5)  # holds scale/bias

    def forward(self, x, scale_shift=None):
        b, t, h, w, c = x.shape
        if self.norm_impl == "fused" and fused_site(w, c, self.dim_out, self.groups, x.dtype):
            conv = self.project.Conv_0
            scale, shift = scale_shift if scale_shift is not None else (None, None)
            return fused_block3d(x, conv.weight, conv.bias, self.norm.weight, self.norm.bias,
                                 scale, shift, self.groups, 1e-5)
        x = self.project(x)
        b, t, h, w, c = x.shape
        scale, shift = scale_shift if scale_shift is not None else (None, None)
        fn = groupnorm_film_silu if self.norm_impl == "pallas" else groupnorm_film_reference
        y = fn(x.reshape(b, t * h * w, c), self.norm.weight, self.norm.bias,
               scale, shift, self.groups, 1e-5)
        return y.reshape(b, t, h, w, c)


class CrossAttention(nn.Module):
    """Token cross-attention with a learned null kv; impl "flash" runs the
    tiny-context CUDA kernel (ops/cross_attention.py)."""

    def __init__(self, dim: int, context_dim: int, heads: int = 8,
                 dim_head: int = 64, cosine_sim: bool = False,
                 cosine_sim_scale: float = 16.0, impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "flash"):
            raise NotImplementedError(f"CrossAttention impl {impl!r} is not ported yet")
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.cosine_sim, self.cosine_sim_scale = cosine_sim, cosine_sim_scale
        self.impl = impl
        self.norm = ScaleOnlyLayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(context_dim, 2 * inner, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = ScaleOnlyLayerNorm(dim)

    def forward(self, x, context):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q = self.to_q(self.norm(x)).reshape(b, n, h, d)
        k, v = self.to_kv(context).chunk(2, dim=-1)
        k = k.reshape(b, -1, h, d)
        v = v.reshape(b, -1, h, d)
        nk = self.null_kv[0].to(k.dtype).expand(b, 1, h, d)
        nv = self.null_kv[1].to(v.dtype).expand(b, 1, h, d)
        k = torch.cat([nk, k], dim=1)
        v = torch.cat([nv, v], dim=1)
        if self.cosine_sim:
            q, k = l2norm(q), l2norm(k)
            scale = self.cosine_sim_scale
        else:
            scale = d**-0.5
        if self.impl == "flash":
            out = cross_attention(q, k, v, sm_scale=scale)
        else:
            out = cross_attention_reference(q, k, v, scale)
        out = self.to_out(out.reshape(b, n, h * d))
        return self.out_norm(out)


def rotary_embed(x: torch.Tensor, rot_dim: Optional[int] = None) -> torch.Tensor:
    """Rotary embedding on (..., n, d): the first min(32, d) dims rotated as
    interleaved pairs, theta 10000 (rotary-embedding-torch 'lang')."""
    n, d = x.shape[-2], x.shape[-1]
    rd = min(32, d) if rot_dim is None else rot_dim
    half = rd // 2
    inv_freq = 1.0 / (10000.0 ** (
        torch.arange(0, rd, 2, dtype=torch.float32, device=x.device) / rd))
    pos = torch.arange(n, dtype=torch.float32, device=x.device)
    angles = pos[:, None] * inv_freq[None, :]
    shape = (1,) * (x.ndim - 2) + (n, half)
    cos, sin = torch.cos(angles).reshape(shape), torch.sin(angles).reshape(shape)
    xr, x_pass = x[..., :rd].float(), x[..., rd:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    rot = torch.stack([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    rot = rot.reshape(x.shape[:-1] + (rd,))
    return torch.cat([rot.to(x.dtype), x_pass], dim=-1)


class Attention(nn.Module):
    """Multi-query self-attention (one shared kv head) with a learned null
    kv; causal / rotary / additive attn_bias for the prior. impl "flash"
    runs the CUDA flash-MQA kernel when there is no mask, bias or causality."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64,
                 causal: bool = False, cosine_sim: bool = False,
                 cosine_sim_scale: float = 16.0, rotary: bool = False,
                 impl: str = "xla"):
        super().__init__()
        inner = heads * dim_head
        self.heads, self.dim_head = heads, dim_head
        self.causal, self.rotary = causal, rotary
        self.cosine_sim, self.cosine_sim_scale = cosine_sim, cosine_sim_scale
        self.impl = impl
        self.norm = ScaleOnlyLayerNorm(dim)
        self.to_q = Dense(dim, inner, bias=False)
        self.to_kv = Dense(dim, 2 * dim_head, bias=False)
        self.null_kv = nn.Parameter(torch.randn(2, dim_head))
        self.to_out = Dense(inner, dim, bias=False)
        self.out_norm = ScaleOnlyLayerNorm(dim)

    def forward(self, x, attn_bias=None, impl: Optional[str] = None):
        impl = self.impl if impl is None else impl
        if impl not in ("xla", "flash"):
            raise NotImplementedError(f"Attention impl {impl!r} is not ported yet")
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        x_in = self.norm(x)
        q = self.to_q(x_in).reshape(b, n, h, d)
        k, v = self.to_kv(x_in).chunk(2, dim=-1)
        if self.rotary:
            q = rotary_embed(q.transpose(1, 2)).transpose(1, 2)
            k = rotary_embed(k)
        nk = self.null_kv[0].to(k.dtype).expand(b, 1, d)
        nv = self.null_kv[1].to(v.dtype).expand(b, 1, d)
        if self.cosine_sim:
            q, k, nk = l2norm(q), l2norm(k), l2norm(nk)
            scale = self.cosine_sim_scale
        else:
            scale = d**-0.5
        k = torch.cat([nk, k], dim=1)
        v = torch.cat([nv, v], dim=1)
        if impl == "flash" and not self.causal and attn_bias is None:
            out = mqa_attention(q, k, v, sm_scale=scale)
        else:
            # in the activation dtype, as the JAX package (bf16 GEMMs
            # accumulate in f32 and round their result)
            sim = torch.einsum("bnhd,bmd->bhnm", q * scale, k)
            if attn_bias is not None:
                # bias covers the real tokens; the null kv column gets zero
                sim = sim + F.pad(attn_bias.float(), (1, 0))[None]
            if self.causal:
                i = torch.arange(n, device=x.device)[:, None]
                j = torch.arange(n + 1, device=x.device)[None, :]
                sim = sim.masked_fill(~(j <= i + 1), torch.finfo(sim.dtype).min)
            attn = softmax_as_jax(sim, dim=-1)
            out = torch.einsum("bhnm,bmd->bnhd", attn, v.to(attn.dtype)).to(q.dtype)
        out = self.to_out(out.reshape(b, n, h * d))
        return self.out_norm(out)


class JointSpaceTimeAttention(nn.Module):
    """Flatten (t, h, w) into one token axis, attend jointly, residual."""

    def __init__(self, dim: int, heads: int = 16, dim_head: int = 32,
                 cosine_sim: bool = False, joint_time: bool = True,
                 impl: str = "xla"):
        super().__init__()
        if impl not in ("xla", "flash", "auto"):
            raise NotImplementedError(f"attention impl {impl!r} is not ported yet")
        self.joint_time = joint_time
        self.impl = impl
        self.attn = Attention(dim, heads=heads, dim_head=dim_head,
                              cosine_sim=cosine_sim)

    def forward(self, x):
        b, t, h, w, c = x.shape
        tokens = x.reshape(b, t * h * w, c) if self.joint_time else x.reshape(b * t, h * w, c)
        impl = self.impl
        if impl == "auto":
            impl = ("flash" if tokens.shape[1] >= FLASH_MIN_TOKENS and x.is_cuda
                    else "xla")
        out = self.attn(tokens, impl=impl)
        return x + out.reshape(b, t, h, w, c)


class ResnetBlock3D(nn.Module):
    """Two Block3Ds + FiLM time conditioning + optional cross-attention over
    the flattened (t h w) tokens + residual 1x1 conv."""

    def __init__(self, dim_in: int, dim_out: int, cond_dim: Optional[int] = None,
                 time_cond_dim: Optional[int] = None, groups: int = 8,
                 cosine_sim_cross_attn: bool = False, norm_impl: str = "xla",
                 attn_impl: str = "xla", conv_impl: str = "xla"):
        super().__init__()
        self.time_mlp = Dense(time_cond_dim, dim_out * 2) if time_cond_dim else None
        self.block1 = Block3D(dim_in, dim_out, groups, norm_impl, conv_impl)
        self.cross_attn = (
            CrossAttention(dim_out, cond_dim, cosine_sim=cosine_sim_cross_attn,
                           impl=attn_impl)
            if cond_dim is not None else None
        )
        self.block2 = Block3D(dim_out, dim_out, groups, norm_impl, conv_impl)
        self.res_conv = SpatialConv(dim_in, dim_out, 1) if dim_in != dim_out else None

    def forward(self, x, time_emb=None, cond=None):
        scale_shift = None
        if self.time_mlp is not None and time_emb is not None:
            te = self.time_mlp(F.silu(time_emb))
            scale_shift = te.chunk(2, dim=-1)
        h = self.block1(x, scale_shift)
        if self.cross_attn is not None:
            if cond is None:
                raise ValueError("cross-attention block requires cond tokens")
            b, t, hh, ww, c = h.shape
            tokens = h.reshape(b, t * hh * ww, c)
            tokens = self.cross_attn(tokens, cond) + tokens
            h = tokens.reshape(b, t, hh, ww, c)
        h = self.block2(h)
        if self.res_conv is not None:
            x = self.res_conv(x)
        return h + x


class Downsample3D(nn.Module):
    """2x2 stride-2 conv (the pixel-unshuffle + 1x1 conv of the reference)."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.conv = SpatialConv(dim_in, dim_out, 2, stride=2)

    def forward(self, x):
        return self.conv(x)


class PixelShuffleUpsample3D(nn.Module):
    """1x1 conv to 4x channels -> SiLU -> frame-wise pixel shuffle with the
    (c, s1, s2) channel order. Params as the JAX module: ``conv``
    (C, 4*dim_out) and ``conv_bias`` (4*dim_out,). Run as one stride-2
    conv_transpose, whose (C, dim_out, 2, 2) weight is a plain reshape of
    ``conv``; the per-subpixel bias is added on the shuffled output."""

    def __init__(self, dim_in: int, dim_out: int):
        super().__init__()
        self.dim_out = dim_out
        w = torch.empty(dim_in, dim_out)
        kernel_init_(w, dim_in)
        # ICNR: the four subpixels of each output channel start identical
        self.conv = nn.Parameter(w.repeat_interleave(4, dim=1).contiguous())
        self.conv_bias = nn.Parameter(torch.zeros(dim_out * 4))

    def forward(self, x):
        b, t, h, w, c = x.shape
        co = self.dim_out
        weight = self.conv.reshape(c, co, 2, 2)
        y = F.conv_transpose2d(
            x.reshape(b * t, h, w, c).permute(0, 3, 1, 2).to(weight.dtype),
            weight, stride=2,
        ).permute(0, 2, 3, 1)  # (bt, 2h, 2w, co)
        bias = self.conv_bias.reshape(co, 2, 2).permute(1, 2, 0)  # (s1, s2, co)
        y = y.reshape(b * t, h, 2, w, 2, co) + bias[None, None, :, None, :, :]
        return F.silu(y).reshape(b, t, 2 * h, 2 * w, co)


class CrossEmbedLayer3D(nn.Module):
    """Multi-scale stem: parallel space-only convs, channel concat."""

    def __init__(self, dim_in: int, dim_out: int,
                 kernel_sizes: Sequence[int] = (3, 7, 15), stride: int = 1):
        super().__init__()
        if not all((k % 2) == (stride % 2) for k in kernel_sizes):
            raise ValueError("kernel sizes must share the stride's parity")
        ksizes = sorted(kernel_sizes)
        dim_scales = [dim_out // (2**i) for i in range(1, len(ksizes))]
        dim_scales = [*dim_scales, dim_out - sum(dim_scales)]
        self.n = len(ksizes)
        for i, (k, d) in enumerate(zip(ksizes, dim_scales)):
            self.add_module(f"conv{i}", SpatialConv(dim_in, d, k, stride=stride))

    def forward(self, x):
        return torch.cat([getattr(self, f"conv{i}")(x) for i in range(self.n)], dim=-1)


class UpsampleCombiner(nn.Module):
    """Optionally combine the up-path fmaps at the final resolution."""

    def __init__(self, dim: int, fmap_dims: Sequence[int], enabled: bool = False):
        super().__init__()
        self.enabled = enabled and len(fmap_dims) > 0
        self.n = len(fmap_dims) if self.enabled else 0
        for i, fd in enumerate(fmap_dims[: self.n]):
            self.add_module(f"fmap_block{i}", Block3D(fd, dim))

    def forward(self, x, fmaps: List[torch.Tensor]):
        if not self.enabled or not fmaps:
            return x
        target = x.shape[2]
        outs = [getattr(self, f"fmap_block{i}")(resize_video(f, target))
                for i, f in enumerate(fmaps)]
        return torch.cat([x, *outs], dim=-1)


class TimeConditioning(nn.Module):
    """time -> (time_tokens, time_cond)."""

    def __init__(self, dim: int, cond_dim: int, time_cond_dim: int,
                 num_time_tokens: int = 2):
        super().__init__()
        self.dim, self.cond_dim, self.num_time_tokens = dim, cond_dim, num_time_tokens
        self.to_hiddens = Dense(dim, time_cond_dim)
        self.to_tokens = Dense(time_cond_dim, cond_dim * num_time_tokens)
        self.to_cond = Dense(time_cond_dim, time_cond_dim)

    def forward(self, time):
        hiddens = F.gelu(self.to_hiddens(sinusoidal_pos_emb(time, self.dim)))
        tokens = self.to_tokens(hiddens).reshape(
            hiddens.shape[0], self.num_time_tokens, self.cond_dim)
        return tokens, self.to_cond(hiddens)
