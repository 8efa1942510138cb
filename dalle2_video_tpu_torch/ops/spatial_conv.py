"""3x3 SAME stride-1 spatial convolution, forward and weight gradient (port
of dalle2_video_tpu/ops/pallas/spatial_conv.py).

Layout: x (N, H, W, C) channels-last -- the port's (B*T, H, W, C) activation
view -- and the weight as ``nn.Conv2d`` holds it, OIHW (Co, C, 3, 3). The
TPU kernel's pixel-pair packed layout and its (12C, 2Co) matrix fill
128-lane vectors at C = 64; the CUDA kernels need neither.

For a CUDA tensor ``conv3x3`` launches the implicit-GEMM kernel in
``csrc/conv3x3.cu`` (output in the input dtype, f32 accumulation; bf16 on
the tensor cores with persistent blocks over halo'd tiles, planned by
``conv_plan``; the dx of a conv is the same kernel on the flipped,
transposed weight) and
``conv3x3_wgrad`` the split-K weight-gradient kernel in
``csrc/conv3x3_wgrad.cu`` (f32 dW; bf16 on the tensor cores, all nine taps
from one staged tile, planned by ``wgrad_plan``). For a CPU tensor each uses its plain
version (``conv3x3_reference``, ``conv3x3_wgrad_reference``: ``F.conv2d``
and ``torch.nn.grad.conv2d_weight`` on f32 copies, rounded as the kernel
rounds). There is no other path: a CUDA tensor the kernel does not take
raises.

Two differentiable entry points, as the JAX module has:
  * ``conv3x3_spatial``: kernel forward, kernel dx, kernel dW (the JAX
    ``conv3x3_packed`` custom_vjp);
  * ``conv3x3_spatial_xbwd``: kernel forward, the plain conv's backward
    (the JAX one sends it to XLA; here ``aten.convolution_backward``, which
    is cuDNN on the card). ``SpatialConv(impl="pallas_small")`` runs this.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    forbid_grad,
    require_cuda,
    stream_ptr,
)

# The conv kernel's plan (``conv_plan``), owned here and built into
# csrc/conv3x3.cu as its -D macros: input channels per staged slice (C
# must be a multiple), output channels per block (Co must be a multiple),
# output pixels per bf16 tile (8 warps of 64), the widest column segment,
# the most staged pixels a tile may take (its two-stage ring, 130 KB
# beside 90 KB of weights, holds one block per SM), and the f32 kernel's
# pixels per block (the statistics' tile there).
CONV_BK = 32
CONV_BN = 64
CONV_TILE = 512
CONV_SEG = 64
CONV_STAGED = 832
CONV_F32_TILE = 64
_CONV_SMS = 132  # blocks per wave: one per H100 SM
CONV_DEFINES = {"D2V_CONV_BK": CONV_BK, "D2V_CONV_BN": CONV_BN, "D2V_CONV_TILE": CONV_TILE,
                "D2V_CONV_SEG": CONV_SEG, "D2V_CONV_STAGED": CONV_STAGED,
                "D2V_CONV_F32_TILE": CONV_F32_TILE}
KERNEL = CudaKernel(
    name="conv3x3",
    source="conv3x3.cu",
    symbol="d2v_conv3x3",
    argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 11 + [ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/spatial_conv.py:122",
    defines=CONV_DEFINES,
)
# The bf16 weight gradient's plan (``wgrad_plan``), owned here: the widest
# staged row segment and the most staged pixels a group may take, built
# into csrc/conv3x3_wgrad.cu as its -D macros (its shared-memory ring,
# 158 KB at these, holds one block per SM); blocks per wave (one per H100
# SM); and the longest f32 sum a split may run, in pixels.
WGRAD_SEG = 64
WGRAD_MAX_K = 208
_WGRAD_TC_BLOCKS = 132
WGRAD_CHAIN = 6272
WGRAD_KERNEL = CudaKernel(
    name="conv3x3_wgrad",
    source="conv3x3_wgrad.cu",
    symbol="d2v_conv3x3_wgrad",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + [ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/spatial_conv.py:172",
    defines={"D2V_WGRAD_SEG": WGRAD_SEG, "D2V_WGRAD_MAX_K": WGRAD_MAX_K},
)
WGRAD_MULTIPLE = 64  # csrc/conv3x3_wgrad.cu tiles 64 channels x 64
_WGRAD_PIXELS = 64   # f32: the least pixels a split takes
_WGRAD_TARGET_BLOCKS = 8 * 132  # f32: ~8 split-K blocks per H100 SM


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def kernel_weight(w: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """OIHW (Co, C, 3, 3) -> the kernels' (9, Co, C): tap-major, each output
    channel's input channels contiguous."""
    co, c = w.shape[:2]
    return w.to(dtype).permute(2, 3, 0, 1).reshape(9, co, c).contiguous()


def transposed_weight(w: torch.Tensor) -> torch.Tensor:
    """The weight whose conv is the adjoint: flipped in (kh, kw), (C, Co)
    swapped (the JAX ``_conv_vjp_bwd``'s w_t), OIHW (C, Co, 3, 3)."""
    return w.flip(2, 3).transpose(0, 1)


def _math_dtype(dtype: torch.dtype) -> torch.dtype:
    """f32 for the kernels' dtypes; f64 copies stay f64 (an exact oracle)."""
    return torch.promote_types(dtype, torch.float32)


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Plain version: the conv of f32 copies (w first cast to x's dtype, as
    the kernel takes it), rounded once to x's dtype."""
    m = _math_dtype(x.dtype)
    wf = w.to(x.dtype).to(m)
    return F.conv2d(_nchw(x.to(m)), wf, padding=1).permute(0, 2, 3, 1).to(x.dtype)


def conv3x3_wgrad_reference(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Plain weight gradient: sum over (n, h, w) of each 3x3 patch of x
    times dy, on f32 copies of dy cast to x's dtype (f64 copies stay f64).
    Returns OIHW in that math dtype."""
    m = _math_dtype(x.dtype)
    shape = (dy.shape[3], x.shape[3], 3, 3)
    return torch.nn.grad.conv2d_weight(_nchw(x.to(m)), shape,
                                       _nchw(dy.to(x.dtype).to(m)), padding=1)


def _check(name: str, x: torch.Tensor, c: int) -> None:
    if x.ndim != 4 or x.shape[3] != c:
        raise ValueError(f"{name}: x must be (N, H, W, {c}), got {tuple(x.shape)}")


def _require_conv_inputs(name, tensors, c, co, c_mult, co_mult):
    require_cuda(name, tensors, (torch.float32, torch.bfloat16))
    if len({t.dtype for t in tensors}) != 1:
        raise ValueError(f"{name}: inputs must share a dtype")
    if c % c_mult or co % co_mult:
        raise ValueError(f"{name}: kernel takes C % {c_mult} == 0 and Co % {co_mult} == 0, "
                         f"got C={c}, Co={co}")


class ConvPlan(NamedTuple):
    """The bf16 conv kernel's plan: a tile is ``frames`` x ``rows`` x ``seg``
    output pixels; ``tiles_per_row`` tiles per batch row; ``blocks``
    persistent blocks (a multiple of Co / CONV_BN)."""
    frames: int
    rows: int
    seg: int
    tiles_per_row: int
    blocks: int


def _conv_tile(t: int, h: int, w: int, limit: int) -> Tuple[int, int, int]:
    """(frames, rows, seg) of a tile of at most ``limit`` pixels: whole rows
    of a segment of at most ``CONV_SEG`` columns, whole frames where a frame
    is smaller than the tile, its staged pixels (each frame with one halo
    row above and below and a one-pixel border: F (R + 2) (seg + 2)) within
    ``CONV_STAGED``."""
    seg = min(w, CONV_SEG)
    rows = max(1, min(h, limit // seg))
    frames = max(1, min(t, limit // (rows * seg))) if (rows, seg) == (h, w) else 1
    while frames * (rows + 2) * (seg + 2) > CONV_STAGED:
        if frames > 1:
            frames = max(1, CONV_STAGED // ((rows + 2) * (seg + 2)))
        else:
            rows -= 1
    return frames, rows, seg


def conv_plan(n: int, h: int, w: int, c: int, co: int, batch: int = 1) -> ConvPlan:
    """Tile the (N = batch x T frames, H, W) output for the bf16 kernel: a
    tile never straddles two batch rows; each of the Co / CONV_BN channel
    tiles gets the same number of blocks, one wave of ``_CONV_SMS`` in all
    at most, each walking an equal run of tiles. The tile is the one of
    CONV_TILE, 1/2, 1/4, 1/8 of it whose run costs least (the smallest on
    a tie: more SMs load their tiles at once), a tile costing its pixels,
    at least half a full tile's (below that its warps -- 64 pixels each,
    the rest sit out -- no longer share an SM's four tensor-core
    partitions, so they run no faster), plus an eighth of a full tile for
    its epilogue: a problem too small to give every SM full tiles takes
    smaller ones."""
    del c  # the plan does not depend on it: C is walked in slices
    t = n // batch
    n_co = co // CONV_BN
    best = None
    for limit in (CONV_TILE, CONV_TILE // 2, CONV_TILE // 4, CONV_TILE // 8):
        frames, rows, seg = _conv_tile(t, h, w, limit)
        tiles_per_row = -(-t // frames) * -(-h // rows) * -(-w // seg)
        tiles = batch * tiles_per_row
        per_co = max(1, min(tiles, _CONV_SMS // n_co))
        runs = -(-tiles // per_co)
        cost = runs * (max(frames * rows * seg, CONV_TILE // 2) + CONV_TILE // 8)
        if best is None or cost <= best[0]:
            per_co = -(-tiles // runs)  # equal runs
            best = (cost, ConvPlan(frames, rows, seg, tiles_per_row, n_co * per_co))
    return best[1]


def plan_args(x: torch.Tensor, co: int, batch: int = 1) -> Tuple[int, ...]:
    """The kernel's plan arguments (frames, rows, seg, tiles_per_row,
    blocks) for x (N, H, W, C). f32 takes only tiles_per_row (the
    statistics partials' tiles per batch row): its blocks of
    ``CONV_F32_TILE`` pixels."""
    n, h, w, c = x.shape
    if x.dtype == torch.bfloat16:
        return tuple(conv_plan(n, h, w, c, co, batch))
    return (0, 0, 0, -(-(n // batch) * h * w // CONV_F32_TILE), 0)


def conv3x3(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C), w (Co, C, 3, 3) -> y (N, H, W, Co) in x's dtype.
    Not differentiable: see ``conv3x3_spatial``."""
    if w.ndim != 4 or w.shape[2:] != (3, 3):
        raise ValueError(f"conv3x3: w must be (Co, C, 3, 3), got {tuple(w.shape)}")
    co, c = w.shape[:2]
    _check("conv3x3", x, c)
    if x.device.type == "cpu":
        return conv3x3_reference(x, w)
    forbid_grad("conv3x3", [x, w], "conv3x3_spatial is the differentiable entry point")
    n, h, wd, _ = x.shape
    wk = kernel_weight(w, x.dtype)
    _require_conv_inputs("conv3x3", [x, wk], c, co, CONV_BK, CONV_BN)
    y = torch.empty((n, h, wd, co), device=x.device, dtype=x.dtype)
    KERNEL.launch(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, wd, c, co,
                  *plan_args(x, co), dtype_code(x.dtype), stream_ptr(x.device))
    return y


def wgrad_splits(n_pixels: int, c: int, co: int) -> int:
    """f32 split-K count: enough (tap, C tile, Co tile, split) blocks for
    ~8 a SM, each split at least ``_WGRAD_PIXELS`` pixels."""
    tiles = 9 * (c // WGRAD_MULTIPLE) * (co // WGRAD_MULTIPLE)
    steps = -(-n_pixels // _WGRAD_PIXELS)
    return max(1, min(-(-_WGRAD_TARGET_BLOCKS // tiles), steps))


def wgrad_plan(n: int, h: int, w: int, c: int, co: int) -> Tuple[int, int, int, int]:
    """The bf16 kernel's plan: (rows, seg, groups, n_split). A group is
    ``rows`` image rows of one frame over a ``seg``-column segment, staged
    at a pitch of seg + 2 pixels within ``WGRAD_MAX_K`` of them; the
    groups are split into ``n_split`` runs of whole groups, none over
    ``WGRAD_CHAIN`` pixels, with the (tile, split) blocks filling whole
    waves of one block per SM."""
    seg = min(w, WGRAD_SEG)
    rows = max(1, min(h, WGRAD_MAX_K // (seg + 2)))
    groups = n * -(-h // rows) * -(-w // seg)
    tiles = (c // WGRAD_MULTIPLE) * (co // WGRAD_MULTIPLE)
    least = -(-groups // max(1, WGRAD_CHAIN // (rows * seg)))
    waves = -(-tiles * least // _WGRAD_TC_BLOCKS)
    n_split = min(groups, max(least, waves * _WGRAD_TC_BLOCKS // tiles))
    return rows, seg, groups, n_split


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """dW (Co, C, 3, 3) f32 of the conv of x (N, H, W, C) given dy = dL/dy
    (N, H, W, Co); dy is taken in x's dtype."""
    if dy.ndim != 4 or x.ndim != 4 or dy.shape[:3] != x.shape[:3]:
        raise ValueError(f"conv3x3_wgrad: x {tuple(x.shape)} and dy {tuple(dy.shape)} disagree")
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, dy)
    forbid_grad("conv3x3_wgrad", [x, dy], "no double backward")
    n, h, wd, c = x.shape
    co = dy.shape[3]
    dy = dy.to(x.dtype).contiguous()
    _require_conv_inputs("conv3x3_wgrad", [x, dy], c, co, WGRAD_MULTIPLE, WGRAD_MULTIPLE)
    if x.dtype == torch.bfloat16:
        rows, seg, _, n_split = wgrad_plan(n, h, wd, c, co)
    else:
        rows = seg = 0
        n_split = wgrad_splits(n * h * wd, c, co)
    dw = torch.empty((9, c, co), device=x.device, dtype=torch.float32)
    partial = torch.empty((n_split, 9 * c, co), device=x.device, dtype=torch.float32)
    WGRAD_KERNEL.launch(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partial.data_ptr(),
                        n, h, wd, c, co, n_split, rows, seg, dtype_code(x.dtype),
                        stream_ptr(x.device))
    return dw.reshape(3, 3, c, co).permute(3, 2, 0, 1)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return conv3x3(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.to(x.dtype).contiguous()
        dx = conv3x3(g, transposed_weight(w)) if ctx.needs_input_grad[0] else None
        dw = conv3x3_wgrad(x, g).to(w.dtype) if ctx.needs_input_grad[1] else None
        return dx, dw


def _differentiable(fn, x, w):
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return fn.apply(x, w)
    return conv3x3(x, w)


def conv3x3_spatial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C), w OIHW -> (N, H, W, Co): kernel forward, kernel dx
    and dW under autograd."""
    return _differentiable(_Conv3x3, x, w)


@torch.library.custom_op("d2v::conv3x3_xbwd", mutates_args=())
def conv3x3_spatial_xbwd(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (N, H, W, C), w OIHW -> (N, H, W, Co): kernel forward, the plain
    conv's backward (cuDNN on the card) under autograd. A dispatcher op, so
    that the remat policies (models/remat.py) can save its output."""
    return conv3x3(x, w)


@conv3x3_spatial_xbwd.register_fake
def _(x, w):
    return x.new_empty((*x.shape[:3], w.shape[0]))


def _xbwd_setup(ctx, inputs, output):
    ctx.save_for_backward(*inputs)


def _xbwd_backward(ctx, g):
    x, w = ctx.saved_tensors
    need = ctx.needs_input_grad
    dx, dw, _ = torch.ops.aten.convolution_backward(
        _nchw(g.to(x.dtype)), _nchw(x), w.to(x.dtype), None, [1, 1], [1, 1],
        [1, 1], False, [0, 0], 1, [need[0], need[1], False])
    return (dx.permute(0, 2, 3, 1) if need[0] else None,
            dw.to(w.dtype) if need[1] else None)


conv3x3_spatial_xbwd.register_autograd(_xbwd_backward, setup_context=_xbwd_setup)
