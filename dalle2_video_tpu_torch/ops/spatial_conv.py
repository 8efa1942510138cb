"""3x3 SAME stride-1 spatial convolution, forward and weight gradient (port
of dalle2_video_tpu/ops/pallas/spatial_conv.py).

Layout: x (N, H, W, C) channels-last -- the port's (B*T, H, W, C) activation
view -- and the weight as ``nn.Conv2d`` holds it, OIHW (Co, C, 3, 3). The
TPU kernel's pixel-pair packed layout and its (12C, 2Co) matrix fill
128-lane vectors at C = 64; the CUDA kernels need neither.

For a CUDA tensor ``conv3x3`` launches the implicit-GEMM kernel in
``csrc/conv3x3.cu`` (output in the input dtype, f32 accumulation; the dx of
a conv is the same kernel on the flipped, transposed weight) and
``conv3x3_wgrad`` the split-K weight-gradient kernel in
``csrc/conv3x3_wgrad.cu`` (f32 dW). For a CPU tensor each uses its plain
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

import torch
import torch.nn.functional as F

from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    forbid_grad,
    require_cuda,
    stream_ptr,
)

KERNEL = CudaKernel(
    name="conv3x3",
    source="conv3x3.cu",
    symbol="d2v_conv3x3",
    argtypes=[ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/spatial_conv.py:122",
)
WGRAD_KERNEL = CudaKernel(
    name="conv3x3_wgrad",
    source="conv3x3_wgrad.cu",
    symbol="d2v_conv3x3_wgrad",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="dalle2_video_tpu/ops/pallas/spatial_conv.py:172",
)
CIN_MULTIPLE = 32    # kBK16 in csrc/conv3x3.cu: input channels per staged slice
COUT_MULTIPLE = 64   # kBN: output channels per block
WGRAD_MULTIPLE = 64  # csrc/conv3x3_wgrad.cu tiles (tap, 64 channels) x 64
_WGRAD_PIXELS = 64   # kBP16 there: pixels per bf16 step
_WGRAD_TARGET_BLOCKS = 8 * 132  # ~8 split-K blocks per H100 SM


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
    _require_conv_inputs("conv3x3", [x, wk], c, co, CIN_MULTIPLE, COUT_MULTIPLE)
    y = torch.empty((n, h, wd, co), device=x.device, dtype=x.dtype)
    KERNEL.launch(x.data_ptr(), wk.data_ptr(), y.data_ptr(), n, h, wd, c, co,
                  dtype_code(x.dtype), stream_ptr(x.device))
    return y


def wgrad_splits(n_pixels: int, c: int, co: int) -> int:
    """Split-K count: enough (tap, C tile, Co tile, split) blocks for ~8 a
    SM, each split at least one K step of pixels."""
    tiles = 9 * (c // WGRAD_MULTIPLE) * (co // WGRAD_MULTIPLE)
    steps = -(-n_pixels // _WGRAD_PIXELS)
    return max(1, min(-(-_WGRAD_TARGET_BLOCKS // tiles), steps))


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
    n_split = wgrad_splits(n * h * wd, c, co)
    dw = torch.empty((9, c, co), device=x.device, dtype=torch.float32)
    partial = torch.empty((n_split, 9 * c, co), device=x.device, dtype=torch.float32)
    WGRAD_KERNEL.launch(x.data_ptr(), dy.data_ptr(), dw.data_ptr(), partial.data_ptr(),
                        n, h, wd, c, co, n_split, dtype_code(x.dtype), stream_ptr(x.device))
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
