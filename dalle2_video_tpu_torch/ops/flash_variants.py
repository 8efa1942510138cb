"""The flash-forward variants of the flash redesign probes (port of
scripts/perf_r3_probe8.py::r2_fwd and scripts/perf_r3_probe9.py::inner_fwd).

Both compute softmax(q k^T) v over one shared kv head, forward only, as the
A/B controls of the flash forward (``ops/flash_mqa.py``):

* ``r2_fwd(q, k, v)`` -- the round-2 form. q arrives scaled by the caller.
  k and v are zero-padded to the tile edge, so a padded column has logit 0
  and enters the running max; after the exponential the padded columns are
  multiplied by a 0/1 mask, and the denominator is an explicit row sum of
  the f32 probabilities, kept as its own state.
* ``inner_fwd(q, k, v, sm_scale=, inner=, merge=)`` -- the fused
  denominator: v is extended by mask-ones columns (1 on a real key, 0 on a
  padded one), so the product P [V | 1] carries the row sum, and each step
  takes ``inner`` kv sub-tiles, either threaded through one running
  (max, acc) (``merge="chain"``) or as independent partials merged at the
  end of the step (``"par"``). The scale is folded into q (in f32, rounded
  to q's dtype) before the kernel, as the JAX wrapper does.

For a CUDA tensor each launches its hand-written kernel
(``csrc/flash_r2.cu``, ``csrc/flash_inner.cu``); for a CPU tensor each runs
its plain version (``r2_fwd_reference``, ``inner_fwd_reference``), which
follows the TPU arithmetic literally: the f32 logits, the running max over
``block_k`` tiles including the zero-padded columns, probabilities rounded
to v's dtype for the second product, the f32 accumulators. There is no
other path. Neither is differentiable: a call that needs a gradient raises.

The wrappers take the JAX signatures: block_q and interpret are ignored;
block_k (default 1024, the probes') is the keys per running-max update and
the zero padding reaches a multiple of it (times ``inner`` for row 11), on
the CPU and in the bf16 kernels alike, so the plain version and the kernel
compute one function. A kernel takes a block_k that is a multiple of its
key tile (``KEY_TILE``). The f32 kernels keep their own 16-key updates: in
f32 the block size changes only the order of f32 roundings.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from dalle2_video_tpu_torch.ops._cuda import (
    CudaKernel,
    dtype_code,
    forbid_grad,
    require_cuda,
    stream_ptr,
)
from dalle2_video_tpu_torch.ops.flash_mqa import KEY_TILE, NEG_INF, row_chunk

R2_KERNEL = CudaKernel(
    name="flash_r2_fwd",
    source="flash_r2.cu",
    symbol="d2v_flash_r2_fwd",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p],
    replaces="scripts/perf_r3_probe8.py:94",
)
INNER_KERNEL = CudaKernel(
    name="flash_inner_fwd",
    source="flash_inner.cu",
    symbol="d2v_flash_inner_fwd",
    argtypes=[ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
    replaces="scripts/perf_r3_probe9.py:124",
)
SUPPORTED_D = (32,)  # the probes' head dim (both JAX probes fix D = 32)
BLOCK_K = 1024  # the probes' block_k
MERGES = ("chain", "par")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _pad_kv(t: torch.Tensor, n: int) -> torch.Tensor:
    return torch.nn.functional.pad(t, (0, 0, 0, n - t.shape[1]))


def r2_fwd_reference(q, k, v, block_k: int = BLOCK_K, work=torch.float32):
    """Plain r2 forward: q (b, n_q, d) already scaled, k/v (b, n_kv, d).
    ``work=torch.float64``: the same function in f64 after the roundings
    (the checks' oracle)."""
    b, n_q, d = q.shape
    n_kv = k.shape[1]
    n_pad = _round_up(n_kv, block_k)
    kp, vp = _pad_kv(k, n_pad).to(work), _pad_kv(v, n_pad)
    mask = (torch.arange(n_pad, device=q.device) < n_kv).to(work)
    out = torch.empty_like(q)
    rows = row_chunk(b, block_k)
    for r0 in range(0, n_q, rows):
        qc = q[:, r0:r0 + rows].to(work)
        m = torch.full(qc.shape[:2] + (1,), NEG_INF, dtype=work, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qc.shape, dtype=work, device=q.device)
        for c0 in range(0, n_pad, block_k):
            s = qc @ kp[:, c0:c0 + block_k].transpose(1, 2)
            m_next = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_next) * mask[c0:c0 + block_k]
            alpha = torch.exp(m - m_next)
            l = l * alpha + p.sum(-1, keepdim=True)
            acc = acc * alpha + p.to(v.dtype).to(work) @ vp[:, c0:c0 + block_k].to(work)
            m = m_next
        out[:, r0:r0 + rows] = (acc / l).to(q.dtype)
    return out


def inner_fwd_reference(q, k, v, *, sm_scale: float, block_k: int = BLOCK_K, inner: int = 2,
                        merge: str = "chain", work=torch.float32):
    """Plain inner-kv forward: scale folded into q, k zero-padded to
    block_k * inner, v extended by its mask-ones column (the JAX v_ext has d
    equal ones columns; one carries the same sum), ``inner`` sub-tiles per
    step merged by ``merge``; out = acc[:, :d] / acc[:, d].
    ``work=torch.float64``: the same function in f64 after the roundings
    (the checks' oracle)."""
    if merge not in MERGES:
        raise ValueError(f"merge {merge!r} not in {MERGES}")
    b, n_q, d = q.shape
    n_kv = k.shape[1]
    qs = (q.float() * sm_scale).to(q.dtype)
    n_pad = _round_up(n_kv, block_k * inner)
    kp = _pad_kv(k, n_pad).to(work)
    ones = (torch.arange(n_pad, device=q.device) < n_kv).to(v.dtype)
    v_ext = torch.cat([_pad_kv(v, n_pad), ones.expand(b, n_pad)[..., None]], dim=-1)

    def sub(qc, c0):
        s = qc @ kp[:, c0:c0 + block_k].transpose(1, 2)
        return s, v_ext[:, c0:c0 + block_k]

    out = torch.empty_like(q)
    rows = row_chunk(b, block_k)
    for r0 in range(0, n_q, rows):
        qc = qs[:, r0:r0 + rows].to(work)
        m = torch.full(qc.shape[:2] + (1,), NEG_INF, dtype=work, device=q.device)
        acc = torch.zeros(qc.shape[:2] + (d + 1,), dtype=work, device=q.device)
        for c0 in range(0, n_pad, block_k * inner):
            starts = range(c0, c0 + block_k * inner, block_k)
            if merge == "chain":
                for j0 in starts:
                    s, ve = sub(qc, j0)
                    m_next = torch.maximum(m, s.amax(-1, keepdim=True))
                    p = torch.exp(s - m_next)
                    acc = acc * torch.exp(m - m_next) + p.to(ve.dtype).to(work) @ ve.to(work)
                    m = m_next
            else:
                parts = []
                for j0 in starts:
                    s, ve = sub(qc, j0)
                    m_j = s.amax(-1, keepdim=True)
                    parts.append((m_j, torch.exp(s - m_j).to(ve.dtype).to(work) @ ve.to(work)))
                for m_j, a_j in parts:
                    m_next = torch.maximum(m, m_j)
                    acc = acc * torch.exp(m - m_next) + a_j * torch.exp(m_j - m_next)
                    m = m_next
        out[:, r0:r0 + rows] = (acc[..., :d] / acc[..., d:]).to(q.dtype)
    return out


def _check(name, q, k, v):
    if q.ndim != 3 or k.ndim != 3 or v.shape != k.shape:
        raise ValueError(f"{name}: bad shapes {q.shape} {k.shape} {v.shape}")
    if k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{name}: q {q.shape} and k {k.shape} disagree")
    forbid_grad(name, [q, k, v], "the probe forwards have no backward")


def _require_kernel_inputs(name, q, k, v, block_k):
    require_cuda(name, [q, k, v], (torch.float32, torch.bfloat16))
    if len({q.dtype, k.dtype, v.dtype}) != 1:
        raise ValueError(f"{name}: q, k, v must share a dtype")
    if q.shape[-1] not in SUPPORTED_D:
        raise ValueError(f"{name}: head dim {q.shape[-1]} not in {SUPPORTED_D}")
    tile = KEY_TILE[q.dtype]  # the bf16 kernels run row 1's mainloop
    if block_k <= 0 or block_k % tile:
        raise ValueError(f"{name}: block_k {block_k} is not a multiple of the kernel's "
                         f"{tile}-key tile")


def r2_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
           block_q: Optional[int] = None, block_k: Optional[int] = None) -> torch.Tensor:
    """q (b, n_q, d) scaled by the caller; k, v (b, n_kv, d). Returns
    (b, n_q, d) in q's dtype."""
    del block_q  # TPU tuning only
    _check("r2_fwd", q, k, v)
    block_k = BLOCK_K if block_k is None else block_k
    if q.device.type == "cpu":
        return r2_fwd_reference(q, k, v, block_k)
    _require_kernel_inputs("r2_fwd", q, k, v, block_k)
    b, n_q, d = q.shape
    out = torch.empty_like(q)
    R2_KERNEL.launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                     b, n_q, k.shape[1], dtype_code(q.dtype), block_k, stream_ptr(q.device))
    return out


def inner_fwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, sm_scale: float,
              block_q: Optional[int] = None, block_k: Optional[int] = None,
              inner: int = 2, merge: str = "chain", interpret: bool = False) -> torch.Tensor:
    """q (b, n_q, d) unscaled; k, v (b, n_kv, d); inner in {2, 4}, merge in
    {"chain", "par"}. Returns (b, n_q, d) in q's dtype."""
    del block_q, interpret  # TPU tuning only
    _check("inner_fwd", q, k, v)
    if inner not in (2, 4) or merge not in MERGES:
        raise ValueError(f"inner_fwd: inner {inner} / merge {merge!r} not in (2, 4) x {MERGES}")
    block_k = BLOCK_K if block_k is None else block_k
    if q.device.type == "cpu":
        return inner_fwd_reference(q, k, v, sm_scale=sm_scale, inner=inner, merge=merge,
                                   block_k=block_k)
    _require_kernel_inputs("inner_fwd", q, k, v, block_k)
    b, n_q, d = q.shape
    qs = (q.float() * sm_scale).to(q.dtype)  # the JAX wrapper's scaled q
    out = torch.empty_like(q)
    INNER_KERNEL.launch(qs.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                        b, n_q, k.shape[1], dtype_code(q.dtype), block_k, inner,
                        MERGES.index(merge), stream_ptr(q.device))
    return out
