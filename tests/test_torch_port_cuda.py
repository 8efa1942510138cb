"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with a reason) where there is no CUDA
device or no nvcc; the decision is made inside the fixture, never at
import. Run on the card with

    python -m pytest -m cuda tests/test_torch_port_cuda.py

Tolerances (forwards): f32 inputs 1e-5, 4e-5 for GroupNorm's sums over up
to 80k values (same math, another summation order). bf16 cross-attention
outputs: |kernel - plain| <= 1e-3 + 1e-2 * |plain|. Both sides end in a
bf16 rounding, one step of which is at most 2^-7 = 7.8e-3 of the value, so
the relative term admits one rounding flip at any magnitude; atol covers
the f32 work before the rounding. The bf16 cross-attention computes the
JAX kernel's function (``fused_cross_attention_reference``: p rounded to
bf16 after an f32 softmax) and is held to it by ``xattn_rows.hold_bf16``:
that tolerance, widened only by what a flip of a probability moves a value
by where its f64 value lies within an f32 rounding of a bf16 midpoint (two
f32 orders may round it either way), at most one bf16 step of the row's
scale besides, at most 0.05% of the values differing and no more than
0.05 points above the plain version's share from the f64 oracle (each
limit floored at one row's d values), two calls bit-equal. The bf16 flash
forwards compute the JAX
kernels' function (probabilities rounded to bf16 against a running max
moved once per block_k keys), so kernel and plain version agree bit for bit
but where a probability sits within an f32 rounding of a bf16 boundary:
at most 0.5% of the outputs may differ, each by one bf16 step (at no less
than its row's largest |output|: a flip moves the whole row by an amount
set by the row's scale); where the keys are many (the flips grow with them)
the share is held instead to an f64 oracle of the same function (the plain
version with work=torch.float64): the kernel may differ from it in at
most 0.25 points more of the values than the plain version does. The bf16
GroupNorm kernels (rows 3, 4 and 9) are held by ``gn_rows.hold_fwd`` /
``hold_bwd``: one bf16 step per value (at no less than 2^-8 of its
channel's largest |value|), a bounded share differing, no further from the
f64 oracle than the plain version plus a margin, the statistics and dA, dB
close to the oracle's -- bounds set from what the kernels before the
one-launch redesign measured. The backward kernels' tolerances sit with
their tests below.
"""

from __future__ import annotations

import math
import shutil

import pytest
import torch

import torch.nn.functional as F

from dalle2_video_tpu_torch.ops import cross_attention as xa
from dalle2_video_tpu_torch.ops import flash_mqa as fm
from dalle2_video_tpu_torch.ops import flash_variants as fv
from dalle2_video_tpu_torch.ops import fused_block as fb
from dalle2_video_tpu_torch.ops import groupnorm_film as gn
from dalle2_video_tpu_torch.ops import spatial_conv as sc
from dalle2_video_tpu_torch.probes import gn_rows
from dalle2_video_tpu_torch.probes.conv_rows import FUSED_SITES, SMALL_SITES
from dalle2_video_tpu_torch.probes.xattn_rows import (
    BATCHES,
    DIM_HEAD,
    HEADS,
    LONG_MS,
    SERVE_SITES,
    TEXT_SITES,
    hold_bf16,
)
from dalle2_video_tpu_torch.utils.device import resolve_device

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None and shutil.which("nvcc") is None:
        pytest.skip("needs nvcc to build the kernels")
    return resolve_device("cuda")  # and the port's f32 policy: no TF32


def _assert_attention_close(out, ref, dtype, bf16_atol):
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(out.float(), ref.float(), atol=bf16_atol, rtol=1e-2)


ORACLE_MARGIN = 0.0025


def _bf16_steps(out, ref):
    """Share of values that differ, and the largest difference in bf16
    steps of the larger value, taken at no less than the row's largest
    |value| (a probability's flip moves every output of its row by an
    amount set by the row's scale, not by the value's own size)."""
    out, ref = out.float(), ref.float()
    differ = out != ref
    if not bool(differ.any()):
        return 0.0, 0.0
    scale = torch.maximum(torch.maximum(out.abs(), ref.abs()), ref.abs().amax(-1, keepdim=True))
    _, e = torch.frexp(scale)
    step = torch.ldexp(torch.ones_like(scale), e - 8)
    return float(differ.float().mean()), float(((out - ref).abs() / step)[differ].max())


def _assert_bf16_flash(out, ref, oracle=None):
    """The bf16 flash forwards (module docstring): one bf16 step per value;
    a share of at most 0.5%, or, given the oracle (on the leading rows),
    no more than ORACLE_MARGIN above the plain version's own share."""
    share, steps = _bf16_steps(out, ref)
    assert torch.isfinite(out.float()).all()
    assert steps <= 1.0, f"a value differs by {steps:.2f} bf16 steps"
    if oracle is None:
        assert share <= 5e-3, f"{share:.3%} of the bf16 outputs differ"
    else:
        rows = oracle.shape[1]
        kern, plain = _bf16_steps(out[:, :rows], oracle)[0], _bf16_steps(ref[:, :rows], oracle)[0]
        assert kern <= plain + ORACLE_MARGIN, f"oracle shares: kernel {kern:.3%}, plain {plain:.3%}"


def _lse_bound(q, k, scale):
    """lse within 1e-4, plus one probability's bf16 flip: 2^-8 / l, l = sum
    exp(s - rowmax) in f64."""
    qs = (q.float() * scale).to(q.dtype).double()
    s = qs @ k.double().transpose(1, 2)
    return 1e-4 + 2.0**-8 / torch.exp(s - s.amax(-1, keepdim=True)).sum(-1)


def _flash_bf16_case(dev, b, n_q, n_kv, seed, block_k=None, oracle=False, bf16_atol=None):
    """Row 1 in bf16 against its plain version (and the f64 oracle on 256
    rows) at block_k (default the JAX auto rule's), two calls, the lse
    within ``_lse_bound``; with bf16_atol, also |out - plain| <= bf16_atol
    + 1e-2 |plain|."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q, k, v = (torch.randn(b, n, 32, generator=g, device=dev).to(torch.bfloat16)
               for n in (n_q, n_kv, n_kv))
    sc = 32**-0.5
    before = fm.KERNEL.launches
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=True, block_k=block_k)
    torch.cuda.synchronize()
    assert fm.KERNEL.launches == before + 1
    again = fm.flash_mqa_fwd(q, k, v, sm_scale=sc, save_lse=True, block_k=block_k)
    assert torch.equal(again[0], out) and torch.equal(again[1], lse)
    ref, ref_lse = fm.flash_mqa_reference(q, k, v, sc, save_lse=True, block_k=block_k)
    orc = (fm.flash_mqa_reference(q[:, :256], k, v, sc, block_k=block_k, work=torch.float64)
           if oracle else None)
    _assert_bf16_flash(out, ref, orc)
    if bf16_atol is not None:
        _assert_attention_close(out, ref, torch.bfloat16, bf16_atol)
    assert ((lse - ref_lse).abs() <= _lse_bound(q, k, sc)).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv", [1, 65, 5761])
def test_flash_kernel_matches_plain(dev, dtype, n_kv):
    if dtype == torch.bfloat16:
        # the bf16 probabilities of the second product: ~2^-8/sqrt(3) *
        # sqrt(sum p^2 v^2) RMS before the rounding, about 2.3e-3 * sqrt(e /
        # n_kv) for logits ~ N(0, 1); five of those, clipped to [5e-4, 2.5e-3]
        bf16_atol = min(2.5e-3, max(5e-4, 1.15e-2 * math.sqrt(math.e / n_kv)))
        _flash_bf16_case(dev, 2, 333, n_kv, seed=n_kv, oracle=n_kv > 3000, bf16_atol=bf16_atol)
        return
    g = torch.Generator(device=dev).manual_seed(n_kv)
    q, k, v = (torch.randn(2, n, 32, generator=g, device=dev) for n in (333, n_kv, n_kv))
    before = fm.KERNEL.launches
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)
    torch.cuda.synchronize()
    assert fm.KERNEL.launches == before + 1
    ref, ref_lse = fm.flash_mqa_reference(q, k, v, 32**-0.5, save_lse=True)
    torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.parametrize("n_kv,block_k", [(300, 512), (1100, 512), (515, 1024), (3000, 1024),
                                          (2500, 2048), (5761, 1024), (23041, 2048)])
def test_flash_kernel_bf16_at_the_jax_block_sizes(dev, n_kv, block_k):
    """block_k 512 / 1024 / 2048, ragged tails, n_kv < block_k: the JAX
    kernel's roundings and running max on the card."""
    _flash_bf16_case(dev, 2, 1000, n_kv, seed=n_kv + block_k, block_k=block_k,
                     oracle=n_kv > 3000)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_logits_below_minus_87(dev, dtype):
    q = torch.full((1, 8, 16), 16.0, device=dev)
    k = torch.full((1, 37, 16), -2.0, device=dev) + 0.1 * torch.randn(1, 37, 16, device=dev)
    v = torch.randn(1, 37, 16, device=dev)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    out = fm.flash_mqa_fwd(q, k, v, sm_scale=0.25)
    assert torch.isfinite(out.float()).all()
    ref = fm.flash_mqa_reference(q, k, v, 0.25)
    if dtype == torch.bfloat16:
        _assert_bf16_flash(out, ref)
    else:
        # logits near -124 (base-2: -179) carry f32 spacing ~1.5e-5, so the
        # kernel's exp2 and the plain exp differ by ~1e-4 relative here
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=2e-4)


def test_flash_kernels_refuse_block_k_off_their_tile(dev):
    x = torch.zeros(1, 8, 32, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="128-key tile"):
        fm.flash_mqa_fwd(x, x, x, block_k=64)
    with pytest.raises(ValueError, match="128-key tile"):
        fv.inner_fwd(x, x, x, sm_scale=1.0, block_k=960)
    with pytest.raises(ValueError, match="128-key tile"):
        fv.r2_fwd(x, x, x, block_k=192)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,l", [(8, 40000), (64, 777), (512, 90), (128, 4097)])
def test_groupnorm_kernel_matches_plain(dev, dtype, c, l):
    g = torch.Generator(device=dev).manual_seed(c)
    x = (torch.randn(2, l, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gamma = torch.randn(c, generator=g, device=dev).to(dtype)
    beta = torch.randn(c, generator=g, device=dev).to(dtype)
    scale = (0.1 * torch.randn(2, c, generator=g, device=dev)).to(dtype)
    shift = (0.1 * torch.randn(2, c, generator=g, device=dev)).to(dtype)
    out, mean, rstd = gn.groupnorm_film_silu(x, gamma, beta, scale, shift, 8,
                                             return_stats=True)
    ref, rmean, rrstd = gn.groupnorm_film_reference(x, gamma, beta, scale, shift, 8, 1e-5,
                                                    return_stats=True)
    atol = 4e-5 if dtype == torch.float32 else 8e-2
    torch.testing.assert_close(out.float(), ref.float(), atol=atol, rtol=0)
    if dtype == torch.bfloat16:  # one bf16 step, the share, the oracle, the statistics
        gn_rows.hold_fwd(gn_rows.measure_fwd(
            lambda *a: gn.groupnorm_film_silu(*a, 1e-5, return_stats=True), gn,
            x, gamma, beta, scale, shift, 8))
    torch.testing.assert_close(mean, rmean, atol=1e-4, rtol=0)
    torch.testing.assert_close(rstd, rrstd, atol=1e-4, rtol=1e-4)
    # the sums are folded in a fixed order (no atomics): two calls agree
    again = gn.groupnorm_film_silu(x, gamma, beta, scale, shift, 8, return_stats=True)
    assert all(torch.equal(a, b) for a, b in zip((out, mean, rstd), again))


def test_groupnorm_kernels_hold_at_every_mapped_shape(dev):
    """Rows 3, 4 and 9 at every (batch, shape) the paths give them
    (gn_rows.all_shapes, the map), held by gn_rows' hold on
    well-conditioned inputs, and at MEAN30_SHAPES on inputs of mean 30;
    one launch a call."""
    for name in (gn_rows.FWD, gn_rows.BWD, gn_rows.ROW9):
        if name == gn_rows.FWD:
            entry = gn.KERNEL
            run = lambda *a: gn.groupnorm_film_silu(*a, 1e-5, return_stats=True)  # noqa: E731
            draw, measure, hold = gn_rows.inputs, gn_rows.measure_fwd, gn_rows.hold_fwd
        else:
            entry = gn.BWD_KERNEL if name == gn_rows.BWD else fb.GN_BWD_KERNEL
            run = lambda *a, _e=entry: gn.groupnorm_film_bwd(*a, kernel=_e)  # noqa: E731
            draw = lambda *a: gn_rows.bwd_inputs(gn, *a)  # noqa: E731
            measure, hold = gn_rows.measure_bwd, lambda m, *_: gn_rows.hold_bwd(m)
        for b, l, c, groups in gn_rows.all_shapes()[name]:
            before = entry.launches
            m = measure(run, gn, *draw(dev, b, l, c), groups)
            assert entry.launches == before + 2  # measure calls it twice
            hold(m)
            if (b, l, c) in gn_rows.MEAN30_SHAPES:
                hold(measure(run, gn, *draw(dev, b, l, c, "mean30"), groups), "mean30", (b, l, c))
            torch.cuda.empty_cache()


def test_groupnorm_kernel_clamps_a_near_constant_group(dev):
    """One-pass statistics of a (near-)constant group cancel: the kernel
    clamps E[x^2] - mean^2 at 0 before eps (the JAX kernel does not; the
    plain version clamps as the kernel does), so a constant group (of ones:
    every sum exact) gives rstd = rsqrt(eps) and y = silu(Bv), and a group
    of 100s with one 100.5 in a thousand stays finite with rstd at most
    rsqrt(eps) -- where the f64 oracle finds ~45."""
    g = torch.Generator(device=dev).manual_seed(3)
    b, l, c = 2, 90 * 64 * 64, 64
    x = torch.randn(b, l, c, generator=g, device=dev)
    x[..., :8] = 1.0  # group 0: constant
    flip = torch.rand(b, l, 8, generator=g, device=dev) < 1e-3
    x[..., 8:16] = torch.where(flip, 100.5, 100.0)  # group 1: near-constant
    x = x.to(torch.bfloat16)
    gamma, beta = torch.ones(c, device=dev), 0.1 * torch.ones(c, device=dev)
    y, mean, rstd = gn.groupnorm_film_silu(x, gamma, beta, None, None, 8, return_stats=True)
    cap = 1e-5**-0.5
    assert torch.isfinite(y).all() and torch.isfinite(rstd).all()
    torch.testing.assert_close(rstd[:, :8], torch.full_like(rstd[:, :8], cap), rtol=1e-6, atol=0)
    assert torch.equal(mean[:, :8], torch.ones_like(mean[:, :8]))
    silu_b = F.silu(torch.full_like(y[..., :8], 0.1).float())  # Bv = bf16(0.1)
    torch.testing.assert_close(y[..., :8].float(), silu_b, atol=0, rtol=2**-7)  # one step
    assert float(rstd[:, 8:16].max()) <= cap * (1 + 1e-6)


def _cross_attention_case(dev, dtype, b, n, h, d, m, seed):
    """Row 5 against ``fused_cross_attention_reference``: f32 within 1e-5;
    bf16 held by ``xattn_rows.hold_bf16`` (module docstring); one launch a
    call, two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn(b, n, h, d, generator=g, device=dev).to(dtype)
    k, v = (torch.randn(b, m, h, d, generator=g, device=dev).to(dtype) for _ in range(2))
    sc = d**-0.5
    before = xa.KERNEL.launches
    out = xa.cross_attention(q, k, v, sm_scale=sc)
    torch.cuda.synchronize()
    assert xa.KERNEL.launches == before + 1
    assert torch.equal(out, xa.cross_attention(q, k, v, sm_scale=sc))
    ref = xa.fused_cross_attention_reference(q, k, v, sc)
    if dtype == torch.float32:
        _assert_attention_close(out, ref, dtype, bf16_atol=None)
    else:
        assert torch.isfinite(out.float()).all()
        hold_bf16(out, ref, q, k, v, sc)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,h,n", [(64, 8, 1000), (32, 1, 777), (64, 1, 333), (32, 8, 1025)])
@pytest.mark.parametrize("m", [1, 3, 7, 8, 9, 16])  # the edges of the n8 key tiles
def test_cross_attention_kernel_matches_plain(dev, dtype, d, h, n, m):
    _cross_attention_case(dev, dtype, 2, n, h, d, m, seed=m + n)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("unet,n,m,sites", SERVE_SITES)
def test_cross_attention_kernel_at_the_serve_shapes(dev, unet, n, m, sites, batch):
    """Every (batch, shape) the serving paths give row 5
    (probes/xattn_rows.py), bf16."""
    _cross_attention_case(dev, torch.bfloat16, batch, n, HEADS, DIM_HEAD, m, seed=n + m + batch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", LONG_MS)
def test_cross_attention_kernel_over_long_contexts(dev, dtype, m):
    """Row 5 past the short route's 16 keys: per-frame video tokens (93),
    text tokens at the middle blocks (259, 263, 349), the tile edges (16,
    17, 32, 33) and two staged chunks (1000), bf16 and f32, at d 64 and 32,
    with a ragged tail of tokens."""
    for d, h, n in ((64, 8, 1000), (32, 2, 333)):
        _cross_attention_case(dev, dtype, 2, n, h, d, m, seed=m + n)


@pytest.mark.parametrize("batch", BATCHES)
@pytest.mark.parametrize("unet,n,m,sites", [s for s in TEXT_SITES if s[2] > 16])
def test_cross_attention_kernel_at_the_serve_text_shapes(dev, unet, n, m, sites, batch):
    """Every (batch, shape) past 16 keys that serving with text encodings
    and per-frame embeds gives row 5 (probes/xattn_rows.py::TEXT_SITES; the
    rest are the serving shapes above), bf16."""
    _cross_attention_case(dev, torch.bfloat16, batch, n, HEADS, DIM_HEAD, m, seed=n + m + batch)


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(2, 8, 32, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fm.flash_mqa_fwd(x, x, x)  # fp16: not a kernel dtype
    # 17 keys, one past the short route, take the long-context route (no
    # refusal and no plain version for a CUDA tensor)
    g = torch.Generator(device=dev).manual_seed(17)
    q, k, v = (torch.randn(1, n, 8, 64, generator=g, device=dev) for n in (4, 17, 17))
    before = xa.KERNEL.launches
    out = xa.cross_attention(q, k, v, sm_scale=0.125)
    assert xa.KERNEL.launches == before + 1
    _assert_attention_close(out, xa.fused_cross_attention_reference(q, k, v, 0.125),
                            torch.float32, bf16_atol=None)
    q16 = torch.zeros(1, 4, 8, 16, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head dim"):
        xa.cross_attention(q16, q16[:, :3], q16[:, :3], sm_scale=1.0)
    with pytest.raises(ValueError):
        gn.groupnorm_film_silu(torch.zeros(1, 4, 24, device=dev), torch.ones(24, device=dev),
                               torch.zeros(24, device=dev), groups=8)


# ------------------------------------------------------ backward kernels
# f32: the same f32 math as the plain version, summed in another order over
# up to a few thousand terms: 2e-5 of the call's largest gradient value.
# bf16: both sides round the f32 result once (rtol 1e-2 = one flip), atol
# 1e-3 of the largest value for the f32 sums near zero (the chip_smoke.py
# form). The scale is the call's, not each output's: at n_kv = 1 the
# softmax is constant, dq and dk are exactly 0 and both sides return f32
# residue of dP - delta there.
def _assert_grads_close(outs, refs, dtype):
    scale = max(float(r.float().abs().max()) for r in refs)
    for o, r in zip(outs, refs):
        if dtype == torch.float32:
            torch.testing.assert_close(o, r, atol=2e-5 * scale, rtol=0)
        else:
            torch.testing.assert_close(o.float(), r.float(), atol=1e-3 * scale, rtol=1e-2)


def _bwd_route(dtype, b):
    """The JAX package's bwd_impl "auto" (fm.bwd_rounds): bf16 at batch >= 2
    on the tensor cores (_bwd_pallas's roundings), else f32 math."""
    return "tensor_cores" if dtype == torch.bfloat16 and b >= 2 else "cuda_cores"


def _flash_bwd_launch(q, k, v, out, lse, go, scale, route):
    """The kernel once, on the route given; then bit for bit on a second
    call (the query-split partials are summed in a fixed order)."""
    before = (fm.BWD_KERNEL.launches, dict(fm.BWD_KERNEL.routes))
    got = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=scale)
    torch.cuda.synchronize()
    assert fm.BWD_KERNEL.launches == before[0] + 1
    assert fm.BWD_KERNEL.routes.get(route, 0) == before[1].get(route, 0) + 1
    assert all(t.dtype == q.dtype for t in got)
    again = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b", [1, 2, 4])
@pytest.mark.parametrize("n_q,n_kv", [(333, 1), (333, 65), (1000, 4097), (1000, 5761)])
def test_flash_bwd_kernel_matches_plain(dev, dtype, b, n_q, n_kv):
    """Every route against the plain version at the same route's arithmetic
    (n_q never a multiple of the 64-row tile, n_kv never of the 64-key
    tile or the 128-key block)."""
    g = torch.Generator(device=dev).manual_seed(n_kv + b)
    q, go = (torch.randn(b, n_q, 32, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(b, n_kv, 32, generator=g, device=dev).to(dtype) for _ in range(2))
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)
    got = _flash_bwd_launch(q, k, v, out, lse, go, 32**-0.5, _bwd_route(dtype, b))
    _assert_grads_close(got, fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 32**-0.5), dtype)


def test_flash_bwd_kernel_at_the_curve_sr_shape_batch_1(dev):
    """The curve recipe's SR unet (train/train_curve.py) trains at batch 1:
    its joint attention at the 64 x 16 x 16 bottleneck, 16 heads of 32, q
    (1, 262144, 32) against kv (1, 16385, 32), in bf16. Its forward keeps
    the f32 forward's exact lse (fwd_residuals), and the backward takes the
    CUDA cores; both held to the plain versions, the forward's lse and out
    in f32 and the out on a slice of query rows."""
    g = torch.Generator(device=dev).manual_seed(16385)
    n = 64 * 16 * 16
    q, go = (torch.randn(1, 16 * n, 32, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(1, n + 1, 32, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fm.fwd_residuals(q, k, v, sm_scale=32**-0.5)
    rows = slice(0, 8192)
    _, ref_lse = fm.flash_mqa_reference(q[:, rows].float(), k.float(), v.float(), 32**-0.5,
                                        save_lse=True)
    torch.testing.assert_close(lse[:, rows], ref_lse, atol=1e-4, rtol=0)
    _assert_grads_close([out[:, rows]], [fm.flash_mqa_reference(q[:, rows], k, v, 32**-0.5)],
                        torch.bfloat16)
    got = _flash_bwd_launch(q, k, v, out, lse, go, 32**-0.5, "cuda_cores")
    _assert_grads_close(got, fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 32**-0.5),
                        torch.bfloat16)


@pytest.mark.parametrize("dtype,b", [(torch.bfloat16, 2), (torch.float32, 2),
                                     (torch.bfloat16, 1)])
def test_flash_bwd_kernel_logits_below_minus_87(dev, dtype, b):
    """Every real logit below -87 and a ragged n_kv = 37 (d = 16): a key
    past n_kv never forms a p, so the gradients stay finite and follow the
    plain version on each route. Logits near -128 carry f32 spacing ~8e-6,
    so exp2 against exp moves P by ~1e-4 relative: f32 within 2e-4 of the
    largest value; bf16 the standing tolerance."""
    g = torch.Generator(device=dev).manual_seed(21)
    q = torch.full((b, 8, 16), 16.0, device=dev).to(dtype)
    k = (torch.full((b, 37, 16), -2.0, device=dev)
         + 0.1 * torch.randn(b, 37, 16, generator=g, device=dev)).to(dtype)
    v, go = (torch.randn(b, n, 16, generator=g, device=dev).to(dtype) for n in (37, 8))
    assert float(((q.float() * 0.25) @ k.float().transpose(1, 2)).max()) < -87.0
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=0.25, save_lse=True)
    got = _flash_bwd_launch(q, k, v, out, lse, go, 0.25, _bwd_route(dtype, b))
    want = fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 0.25)
    assert all(torch.isfinite(t).all() for t in got)
    if dtype == torch.float32:
        scale = max(float(r.abs().max()) for r in want)
        for o, r in zip(got, want):
            torch.testing.assert_close(o, r, atol=2e-4 * scale, rtol=0)
    else:
        _assert_grads_close(got, want, dtype)


def test_flash_autograd_on_cuda_matches_plain_autograd(dev):
    """Gradients reach q, k, v through the Function (no silent drop)."""
    g = torch.Generator(device=dev).manual_seed(3)
    q = torch.randn(2, 200, 32, generator=g, device=dev, requires_grad=True)
    k = torch.randn(2, 77, 32, generator=g, device=dev, requires_grad=True)
    v = torch.randn(2, 77, 32, generator=g, device=dev, requires_grad=True)
    go = torch.randn(2, 200, 32, generator=g, device=dev)
    got = torch.autograd.grad(fm.flash_mqa(q, k, v, sm_scale=0.2), (q, k, v), go)
    s = torch.einsum("bnd,bmd->bnm", q * 0.2, k)
    want = torch.autograd.grad(torch.softmax(s, -1) @ v, (q, k, v), go)
    _assert_grads_close(got, want, torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,l", [(8, 40000), (64, 777), (512, 90), (128, 4097)])
def test_groupnorm_bwd_kernel_matches_plain(dev, dtype, c, l):
    g = torch.Generator(device=dev).manual_seed(c + 1)
    x = (torch.randn(2, l, c, generator=g, device=dev) * 2 + 0.5).to(dtype)
    gy = torch.randn(2, l, c, generator=g, device=dev).to(dtype)
    gamma, beta = (torch.randn(c, generator=g, device=dev).to(dtype) for _ in range(2))
    scale, shift = ((0.1 * torch.randn(2, c, generator=g, device=dev)).to(dtype) for _ in range(2))
    _, mean, rstd = gn.groupnorm_film_silu(x, gamma, beta, scale, shift, 8, return_stats=True)
    a_vec, b_vec = gn.fold_ab(gamma, beta, scale, shift, dtype, 2)
    before = gn.BWD_KERNEL.launches
    got = gn.groupnorm_film_bwd(x, gy, a_vec, b_vec, mean, rstd, 8)
    torch.cuda.synchronize()
    assert gn.BWD_KERNEL.launches == before + 1
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    _assert_grads_close(got, gn.groupnorm_film_bwd_reference(x, gy, a_vec, b_vec, mean, rstd, 8),
                        dtype)
    again = gn.groupnorm_film_bwd(x, gy, a_vec, b_vec, mean, rstd, 8)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.bfloat16:
        gn_rows.hold_bwd(gn_rows.measure_bwd(gn.groupnorm_film_bwd, gn, x, gy, a_vec, b_vec,
                                             mean, rstd, 8))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,l,c", [(2, 90 * 64 * 64, 64), (4, 90 * 16 * 16, 256), (2, 777, 128)])
def test_fused_block_gn_bwd_kernel_bit_for_bit_twice(dev, dtype, b, l, c):
    """Row 9 (row 4's kernel under the fused block's counter) on the conv
    output with the fused forward's statistics: within the backward
    tolerance of the plain version, and two calls bit-equal."""
    g = torch.Generator(device=dev).manual_seed(l + c)
    y = (torch.randn(b, l, c, generator=g, device=dev) * 2 + 0.3).to(dtype)
    gy = torch.randn(b, l, c, generator=g, device=dev).to(dtype)
    gamma, beta = 1 + 0.1 * torch.randn(c, generator=g, device=dev), 0.1 * torch.randn(
        c, generator=g, device=dev)
    s_, t_ = (0.1 * torch.randn(b, c, generator=g, device=dev) for _ in range(2))
    mean, rstd = fb.stats_to_mean_rstd(y.float().sum(1), (y.float() ** 2).sum(1), 8,
                                       l * c // 8, 1e-5)
    args = (y, gy, *fb.fold_ab(gamma, beta, s_, t_, b), mean, rstd, 8)
    before = fb.GN_BWD_KERNEL.launches
    got = gn.groupnorm_film_bwd(*args, kernel=fb.GN_BWD_KERNEL)
    torch.cuda.synchronize()
    assert fb.GN_BWD_KERNEL.launches == before + 1
    _assert_grads_close(got, gn.groupnorm_film_bwd_reference(*args), dtype)
    again = gn.groupnorm_film_bwd(*args, kernel=fb.GN_BWD_KERNEL)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    if dtype == torch.bfloat16:
        gn_rows.hold_bwd(gn_rows.measure_bwd(
            lambda *a: gn.groupnorm_film_bwd(*a, kernel=fb.GN_BWD_KERNEL), gn, *args))


@pytest.mark.parametrize("film", [True, False])
def test_groupnorm_autograd_on_cuda_gives_every_gradient(dev, film):
    """All five gradients with FiLM, three without (scale / shift None, as
    in a ResnetBlock3D's second block)."""
    g = torch.Generator(device=dev).manual_seed(5)
    ins = [torch.randn(2, 300, 64, generator=g, device=dev),
           1 + 0.1 * torch.randn(64, generator=g, device=dev),
           0.1 * torch.randn(64, generator=g, device=dev),
           0.1 * torch.randn(2, 64, generator=g, device=dev),
           0.1 * torch.randn(2, 64, generator=g, device=dev)]
    ins = [t.requires_grad_() for t in ins[:5 if film else 3]]
    args = ins + [None] * (5 - len(ins))
    gy = torch.randn(2, 300, 64, generator=g, device=dev)
    got = torch.autograd.grad(gn.groupnorm_film_silu(*args, groups=8), ins, gy)
    want = torch.autograd.grad(gn.groupnorm_film_reference(*args, 8, 1e-5), ins, gy)
    _assert_grads_close(got, want, torch.float32)


def test_cross_attention_raises_under_grad_on_cuda(dev):
    q = torch.zeros(1, 4, 8, 64, device=dev, requires_grad=True)
    k = torch.zeros(1, 3, 8, 64, device=dev)
    with pytest.raises(RuntimeError, match="forward-only"):
        xa.cross_attention(q, k, k, sm_scale=1.0)
    with torch.no_grad():
        assert xa.cross_attention(q, k, k, sm_scale=1.0).shape == q.shape


# ------------------------------------------------------ conv-path kernels
# f32: the same f32 products summed in another order (9 C terms per output,
# up to ~2000 pixels per weight gradient): 2e-5 of the call's largest
# value. bf16: both sides round one f32 result (rtol 1e-2 = one flip), atol
# 1e-3 of the largest value for the f32 sums near zero. The weight gradient
# is f32 from bf16 inputs: no rounding, so 1e-4 of its largest value.
CONV_CASES = [(3, 16, 16, 64, 128), (2, 8, 8, 512, 512), (5, 7, 9, 32, 64),
              (1, 4, 160, 64, 64),  # Co != C, the deep 8x8, odd H/W, a wide row
              (3, 6, 20, 192, 64), (2, 16, 16, 384, 128)]  # frames narrower than a
# segment, several to a tile; C = 192 and 384, whose weights stream through the ring
# The fused Block3D sites' (H, W, C, Co) at the celebv_text recipe (unet 1's
# nine, unet 2's four; chip_smoke.py records what reaches the kernels). Row
# 8 runs each at the paths' B*T frames; row 6 each one's dx (H, W, Co ->
# C), and the pallas_small forward at 8 x 8, 512 -> 512.
FUSED = [st for sites in FUSED_SITES.values() for st in sites]
CONV_PATH_SHAPES = sorted({(h, w, co, c) for h, w, c, co in FUSED} | set(SMALL_SITES))


def _conv_inputs(dev, dtype, n, h, w, c, co, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(n, h, w, c, generator=g, device=dev).to(dtype)
    wt = (torch.randn(co, c, 3, 3, generator=g, device=dev) / math.sqrt(9 * c)).to(dtype)
    return g, x, wt


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,co", CONV_CASES)
def test_conv3x3_kernel_matches_plain(dev, dtype, n, h, w, c, co):
    _, x, wt = _conv_inputs(dev, dtype, n, h, w, c, co, n * h + c)
    before = sc.KERNEL.launches
    out = sc.conv3x3(x, wt)
    torch.cuda.synchronize()
    assert sc.KERNEL.launches == before + 1 and out.dtype == dtype
    _assert_grads_close([out], [sc.conv3x3_reference(x, wt)], dtype)
    assert torch.equal(out, sc.conv3x3(x, wt))


@pytest.mark.parametrize("h,w,c,co", CONV_PATH_SHAPES)
def test_conv3x3_kernel_at_the_conv_paths_shapes(dev, h, w, c, co):
    """Row 6 (bf16) at every shape the conv paths give it, B*T = 180: the
    standing tolerance of the plain version and two bit-equal calls."""
    _, x, wt = _conv_inputs(dev, torch.bfloat16, 180, h, w, c, co, h + c + co)
    out = sc.conv3x3(x, wt)
    _assert_grads_close([out], [sc.conv3x3_reference(x, wt)], torch.bfloat16)
    assert torch.equal(out, sc.conv3x3(x, wt))


@pytest.mark.parametrize("batch,t", [(2, 90), (4, 90)])
@pytest.mark.parametrize("h,w,c,co", FUSED)
def test_conv_bias_stats_kernel_at_the_fused_sites(dev, batch, t, h, w, c, co):
    """Row 8 (bf16) at every fused site, at train_conv's and serve_conv's
    batch rows of 90 frames (an 8-frame tile of the 8 x 8 sites ends past a
    row's last frame): y within the standing tolerance, the sums within 1e-5
    of their largest value, and two bit-equal calls."""
    g, x, wt = _conv_inputs(dev, torch.bfloat16, batch * t, h, w, c, co, h + c + co + batch)
    bias = 0.5 * torch.randn(co, generator=g, device=dev)
    got = fb.conv_bias_stats(x, wt, bias, batch)
    want = fb.conv_bias_stats_reference(x, wt, bias, batch)
    _assert_grads_close(got[:1], want[:1], torch.bfloat16)
    for a, b in zip(got[1:], want[1:]):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0)
    assert all(torch.equal(a, b) for a, b in zip(got, fb.conv_bias_stats(x, wt, bias, batch)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,co", [(3, 16, 16, 64, 128), (2, 8, 8, 512, 64),
                                        (7, 9, 10, 64, 64), (2, 6, 20, 128, 512),
                                        (3, 5, 70, 512, 64), (4, 32, 32, 192, 128)])
def test_conv3x3_wgrad_kernel_matches_plain_bit_for_bit_twice(dev, dtype, n, h, w, c, co):
    """Beside the ragged (7, 9, 10): W = 20 and 70, not multiples of 16 (70
    is two row segments of the bf16 kernel), with Co or C = 512; and a
    32-wide frame (a 32-column segment, 6 rows a group, the last group of
    each frame 2 rows) at C = 192, as unet 1's 32 x 32 stage."""
    g, x, _ = _conv_inputs(dev, dtype, n, h, w, c, co, n + c)
    dy = torch.randn(n, h, w, co, generator=g, device=dev).to(dtype)
    before = sc.WGRAD_KERNEL.launches
    got = sc.conv3x3_wgrad(x, dy)
    torch.cuda.synchronize()
    assert sc.WGRAD_KERNEL.launches == before + 1 and got.dtype == torch.float32
    want = sc.conv3x3_wgrad_reference(x, dy)
    torch.testing.assert_close(got, want, atol=1e-4 * float(want.abs().max()), rtol=0)
    # split-K partials summed in a fixed order
    assert torch.equal(got, sc.conv3x3_wgrad(x, dy))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("batch,t,h,w,c,co", [(2, 3, 7, 7, 64, 64), (2, 90, 8, 8, 256, 512),
                                              (3, 2, 16, 16, 128, 64), (2, 5, 6, 20, 192, 128),
                                              (2, 3, 16, 16, 384, 256)])
def test_conv_bias_stats_kernel_matches_plain(dev, dtype, batch, t, h, w, c, co):
    """At 3 x 7 x 7 = 147 pixels per batch row a row ends inside its tile
    (bf16: one tile of three 7 x 7 frames; f32: the third 64-pixel tile):
    tiles are per batch row, so no partial sum straddles two rows; at 5
    frames of 6 x 20 a tile is four frames narrower than a segment, and
    the row's second tile holds one. C = 192 and 384 stream their weights.
    The sums are f32 over the row's f32 values on both sides: 1e-5 of their
    largest value."""
    g, x, wt = _conv_inputs(dev, dtype, batch * t, h, w, c, co, t + c)
    bias = 0.5 * torch.randn(co, generator=g, device=dev)
    before = fb.KERNEL.launches
    y, s, ss = fb.conv_bias_stats(x, wt, bias, batch)
    torch.cuda.synchronize()
    assert fb.KERNEL.launches == before + 1
    ry, rs, rss = fb.conv_bias_stats_reference(x, wt, bias, batch)
    _assert_grads_close([y], [ry], dtype)
    for got, want in ((s, rs), (ss, rss)):
        torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    again = fb.conv_bias_stats(x, wt, bias, batch)
    assert all(torch.equal(a, b) for a, b in zip((y, s, ss), again))


def _plain_block(x, w, bias, gamma, beta, scale, shift, groups):
    """Conv + bias, GroupNorm, FiLM, SiLU in plain f32 PyTorch (autograd)."""
    b, t, h, wd, c = x.shape
    y = F.conv2d(x.reshape(b * t, h, wd, c).permute(0, 3, 1, 2), w, bias, padding=1)
    y = y.permute(0, 2, 3, 1).reshape(b, t * h * wd, -1)
    return gn.groupnorm_film_reference(y, gamma, beta, scale, shift, groups, 1e-5).reshape(
        b, t, h, wd, -1)


@pytest.mark.parametrize("film", [True, False])
def test_fused_block3d_autograd_on_cuda_matches_plain_autograd(dev, film):
    """Forward and all seven gradients of fused_block3d on the card (f32:
    kernel 8 forward; GroupNorm backward, conv dx and weight-gradient
    kernels backward) vs plain f32 autograd, each kernel launched once."""
    g = torch.Generator(device=dev).manual_seed(9)
    b, t, h, wd, c, co = 2, 3, 8, 8, 64, 128
    ins = [torch.randn(b, t, h, wd, c, generator=g, device=dev),
           torch.randn(co, c, 3, 3, generator=g, device=dev) / 24,
           0.3 * torch.randn(co, generator=g, device=dev),
           1 + 0.1 * torch.randn(co, generator=g, device=dev),
           0.1 * torch.randn(co, generator=g, device=dev),
           0.1 * torch.randn(b, co, generator=g, device=dev),
           0.1 * torch.randn(b, co, generator=g, device=dev)]
    ins = [a.requires_grad_() for a in ins[:7 if film else 5]]
    args = ins + [None] * (7 - len(ins))
    gy = torch.randn(b, t, h, wd, co, generator=g, device=dev)
    kernels = (fb.KERNEL, fb.GN_BWD_KERNEL, sc.KERNEL, sc.WGRAD_KERNEL, gn.BWD_KERNEL)
    before = [k.launches for k in kernels]
    out = fb.fused_block3d(*args, groups=8)
    got = torch.autograd.grad(out, ins, gy)
    torch.cuda.synchronize()
    assert [k.launches - n for k, n in zip(kernels, before)] == [1, 1, 1, 1, 0]
    ref = _plain_block(*args, 8)
    want = torch.autograd.grad(ref, ins, gy)
    torch.testing.assert_close(out.detach(), ref.detach(),
                               atol=2e-5 * float(ref.detach().abs().max()), rtol=0)
    _assert_grads_close(got, want, torch.float32)


def test_conv3x3_xbwd_launches_forward_only(dev):
    """pallas_small's conv: kernel forward, the plain conv's backward."""
    _, x, wt = _conv_inputs(dev, torch.float32, 2, 8, 8, 64, 64, 1)
    x, wt = x.requires_grad_(), wt.requires_grad_()
    before = (sc.KERNEL.launches, sc.WGRAD_KERNEL.launches)
    out = sc.conv3x3_spatial_xbwd(x, wt)
    got = torch.autograd.grad(out, (x, wt), torch.ones_like(out))
    torch.cuda.synchronize()
    assert (sc.KERNEL.launches, sc.WGRAD_KERNEL.launches) == (before[0] + 1, before[1])
    want = torch.autograd.grad(F.conv2d(x.permute(0, 3, 1, 2), wt, padding=1).sum(), (x, wt))
    _assert_grads_close(got, want, torch.float32)


def test_conv_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(1, 8, 8, 24, device=dev)
    with pytest.raises(ValueError, match="C % 32"):
        sc.conv3x3(x, torch.zeros(64, 24, 3, 3, device=dev))
    with pytest.raises(ValueError, match="dtype"):  # fp16: not a kernel dtype
        sc.conv3x3(torch.zeros(1, 8, 8, 64, device=dev, dtype=torch.float16),
                   torch.zeros(64, 64, 3, 3, device=dev))


# ------------------------------------ rows 10 and 11: the probes' variants
# Each kernel against its plain version at the same block_k (the probes'
# 1024 in bf16; the f32 kernels keep 16-key updates, which in f32 change
# only the order of roundings, so f32 is held at 1e-5 with block_k 1024).
# bf16: the flash forwards' check (_assert_bf16_flash), the oracle at the
# serving shape; two calls bit-equal.
VARIANTS = [("r2", 0, "")] + [("inner", i, m) for i in (2, 4) for m in fv.MERGES]


def _variant(kind, inner, merge, q, k, v, sc, plain, **kw):
    bk = fv.BLOCK_K
    if kind == "r2":
        qs = (q.float() * sc).to(q.dtype)
        return (fv.r2_fwd_reference(qs, k, v, block_k=bk, **kw) if plain
                else fv.r2_fwd(qs, k, v, block_k=bk))
    if plain:
        return fv.inner_fwd_reference(q, k, v, sm_scale=sc, block_k=bk, inner=inner,
                                      merge=merge, **kw)
    return fv.inner_fwd(q, k, v, sm_scale=sc, block_k=bk, inner=inner, merge=merge)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n_q,n_kv", [(2, 700, 515), (2, 92160, 5761)])
@pytest.mark.parametrize("kind,inner,merge", VARIANTS)
def test_flash_variant_kernel_matches_plain(dev, dtype, b, n_q, n_kv, kind, inner, merge):
    g = torch.Generator(device=dev).manual_seed(n_kv + inner)
    q, k, v = (torch.randn(b, n, 32, generator=g, device=dev).to(dtype)
               for n in (n_q, n_kv, n_kv))
    kernel = fv.R2_KERNEL if kind == "r2" else fv.INNER_KERNEL
    before = kernel.launches
    out = _variant(kind, inner, merge, q, k, v, 32**-0.5, plain=False)
    torch.cuda.synchronize()
    assert kernel.launches == before + 1
    assert torch.equal(out, _variant(kind, inner, merge, q, k, v, 32**-0.5, plain=False))
    ref = _variant(kind, inner, merge, q, k, v, 32**-0.5, plain=True)
    if dtype == torch.float32:
        torch.testing.assert_close(out, ref, atol=1e-5, rtol=0)
        return
    orc = None
    if n_kv > 3000:
        orc = _variant(kind, inner, merge, q[:, :256], k, v, 32**-0.5, plain=True,
                       work=torch.float64)
    _assert_bf16_flash(out, ref, orc)


@pytest.mark.parametrize("block_k", [1024, 2048])
@pytest.mark.parametrize("n_kv", [1, 129, 2049, 5761])
def test_flash_r2_kernel_at_ragged_tails_and_block_k(dev, n_kv, block_k):
    """Row 10 in bf16 on the wgmma mainloop: ragged kv tails (one key, a
    tile and one, a 2,048-key block and one, the serving kv) at the probes'
    block_k and at 2048, against its plain version (the share of differing
    values, or, where the keys are many, the f64 oracle), two calls
    bit-equal."""
    g = torch.Generator(device=dev).manual_seed(n_kv + block_k)
    q, k, v = (torch.randn(2, n, 32, generator=g, device=dev).to(torch.bfloat16)
               for n in (700, n_kv, n_kv))
    qs = (q.float() * 32**-0.5).to(q.dtype)
    out = fv.r2_fwd(qs, k, v, block_k=block_k)
    assert torch.equal(out, fv.r2_fwd(qs, k, v, block_k=block_k))
    ref = fv.r2_fwd_reference(qs, k, v, block_k=block_k)
    orc = None
    if n_kv > 3000:
        orc = fv.r2_fwd_reference(qs, k, v, block_k=block_k, work=torch.float64)
    _assert_bf16_flash(out, ref, orc)


@pytest.mark.parametrize("kind,inner,merge", VARIANTS)
def test_flash_variant_kernel_negative_logits_and_check_small(dev, kind, inner, merge):
    """Every real logit near -5: the zero-padded column holds the running
    max, and the kernel must still give the plain version's (here also the
    exact) answer. Then the probe's check_small geometry in f32 against
    exact softmax, max error < 1e-4 (scripts/perf_r3_probe9.py:162)."""
    g = torch.Generator(device=dev).manual_seed(5)
    q = torch.full((1, 40, 32), 1.0, device=dev)
    k = torch.full((1, 37, 32), -0.88, device=dev) + 0.05 * torch.randn(1, 37, 32, generator=g,
                                                                       device=dev)
    v = torch.randn(1, 37, 32, generator=g, device=dev)
    s = (q * 32**-0.5) @ k.transpose(1, 2)
    assert float(s.max()) < -4.0 and float(s.min()) > -6.0
    out = _variant(kind, inner, merge, q, k, v, 32**-0.5, plain=False)
    torch.testing.assert_close(out, _variant(kind, inner, merge, q, k, v, 32**-0.5, plain=True),
                               atol=1e-5, rtol=0)
    torch.testing.assert_close(out, fm.flash_mqa_reference(q, k, v, 32**-0.5), atol=1e-5, rtol=0)
    q, k, v = (torch.randn(2, n, 32, generator=g, device=dev) for n in (700, 515, 515))
    err = (_variant(kind, inner, merge, q, k, v, 32**-0.5, plain=False)
           - fm.flash_mqa_reference(q, k, v, 32**-0.5)).abs().max()
    assert float(err) < 1e-4


def test_flash_variant_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(2, 8, 32, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fv.r2_fwd(x, x, x)  # fp16: not a kernel dtype
    y = torch.zeros(2, 8, 64, device=dev)
    with pytest.raises(ValueError, match="head dim"):
        fv.inner_fwd(y, y, y, sm_scale=1.0)
    z = torch.zeros(2, 8, 32, device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        fv.r2_fwd(z, z, z)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paired_random_crop_on_cuda_equals_the_cpu(dev, dtype):
    """ops/video.py::paired_random_crop on the card takes the windows it
    takes on the CPU at the same offsets, bit for bit, for the video and
    its low-res conditioning video; drawn offsets stay in range."""
    from dalle2_video_tpu_torch.ops.video import paired_random_crop

    g = torch.Generator().manual_seed(0)
    video = torch.randn(3, 5, 40, 36, 3, generator=g).to(dtype)
    lowres = torch.randn(3, 5, 40, 36, 3, generator=g).to(dtype)
    offsets = (torch.tensor([0, 7, 16]), torch.tensor([12, 0, 5]))
    want = paired_random_crop(video, 24, lowres, offsets=offsets)
    got = paired_random_crop(video.to(dev), 24, lowres.to(dev), offsets=offsets)
    for w, o in zip(want, got):
        assert o.device.type == "cuda" and o.shape == (3, 5, 24, 24, 3)
        assert torch.equal(o.cpu(), w)
    gen = torch.Generator(device=dev).manual_seed(1)
    v, lr = paired_random_crop(video.to(dev), 24, lowres.to(dev), generator=gen)
    assert v.shape == lr.shape == (3, 5, 24, 24, 3)


def _option_decoders(dev, **knobs):
    """A one-stage decoder (dim 16, 4 frames at 32 px, the kernels' impls:
    flash attention, the GroupNorm kernels, xla cross-attention) with its
    output conv redrawn, on the card and, with the same weights, on the CPU,
    where every wrapper runs its kernel's plain version."""
    from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig

    ucfg = UNet3DConfig(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=4,
                        attn_dim_head=32, video_embed_dim=32, attention_impl="flash",
                        groupnorm_impl="pallas", cross_attention_impl="xla")
    cfg = VideoDecoderConfig(unets=(ucfg,), frame_sizes=(32,), frame_numbers=(4,),
                             learned_variance=False, predict_v=True, **knobs)
    torch.manual_seed(0)
    cpu = VideoDecoder(cfg, device="cpu")
    w = cpu.unets[0].to_out.Conv_0.weight
    kernel_init_(w, w[0].numel())
    card = VideoDecoder(cfg, device=dev)
    card.load_state_dict(cpu.state_dict())
    return card, cpu


def _rel_l2(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def test_guided_inpainting_gradient_kernels_match_plain(dev):
    """One reconstruction-guidance step (VDM eq. 7) of a bf16 sampling unet
    at CFG batch 2: the gradient of the known region's x0 error w.r.t. x
    through rows 1 -> 2 (flash, the tensor-core backward) and 3 -> 4
    (GroupNorm) on the card against the same step on the CPU through their
    plain versions. The existing bf16 bounds of chip_smoke.py's module
    checks: x0 within 4e-2 of its scale, the gradient within 0.2 relative
    L2 (GRAD_RTOL), and nonzero."""
    from dalle2_video_tpu_torch.engine.decoder import Inpaint

    card, cpu = _option_decoders(dev, sample_compute_dtype="bfloat16")
    g = torch.Generator().manual_seed(4)
    x = torch.randn(1, 4, 32, 32, 3, generator=g)
    x0k = torch.rand(1, 4, 32, 32, 3, generator=g) * 2 - 1
    mask = torch.zeros(1, 4, 1, 1, 1)
    mask[:, :2] = 1.0
    embed = torch.randn(1, 32, generator=g)
    t = torch.tensor([500])
    outs = []
    for dec, d in ((card, dev), (cpu, torch.device("cpu"))):
        kernels = (fm.KERNEL, fm.BWD_KERNEL, gn.KERNEL, gn.BWD_KERNEL)
        before = [k.launches for k in kernels]
        with torch.no_grad():
            x0, _, grad = dec._recon_grad(
                0, x.to(d), t.to(d), Inpaint(x0k.to(d), mask.to(d), "guided"),
                cond=dict(video_embed=embed.to(d)), cond_scale=3.0, self_cond=None)
        launched = [k.launches - n for k, n in zip(kernels, before)]
        if d.type == "cuda":
            torch.cuda.synchronize()
            assert all(launched), launched  # rows 1, 2, 3, 4
            assert fm.BWD_KERNEL.routes.get("tensor_cores", 0) >= launched[1]
        else:
            assert not any(launched)
        assert all(p.grad is None for p in dec.sampling_unet(0).parameters())
        outs.append((x0.cpu(), grad.cpu()))
    (x0_k, g_k), (x0_p, g_p) = outs
    torch.testing.assert_close(x0_k, x0_p, atol=4e-2 * float(x0_p.abs().max()), rtol=0)
    assert float(g_p.abs().max()) > 0 and torch.isfinite(g_k).all()
    assert _rel_l2(g_k, g_p) <= 0.2, _rel_l2(g_k, g_p)


def test_dpmpp_stage_kernels_match_plain(dev):
    """A DPM++ stage (3 steps, CFG 3.0, with inpainting by replacement) in
    f32 on the card through rows 1 and 3 against the same stage on the CPU
    through their plain versions, from the same x_T and known-region
    noises: 2e-3 on the video in [0, 1], as the CPU tests hold the port to
    the JAX package (the first step's x0 scales the f32 disagreement)."""
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    card, cpu = _option_decoders(dev, sampler="dpmpp", sample_timesteps=(3,))
    g = torch.Generator().manual_seed(5)
    x_t = torch.randn(2, 4, 32, 32, 3, generator=g)
    known = [torch.randn(2, 4, 32, 32, 3, generator=g) for _ in range(3)]
    video = torch.rand(2, 4, 32, 32, 3, generator=g)
    mask = torch.zeros(1, 4, 1, 1, 1)
    mask[:, :1] = 1.0
    embed = torch.randn(2, 32, generator=g)
    kw = dict(video_embed=embed, cond_scale=3.0, inpaint_video=video, inpaint_mask=mask,
              init_noises=[x_t], known_noises=[known])
    before = fm.KERNEL.launches, gn.KERNEL.launches
    got = card.sample(RowKeys([0, 1]), **kw).cpu()
    assert fm.KERNEL.launches > before[0] and gn.KERNEL.launches > before[1]
    want = cpu.sample(RowKeys([0, 1]), **kw)
    assert torch.isfinite(got).all() and 0.0 <= float(got.min()) <= float(got.max()) <= 1.0
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
    assert float(((want > 0) & (want < 1)).float().mean()) > 0.5
    torch.testing.assert_close(got[:, :1], video[:, :1], atol=1e-6, rtol=0)


def _student_away_from_teacher(tr, seed=1):
    """The student (and its EMA) moved off the teacher by the same seeded
    perturbation on any device."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for k, p in tr.student.items():
            p.add_((0.02 * torch.randn(p.shape, generator=g)).to(p))
            tr.ema[k].copy_(p)


def test_distill_loss_and_gradients_kernels_match_plain(dev):
    """One distillation loss (train/distill.py, f32, guidance 2.0: two
    teacher forwards at CFG batch 4, the student's forward and backward at
    batch 2) of a one-stage decoder on the card through rows 1-4 against
    the same on the CPU through their plain versions, the draws injected:
    the loss within 1e-4 relative, the student's gradients within 1e-3
    relative L2; then one distill_step on the card: finite, the EMA
    d * e + (1 - d) * p exactly."""
    from dalle2_video_tpu_torch.train.distill import DistillConfig, DistillTrainer

    card, cpu = _option_decoders(dev)
    g = torch.Generator().manual_seed(6)
    video = torch.rand(2, 4, 32, 32, 3, generator=g)
    embed = torch.randn(2, 32, generator=g)
    draws = {"segments": torch.tensor([0, 2]),
             "noise": torch.randn(2, 4, 32, 32, 3, generator=g)}
    kernels = (fm.KERNEL, fm.BWD_KERNEL, gn.KERNEL, gn.BWD_KERNEL)
    outs = []
    for dec, d in ((card, dev), (cpu, torch.device("cpu"))):
        tr = DistillTrainer(dec, DistillConfig(student_steps=4, teacher_cond_scale=2.0))
        tr.init_state()
        _student_away_from_teacher(tr)
        before = [k.launches for k in kernels]
        loss = tr.loss(video.to(d), video_embed=embed.to(d),
                       draws={k: v.to(d) for k, v in draws.items()})
        loss.backward()
        launched = [k.launches - n for k, n in zip(kernels, before)]
        assert all(launched) if d.type == "cuda" else not any(launched), launched
        outs.append((float(loss.detach()), {k: p.grad.cpu() for k, p in tr.student.items()
                                   if p.grad is not None}))
        if d.type == "cuda":
            ema0 = [v.clone() for v in tr.ema.values()]
            step_loss = tr.distill_step(video.to(d), video_embed=embed.to(d))
            assert math.isfinite(float(step_loss)) and tr.step == 1
            want = torch._foreach_mul(ema0, 0.999)
            torch._foreach_add_(want, torch._foreach_mul(
                [v.detach() for v in tr.student.values()], 1.0 - 0.999))
            assert all(torch.equal(a, b) for a, b in zip(want, tr.ema.values()))
    (l_k, g_k), (l_p, g_p) = outs
    assert abs(l_k - l_p) <= 1e-4 * abs(l_p) and l_p > 0
    assert set(g_k) == set(g_p)
    for k in g_p:
        if float(g_p[k].norm()) > 0:
            assert _rel_l2(g_k[k], g_p[k]) <= 1e-3, (k, _rel_l2(g_k[k], g_p[k]))


def test_served_student_sample_kernels_match_plain(dev, tmp_path):
    """serve_distill's swap (train/distill.py::serve_student) of one saved
    student into both decoders, the grid pinned to 2 steps; an unguided
    (cond_scale 1) batch-1 sample on the card through rows 1 and 3 at
    batch 1 against the CPU's plain versions from the same x_T: 2e-3 on
    the video in [0, 1] (the requests' bound)."""
    from dalle2_video_tpu_torch.train import save_checkpoint
    from dalle2_video_tpu_torch.train.distill import (
        DistillConfig,
        DistillTrainer,
        serve_student,
    )
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    card, cpu = _option_decoders(dev)
    tr = DistillTrainer(cpu, DistillConfig(student_steps=2))
    tr.init_state()
    _student_away_from_teacher(tr)
    save_checkpoint(str(tmp_path / "student"), tr.state_dict())
    g = torch.Generator().manual_seed(7)
    x_t = torch.randn(1, 4, 32, 32, 3, generator=g)
    embed = torch.randn(1, 32, generator=g)
    videos = []
    for dec in (card, cpu):
        serve_student(dec, str(tmp_path / "student"), 2)
        assert dec.sample_timesteps == (2,)
        before = fm.KERNEL.launches, gn.KERNEL.launches
        videos.append(dec.sample(RowKeys([0]), video_embed=embed, cond_scale=1.0,
                                 init_noises=[x_t]).cpu())
        launched = fm.KERNEL.launches - before[0], gn.KERNEL.launches - before[1]
        assert all(launched) if dec is card else not any(launched), launched
    got, want = videos
    assert torch.isfinite(got).all() and 0.0 <= float(got.min()) <= float(got.max()) <= 1.0
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)
    assert float(((want > 0) & (want < 1)).float().mean()) > 0.5


# --------------------------------------------------------------- stages 1 and 2
# No kernel lies on them: the ViViT, the CLIP step and the prior step run
# plain PyTorch on the card (f32, TF32 off), held here to the same on the
# CPU; the serving stack then loads what the stages' entry points wrote.
_VIVIT = dict(frame_size=16, patch_size=8, num_frames=25, dim=24, depth=1, heads=2,
              dim_head=8)
_TEXT = dict(vocab_size=1000, width=32, heads=2, layers=1, embed_dim=24)


def _step_params_close(card, cpu, lr):
    """Params after one Adam step from one init: Adam's first update is
    lr * g / (|g| + eps), so a gradient that cancels to noise may take
    either sign on either device. At most 0.1% of the values may differ by
    more than 1e-5, none by more than 2 lr + 1e-5."""
    diffs = torch.cat([(a.detach().cpu() - b.detach()).abs().flatten()
                       for a, b in zip(card, cpu)])
    assert float(diffs.max()) <= 2 * lr + 1e-5, float(diffs.max())
    assert float((diffs > 1e-5).float().mean()) <= 1e-3


def test_vivit_forward_and_clip_step_on_cuda_match_cpu(dev):
    """The ViViT forward (f32, 1e-5 of the output's scale) and one
    ClipTrainer step (loss, temperature, top1 / top10 at 1e-5 relative;
    params as _step_params_close) on the card against the CPU, from the
    towers clip_stage_generators(0) builds on both."""
    from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig
    from dalle2_video_tpu_torch.models.vivit import ViViTConfig
    from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer

    g = torch.Generator().manual_seed(0)
    videos = torch.randn(4, 25, 16, 16, 3, generator=g)
    tokens = torch.randint(1, 1000, (4, 77), generator=g)
    card, cpu = (ClipTrainer(ViViTConfig(**_VIVIT), CLIPTextConfig(**_TEXT), device=d)
                 for d in (dev, "cpu"))
    got = card.embed_video(videos).cpu()
    want = cpu.embed_video(videos)
    torch.testing.assert_close(got, want, atol=1e-5 * float(want.abs().max()), rtol=0)
    m_card = card.train_step(videos.to(dev), tokens.to(dev))
    m_cpu = cpu.train_step(videos, tokens)
    for k in ("loss", "temperature", "top1", "top10"):
        torch.testing.assert_close(m_card[k].cpu(), m_cpu[k], rtol=1e-5, atol=1e-6)
    _step_params_close([*card.vivit.parameters(), card.temperature],
                       [*cpu.vivit.parameters(), cpu.temperature], card.cfg.lr)


def test_prior_step_on_cuda_matches_cpu(dev):
    """One PriorTrainer step with the same draws on the card and the CPU:
    the loss (1e-5 relative) and the params (as _step_params_close); the
    card trainer's state, saved and loaded back mapped to the card (its
    generator's state then lies on the card too), resumes it exactly."""
    import io

    from dalle2_video_tpu_torch.train.train_prior import build_prior_trainer
    from dalle2_video_tpu_torch.utils.config import load_config

    cfg = load_config(None, ["dim=32", "prior.depth=2", "prior.heads=2", "prior.dim_head=8",
                             "prior.timesteps=100"])
    g = torch.Generator().manual_seed(1)
    ve, te = torch.randn(8, 32, generator=g), torch.randn(8, 32, generator=g)
    draws = {"times": torch.randint(0, 100, (8,), generator=g),
             "noise": torch.randn(8, 32, generator=g),
             "text_keep": torch.rand(8, generator=g) < 0.9}
    card, cpu = build_prior_trainer(cfg, dev), build_prior_trainer(cfg, "cpu")
    got = card.train_step(ve.to(dev), te.to(dev), draws={k: v.to(dev) for k, v in draws.items()})
    want = cpu.train_step(ve, te, draws=draws)
    torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-6)
    _step_params_close(list(card.prior.network.parameters()),
                       list(cpu.prior.network.parameters()), float(cfg["prior"]["lr"]))
    buf = io.BytesIO()
    torch.save(card.state_dict(), buf)
    buf.seek(0)
    again = build_prior_trainer(cfg, dev)
    again.load_state_dict(torch.load(buf, map_location=dev, weights_only=False))
    assert torch.equal(again.generator.get_state(), card.generator.get_state())
    assert all(torch.equal(a, b) for a, b in zip(again.prior.network.parameters(),
                                                card.prior.network.parameters()))


def test_serve_stack_loads_the_stages_checkpoints_onto_the_card(dev, tmp_path):
    """train_prior (use_ema) and the decoder's entry point run on the CPU on
    seeded embeddings and videos; build_stack on the card then serves the
    prior checkpoint's EMA shadow and the best decoder state's EMA shadows
    bit for bit, and answers a request."""
    import logging

    import numpy as np

    from dalle2_video_tpu_torch.serve import stack
    from dalle2_video_tpu_torch.train import load_best, load_params_subtree
    from dalle2_video_tpu_torch.train import train_prior
    from dalle2_video_tpu_torch.train.__main__ import SyntheticVideos, train_decoder
    from dalle2_video_tpu_torch.utils.config import load_config

    rng = np.random.default_rng(0)
    for name in ("videos", "texts"):
        np.save(tmp_path / f"{name}.npy", rng.standard_normal((6, 24)).astype(np.float32))
    args = [f"run_dir={tmp_path}/runs", f"videos.embed={tmp_path}/videos.npy",
            f"texts.embed={tmp_path}/texts.npy", "dim=24", "prior.depth=1", "prior.heads=2",
            "prior.dim_head=8", "prior.batch_size=2", "prior.epochs=2", "prior.use_ema=true",
            "prior.ema_update_after_step=1", "prior.ema_update_every=1",
            "prior.sample_timesteps=2", "frame_sizes=[8,16]", "frame_numbers=[2,2]",
            "decoder.batch_size=2", "decoder.bf16_compute=false", "loader=thread",
            "unet1.dim=16", "unet2.dim=8", *(f"unet{u}.{k}" for u in (1, 2) for k in (
                "dim_mults=[1,2]", "num_resnet_blocks=1", "attn_heads=2", "attn_dim_head=8"))]
    train_prior.main(args + ["device=cpu"])
    cfg = load_config(None, args)
    data = SyntheticVideos(4, 2, 16, 24)
    train_decoder(dict(cfg, decoder=dict(cfg["decoder"], epochs=1)), data,
                  {"train": np.arange(2), "val": np.arange(2, 4)}, "cpu")
    text_enc, wrapper = stack.build_stack(cfg, dev)
    served = dict(wrapper.prior.network.named_parameters())
    for k, v in load_params_subtree(f"{tmp_path}/runs/prior_default").items():
        assert served[k].is_cuda and torch.equal(served[k].cpu(), v), k
    state = load_best(f"{tmp_path}/runs/decoder_default")
    for i, unet in enumerate(wrapper.decoder.unets):
        ema = state["ema"][i]["params"]
        assert all(torch.equal(p.cpu(), ema[k]) for k, p in unet.named_parameters())
    generate = stack.build_generate_batch(cfg, logging.getLogger("test"), dev)
    video = generate(["a person smiling"], [3], cond_scale=3.0, ddim_steps=2)
    assert video.shape == (1, 2, 16, 16, 3) and np.isfinite(video).all()


# ------------------------------------- quality scoring and the reference import
# No kernel is new here: the resizes and the adapters are plain PyTorch,
# held on the card to the same functions on the CPU; an imported decoder
# samples through rows 1 and 3.
def test_resize_methods_on_cuda_match_cpu(dev):
    """Every jax.image.resize method of ops/video.py on the card against
    the CPU, down and up in space and in time, f32 within 1e-5."""
    from dalle2_video_tpu_torch.ops.video import METHODS, resize_video, resize_video_time

    x = torch.rand(2, 6, 12, 9, 3, generator=torch.Generator().manual_seed(0))
    for method in METHODS:
        for fn, n in ((resize_video, 5), (resize_video, 20), (resize_video_time, 4),
                      (resize_video_time, 9)):
            got = fn(x.to(dev), n, method)
            assert got.is_cuda
            torch.testing.assert_close(got.cpu(), fn(x, n, method), atol=1e-5, rtol=0)


def test_clip_adapters_on_cuda(dev):
    """VideoClipAdapter over copies of a ClipTrainer's towers on the card:
    its embeds the trainer's bit for bit, every parameter frozen; the
    x-clip stand-in's adapter keeps its tensors on the card, its embeds
    within 1e-5 of the CPU's; StepTimer.stop waits on a CUDA result."""
    from unittest import mock

    from dalle2_video_tpu_torch.models.clip_adapter import VideoClipAdapter, XClipAdapter
    from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig
    from dalle2_video_tpu_torch.models.vivit import ViViTConfig
    from dalle2_video_tpu_torch.train.clip_trainer import ClipTrainer
    from dalle2_video_tpu_torch.utils.profiling import StepTimer

    vc, tc = ViViTConfig(**_VIVIT), CLIPTextConfig(**_TEXT)
    trainer = ClipTrainer(vc, tc, device=dev)
    ad = VideoClipAdapter.create(vc, trainer.vivit.state_dict(),
                                 trainer.text_encoder.state_dict(), tc, dev)
    g = torch.Generator().manual_seed(0)
    videos = torch.rand(2, 25, 16, 16, 3, generator=g).to(dev)
    tokens = torch.randint(1, 1000, (2, 77), generator=g).to(dev)
    assert torch.equal(ad.embed_video(videos)[0], trainer.embed_video(videos))
    assert torch.equal(ad.embed_text(tokens)[0], trainer.embed_text(tokens))
    assert not any(p.requires_grad for p in [*ad.vivit.parameters(),
                                             *ad.text_encoder.parameters()])

    class Standin(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.dim_latent = 12
            self.emb = torch.nn.Embedding(100, 16)
            self.to_text_latent = torch.nn.Linear(16, 12, bias=False)
            self.vis = torch.nn.Linear(3 * 8 * 8, 16, bias=False)
            self.to_visual_latent = torch.nn.Linear(16, 12, bias=False)

        def text_transformer(self, tok):
            e = self.emb(tok)
            return torch.cat([e.mean(1, keepdim=True), e], 1)

        def visual_transformer(self, frames):
            e = self.vis(frames.reshape(frames.shape[0], -1))[:, None]
            return torch.cat([e, e], 1)

    torch.manual_seed(0)
    cpu_model = Standin()
    card_model = Standin().to(dev)
    card_model.load_state_dict(cpu_model.state_dict())
    clips = torch.rand(2, 3, 8, 8, 3, generator=g)
    card_ad, cpu_ad = XClipAdapter(card_model), XClipAdapter(cpu_model)
    got = card_ad.embed_video(clips)[0]
    assert got.is_cuda
    torch.testing.assert_close(got.cpu(), cpu_ad.embed_video(clips)[0], atol=1e-5, rtol=0)

    timer = StepTimer()
    with mock.patch.object(torch.cuda, "synchronize", wraps=torch.cuda.synchronize) as sync:
        timer.start()
        timer.stop({"embed": got})
    assert sync.call_count == 1


def test_imported_decoder_samples_on_cuda_as_on_cpu(dev, tmp_path):
    """A reference-layout decoder state dict drawn from decoder_walk (with
    a schedule buffer among its keys) loaded by load_decoder_torch_ckpt into
    the card's and the CPU's one-stage decoders: the same parameters bit
    for bit, and a guided batch-1 sample through rows 1 and 3 within 2e-3
    of the CPU's plain versions from the same x_T."""
    from dalle2_video_tpu_torch.models import torch_import
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    card, cpu = _option_decoders(dev)
    sd = torch_import.draw_walk(torch_import.decoder_walk(cpu), torch.Generator().manual_seed(0))
    sd["noise_schedulers.0.betas"] = torch.linspace(1e-4, 2e-2, 1000)
    torch.save(sd, tmp_path / "decoder_best.pt")
    g = torch.Generator().manual_seed(7)
    x_t = torch.randn(1, 4, 32, 32, 3, generator=g)
    embed = torch.randn(1, 32, generator=g)
    videos = []
    for dec in (card, cpu):
        skipped = torch_import.load_decoder_torch_ckpt(str(tmp_path / "decoder_best.pt"), dec)
        assert skipped == ["noise_schedulers.0.betas"]
        dec.sample_timesteps = (4,)
        videos.append(dec.sample(RowKeys([0]), video_embed=embed, cond_scale=3.0,
                                 init_noises=[x_t]).cpu())
    for a, b in zip(card.unets[0].state_dict().values(), cpu.unets[0].state_dict().values()):
        assert torch.equal(a.cpu(), b)
    got, want = videos
    assert torch.isfinite(got).all() and 0.0 <= float(got.min()) <= float(got.max()) <= 1.0
    torch.testing.assert_close(got, want, atol=2e-3, rtol=0)


# ------------------------------------------------------------ the latent stage
def test_flash_kernels_at_the_latent_bottleneck(dev):
    """Rows 1 and 2 at the latent recipe's joint bottleneck (8 heads of 32
    over 90 x 8 x 8 = 5,760 tokens and the null kv, bf16, batch 2): the
    forward held as every bf16 flash forward (one bf16 step, the f64
    oracle on 256 rows, the lse), the backward on the tensor-core route
    against its plain version."""
    n = 90 * 8 * 8
    _flash_bf16_case(dev, 2, n * 8, n + 1, seed=n, oracle=True)
    g = torch.Generator(device=dev).manual_seed(n + 1)
    q, go = (torch.randn(2, n * 8, 32, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, n + 1, 32, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)
    got = _flash_bwd_launch(q, k, v, out, lse, go, 32**-0.5, _bwd_route(torch.bfloat16, 2))
    _assert_grads_close(got, fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 32**-0.5),
                        torch.bfloat16)


def test_vqgan_train_step_on_cuda_matches_the_cpu(dev):
    """One VQGanTrainer.train_step past disc_start (f32; the convs through
    cuDNN without TF32) on the card and on the CPU from the same weights:
    every metric within 1e-4 relative; after the step (Adam's first, lr
    1e-3) every parameter within 1e-5 but where a gradient within f32
    noise of 0 takes the other sign (at most 0.1% of a tensor's values, by
    at most 2 lr)."""
    from dalle2_video_tpu_torch.models.discriminator import PatchDiscriminator
    from dalle2_video_tpu_torch.models.vqvae import VQVAE
    from dalle2_video_tpu_torch.train.vqgan_trainer import VQGanTrainer, VQGanTrainerConfig

    cfg = VQGanTrainerConfig(lr_g=1e-3, lr_d=1e-3, disc_start=0)
    trainers = []
    for d in ("cpu", dev):
        g = torch.Generator().manual_seed(0)
        trainers.append(VQGanTrainer(
            VQVAE(base_dim=16, codebook_size=64, device=d, generator=g),
            PatchDiscriminator(base_dim=16, num_layers=2, device=d, generator=g), cfg))
    video = torch.rand(2, 4, 32, 32, 3, generator=torch.Generator().manual_seed(1))
    want = trainers[0].train_step(video)
    got = trainers[1].train_step(video.to(dev))
    for key, w in want.items():
        assert abs(float(got[key]) - float(w)) <= 1e-4 * abs(float(w)) + 1e-7, key
    for a, b in ((trainers[0].vae, trainers[1].vae), (trainers[0].disc, trainers[1].disc)):
        theirs = dict(b.named_parameters())
        for name, p in a.named_parameters():
            diff = (theirs[name].detach().cpu() - p.detach()).abs()
            assert float(diff.max()) <= 2e-3 + 1e-5, name
            assert float((diff > 1e-5).float().mean()) <= 1e-3, name


def test_latent_decoder_loss_on_cuda_matches_the_cpu(dev):
    """A decoder with a VQVAE stage (predict_x_start_for_latent_diffusion;
    the unet's flash attention and GroupNorm kernels, f32) on the card and,
    with the same weights, on the CPU (the plain versions), the draws
    injected: the loss within 1e-4 relative and the unet's gradients within
    1e-3 relative L2; rows 1-4 launch on the card; the VAE's encoding of
    the video agrees to 1e-5 of its scale."""
    from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
    from dalle2_video_tpu_torch.models.layers import kernel_init_
    from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
    from dalle2_video_tpu_torch.models.vqvae import VQVAE

    ucfg = UNet3DConfig(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=4,
                        attn_dim_head=32, video_embed_dim=32, attention_impl="flash",
                        groupnorm_impl="pallas", cross_attention_impl="xla")
    cfg = VideoDecoderConfig(unets=(ucfg,), frame_sizes=(64,), frame_numbers=(4,),
                             learned_variance=False, predict_x_start_for_latent_diffusion=True)
    torch.manual_seed(0)
    cpu = VideoDecoder(cfg, device="cpu", vaes=(VQVAE(base_dim=16, codebook_size=64,
                                                      device="cpu"),))
    w = cpu.unets[0].to_out.Conv_0.weight
    kernel_init_(w, w[0].numel())
    card = VideoDecoder(cfg, device=dev, vaes=(VQVAE(base_dim=16, codebook_size=64,
                                                      device=dev),))
    card.load_state_dict(cpu.state_dict())
    g = torch.Generator().manual_seed(3)
    video = torch.rand(2, 4, 64, 64, 3, generator=g)
    draws = {"times": torch.tensor([3, 700]), "noise": torch.randn(2, 4, 16, 16, 4, generator=g),
             "video_keep": torch.tensor([True, False])}
    embed = torch.randn(2, 32, generator=g)
    kernels = (fm.KERNEL, fm.BWD_KERNEL, gn.KERNEL, gn.BWD_KERNEL)
    outs = []
    for dec, d in ((card, dev), (cpu, torch.device("cpu"))):
        before = [k.launches for k in kernels]
        loss = dec.loss(video.to(d), video_embed=embed.to(d),
                        draws={k: v.to(d) for k, v in draws.items()})
        loss.backward()
        launched = [k.launches - n for k, n in zip(kernels, before)]
        assert all(launched) if d.type == "cuda" else not any(launched), launched
        with torch.no_grad():
            z = dec.vaes[0].encoder(video.to(d)).cpu()
        outs.append((float(loss.detach()), z, {k: p.grad.cpu() for k, p in
                                               dec.unets[0].named_parameters()
                                               if p.grad is not None}))
    (l_k, z_k, g_k), (l_p, z_p, g_p) = outs
    assert abs(l_k - l_p) <= 1e-4 * abs(l_p) and l_p > 0
    assert float((z_k - z_p).abs().max()) <= 1e-5 * float(z_p.abs().max())
    assert set(g_k) == set(g_p)
    for k in g_p:
        if float(g_p[k].norm()) > 0:
            assert _rel_l2(g_k[k], g_p[k]) <= 1e-3, (k, _rel_l2(g_k[k], g_p[k]))


# ------------------------------------------------------------ the parallel axes
@pytest.mark.parametrize("model", [2, 4])
def test_flash_kernels_at_a_sequence_parallel_shard(dev, model):
    """Rows 1 and 2 at one model rank's query shard of the 90-frame
    recipe's unet-1 bottleneck under attention_impl sp (16 heads of 32 over
    5,760 / model tokens: 46,080 query rows at model 2, 23,040 at 4,
    against the 5,761 gathered keys, bf16, batch 2): row 2's library plans
    a split for the count, the forward is held as every bf16 flash forward,
    the backward on the tensor-core route against its plain version."""
    n = 90 * 8 * 8
    rows = n // model * 16
    assert fm.BWD_KERNEL.query("d2v_flash_mqa_bwd_splits", 2, rows, n + 1, 32, 1) > 0
    _flash_bf16_case(dev, 2, rows, n + 1, seed=rows, oracle=True)
    g = torch.Generator(device=dev).manual_seed(rows + 1)
    q, go = (torch.randn(2, rows, 32, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(2, n + 1, 32, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)
    got = _flash_bwd_launch(q, k, v, out, lse, go, 32**-0.5, _bwd_route(torch.bfloat16, 2))
    _assert_grads_close(got, fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 32**-0.5),
                        torch.bfloat16)


def test_flash_backward_routes_by_the_global_batch_on_the_card(dev):
    """A data rank's one bf16 row under a data axis of 2: the saved lse is
    the forward's own and the backward takes the tensor-core route (the
    batch JAX traces is the global 2), held to the plain version at that
    route; with no mesh the same row takes the CUDA-core route."""
    from dalle2_video_tpu_torch.parallel.mesh import Mesh, active_mesh, global_batch

    g = torch.Generator(device=dev).manual_seed(5)
    q, go = (torch.randn(1, 5760, 32, generator=g, device=dev).to(torch.bfloat16)
             for _ in range(2))
    k, v = (torch.randn(1, 1441, 32, generator=g, device=dev).to(torch.bfloat16)
            for _ in range(2))
    with active_mesh(Mesh(2, 1, 0, dev, None)):
        batch = global_batch(1)
    assert batch == 2
    out, lse = fm.fwd_residuals(q, k, v, sm_scale=32**-0.5, batch=batch)
    own = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)[1]
    assert torch.equal(lse, own)
    before = dict(fm.BWD_KERNEL.routes)
    got = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=32**-0.5, batch=batch)
    assert fm.BWD_KERNEL.routes["tensor_cores"] == before.get("tensor_cores", 0) + 1
    _assert_grads_close(got, fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 32**-0.5,
                                                        batch=batch), torch.bfloat16)
    fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=32**-0.5)
    assert fm.BWD_KERNEL.routes["cuda_cores"] == before.get("cuda_cores", 0) + 1
