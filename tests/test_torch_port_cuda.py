"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: each test skips (with a reason) where there is no CUDA
device or no nvcc; the decision is made inside the fixture, never at
import. Run on the card with

    python -m pytest -m cuda tests/test_torch_port_cuda.py

Tolerances (forwards): f32 inputs 1e-5, 4e-5 for GroupNorm's sums over up
to 80k values (same math, another summation order). bf16 attention outputs:
|kernel - plain| <= atol + 1e-2 * |plain|. Both sides end in a bf16
rounding, one step of which is at most 2^-7 = 7.8e-3 of the value, so the
relative term admits one rounding flip at any magnitude; atol covers the
work before the rounding: 1e-3 for cross-attention (f32 math), and for flash
the bf16 probabilities of its second product (see the flash test). GroupNorm
in bf16 keeps 8e-2 absolute on outputs of a few units. The backward
kernels' tolerances sit with their tests below.
"""

from __future__ import annotations

import math
import shutil

import pytest
import torch

import torch.nn.functional as F

from dalle2_video_tpu_torch.ops import cross_attention as xa
from dalle2_video_tpu_torch.ops import flash_mqa as fm
from dalle2_video_tpu_torch.ops import fused_block as fb
from dalle2_video_tpu_torch.ops import groupnorm_film as gn
from dalle2_video_tpu_torch.ops import spatial_conv as sc
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_kv", [1, 65, 5761])
def test_flash_kernel_matches_plain(dev, dtype, n_kv):
    g = torch.Generator(device=dev).manual_seed(n_kv)
    q = torch.randn(2, 333, 32, generator=g, device=dev).to(dtype)
    k = torch.randn(2, n_kv, 32, generator=g, device=dev).to(dtype)
    v = torch.randn(2, n_kv, 32, generator=g, device=dev).to(dtype)
    before = fm.KERNEL.launches
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)
    torch.cuda.synchronize()
    assert fm.KERNEL.launches == before + 1
    ref, ref_lse = fm.flash_mqa_reference(q, k, v, 32**-0.5, save_lse=True)
    # the kernel rounds the probabilities to bf16 (unit roundoff 2^-8) for its
    # second product: an error of ~2^-8/sqrt(3) * sqrt(sum p^2 v^2) RMS, about
    # 2.3e-3 * sqrt(e / n_kv) for logits ~ N(0, 1); allow five of those,
    # clipped to [5e-4, 2.5e-3] (at n_kv = 1 the one probability is exact)
    bf16_atol = min(2.5e-3, max(5e-4, 1.15e-2 * math.sqrt(math.e / n_kv)))
    _assert_attention_close(out, ref, dtype, bf16_atol)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


def test_flash_kernel_logits_below_minus_87(dev):
    q = torch.full((1, 8, 16), 16.0, device=dev)
    k = torch.full((1, 37, 16), -2.0, device=dev) + 0.1 * torch.randn(1, 37, 16, device=dev)
    v = torch.randn(1, 37, 16, device=dev)
    out = fm.flash_mqa_fwd(q, k, v, sm_scale=0.25)
    assert torch.isfinite(out).all()
    # logits near -124 (base-2: -179) carry f32 spacing ~1.5e-5, so the
    # kernel's exp2 and the plain exp differ by ~1e-4 relative here
    torch.testing.assert_close(out, fm.flash_mqa_reference(q, k, v, 0.25), atol=1e-5, rtol=2e-4)


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
    torch.testing.assert_close(mean, rmean, atol=1e-4, rtol=0)
    torch.testing.assert_close(rstd, rrstd, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("m", [3, 7, 16])
def test_cross_attention_kernel_matches_plain(dev, dtype, m):
    g = torch.Generator(device=dev).manual_seed(m)
    q = torch.randn(2, 1000, 8, 64, generator=g, device=dev).to(dtype)
    k = torch.randn(2, m, 8, 64, generator=g, device=dev).to(dtype)
    v = torch.randn(2, m, 8, 64, generator=g, device=dev).to(dtype)
    out = xa.cross_attention(q, k, v, sm_scale=0.125)
    # the plain version runs in its input dtype: f32 copies give the f32-math
    # oracle, rounded once
    ref = xa.cross_attention_reference(q.float(), k.float(), v.float(), 0.125).to(dtype)
    _assert_attention_close(out, ref, dtype, bf16_atol=1e-3)


def test_cuda_wrappers_raise_instead_of_falling_back(dev):
    x = torch.zeros(2, 8, 32, device=dev, dtype=torch.float16)
    with pytest.raises(ValueError):
        fm.flash_mqa_fwd(x, x, x)  # fp16: not a kernel dtype
    q = torch.zeros(1, 4, 8, 64, device=dev)
    k = torch.zeros(1, 17, 8, 64, device=dev)
    with pytest.raises(ValueError, match="exceeds"):
        xa.cross_attention(q, k, k, sm_scale=1.0)
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n_q,n_kv", [(333, 1), (333, 65), (1000, 5761)])
def test_flash_bwd_kernel_matches_plain(dev, dtype, n_q, n_kv):
    g = torch.Generator(device=dev).manual_seed(n_kv)
    q, go = (torch.randn(2, n_q, 32, generator=g, device=dev).to(dtype) for _ in range(2))
    k, v = (torch.randn(2, n_kv, 32, generator=g, device=dev).to(dtype) for _ in range(2))
    out, lse = fm.flash_mqa_fwd(q, k, v, sm_scale=32**-0.5, save_lse=True)
    before = fm.BWD_KERNEL.launches
    got = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=32**-0.5)
    torch.cuda.synchronize()
    assert fm.BWD_KERNEL.launches == before + 1
    assert all(t.dtype == dtype for t in got)
    _assert_grads_close(got, fm.flash_mqa_bwd_reference(q, k, v, out, lse, go, 32**-0.5), dtype)
    # the query-split partials are summed in a fixed order: bit for bit again
    again = fm.flash_mqa_bwd(q, k, v, out, lse, go, sm_scale=32**-0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


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
              (1, 4, 160, 64, 64)]  # Co != C, the deep 8x8, odd H/W, a wide row


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,h,w,c,co", [(3, 16, 16, 64, 128), (2, 8, 8, 512, 64),
                                        (7, 9, 10, 64, 64)])
def test_conv3x3_wgrad_kernel_matches_plain_bit_for_bit_twice(dev, dtype, n, h, w, c, co):
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
                                              (3, 2, 16, 16, 128, 64)])
def test_conv_bias_stats_kernel_matches_plain(dev, dtype, batch, t, h, w, c, co):
    """At 3 x 7 x 7 = 147 pixels per batch row a row ends inside the second
    128-pixel (bf16) or third 64-pixel (f32) tile: tiles are per batch row,
    so no partial sum straddles two rows. The sums are f32 over the row's
    f32 values on both sides: 1e-5 of their largest value."""
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
