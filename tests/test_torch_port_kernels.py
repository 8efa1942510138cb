"""The port's three kernel modules against the JAX package's Pallas kernels.

On the CPU each port wrapper runs its plain PyTorch version (the CUDA
kernels run only on the card; chip_smoke.py and test_torch_port_cuda.py hold
them against these plain versions there). The JAX side runs its Pallas
kernels in interpret mode, as tests/test_pallas.py does. Inputs come from
numpy with a fixed seed and are handed to both.

Tolerance: 2e-5 absolute, everything in float32 -- the two sides compute
the same softmax / normalisation in f32 with a different summation order
(streaming online softmax vs one-shot), which moves results by a few ulp of
O(1) values. Same bound as tests/test_pallas.py uses for these kernels.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.ops.pallas.cross_attention import cross_attention as jax_cross
from dalle2_video_tpu.ops.pallas.flash_mqa import (
    _auto_fwd_blocks,
    _flash_mqa_fwd_only,
    mqa_attention as jax_mqa,
)
from dalle2_video_tpu.ops.pallas.groupnorm_film import (
    _fwd_impl as jax_gn_fwd,
    groupnorm_film_silu as jax_gn,
)
from dalle2_video_tpu_torch.ops import cross_attention as port_cross
from dalle2_video_tpu_torch.ops._cuda import CSRC, all_kernels as _all_kernels
from dalle2_video_tpu_torch.ops import flash_mqa as port_flash
from dalle2_video_tpu_torch.ops import fused_block as port_fb
from dalle2_video_tpu_torch.ops import groupnorm_film as port_gn
from dalle2_video_tpu_torch.ops import spatial_conv as port_sc
from dalle2_video_tpu_torch.probes import gn_rows, xattn_rows

torch.set_num_threads(1)
ATOL = 2e-5


# the interpret-mode kernels are jitted and compiled at XLA's lowest
# optimisation level: less compile time, the same f32 kernels
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _o0(fn, *args):
    args = [jnp.asarray(a) for a in args]
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


def _np(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------- flash MQA
@pytest.mark.parametrize("n_kv", [37, 130, 129])  # n_kv = n + 1 style tails
def test_flash_fwd_unaligned_kv_with_lse(n_kv):
    rng = np.random.default_rng(n_kv)
    d = 32
    q, k, v = _np(rng, 2, 96, d), _np(rng, 2, n_kv, d), _np(rng, 2, n_kv, d)
    scale = d**-0.5
    want, want_lse = _o0(lambda q, k, v: _flash_mqa_fwd_only(
        q, k, v, sm_scale=scale, block_q=64, block_k=64, interpret=True, save_lse=True), q, k, v)
    got, lse = port_flash.flash_mqa_fwd(_t(q), _t(k), _t(v), sm_scale=scale,
                                        save_lse=True, block_q=64, block_k=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=ATOL)


def test_flash_fwd_all_logits_below_minus_87():
    """Every real logit < -87 (past f32 exp underflow of exp(logit)): the
    padded tail must not hold the running max. Same regime as
    test_pallas.py's lse-overflow test, unaligned n_kv = 37."""
    rng = np.random.default_rng(3)
    d = 16
    q = np.full((1, 8, d), 16.0, np.float32)
    k = np.full((1, 37, d), -2.0, np.float32) + 0.1 * _np(rng, 1, 37, d)
    v = _np(rng, 1, 37, d)
    scale = d**-0.5
    s = np.einsum("bnd,bmd->bnm", q * scale, k)
    assert s.max() < -87.0
    want, want_lse = _o0(lambda q, k, v: _flash_mqa_fwd_only(
        q, k, v, sm_scale=scale, block_q=32, block_k=32, interpret=True, save_lse=True), q, k, v)
    got, lse = port_flash.flash_mqa_fwd(_t(q), _t(k), _t(v), sm_scale=scale,
                                        save_lse=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # lse ~ -124: f32 spacing there is ~8e-6, so 2e-5 is a few ulp too
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=5e-5)


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    """One bf16 step at |x| (8 significant bits): 2^(e - 8) for x = m 2^e,
    m in [0.5, 1)."""
    _, e = np.frexp(np.maximum(np.abs(x), np.finfo(np.float32).tiny))
    return np.ldexp(1.0, e - 8)


def _bf16(a: np.ndarray) -> np.ndarray:
    """a rounded to bf16 (nearest even), held in f32: both sides get it."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("n_kv,block_k", [(1100, 512), (300, 512), (515, 128)])
def test_flash_fwd_plain_bf16_follows_the_jax_kernel(n_kv, block_k):
    """bf16: the plain forward computes ``_flash_mqa_kernel``'s function --
    q * scale rounded to bf16, the running max moved once per block_k
    keys, the probabilities rounded to bf16 and summed in f32 for the
    denominator. A ragged tail, n_kv < block_k and several blocks. Bound:
    at most 0.5% of outputs differ, each by at most one bf16 step of the
    larger value, lse within 1e-4 plus one probability flip. The two sides
    sum the logits in another f32 order, so a probability now and then
    rounds to the neighbouring bf16 value. That moves an output by an
    amount set by the output's scale, not by its own size, so the step is
    taken at no less than the output's RMS (near-zero outputs of a
    cancelling sum would otherwise admit no difference at all); and it
    moves the denominator l by at most 2^-8 (p <= 1), lse by 2^-8 / l,
    with l = sum exp(s - rowmax) in f64 (1.3e-4 at n_kv = 300, seed
    812)."""
    rng = np.random.default_rng(n_kv + block_k)
    b, n_q, d = 2, 512, 32
    q, k, v = (_bf16(_np(rng, b, n, d)) for n in (n_q, n_kv, n_kv))
    scale = d**-0.5
    to_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want, want_lse = _o0(lambda q, k, v: _flash_mqa_fwd_only(
        to_jax(q), to_jax(k), to_jax(v), sm_scale=scale, block_q=256, block_k=block_k,
        interpret=True, save_lse=True), q, k, v)
    want = np.asarray(want.astype(jnp.float32))
    bf = lambda a: _t(a).to(torch.bfloat16)
    got, lse = port_flash.flash_mqa_fwd(bf(q), bf(k), bf(v), sm_scale=scale,
                                        save_lse=True, block_k=block_k)
    got = got.float().numpy()
    differ = got != want
    assert differ.mean() <= 5e-3, f"{differ.mean():.2%} of the bf16 outputs differ"
    gap = np.abs(got - want)[differ]
    rms = float(np.sqrt(np.mean(want**2)))
    step = _bf16_ulp(np.maximum(np.maximum(np.abs(got), np.abs(want))[differ], rms))
    assert (gap <= step).all(), f"a value differs by {float((gap / step).max()):.1f} bf16 steps"
    s = np.einsum("bnd,bmd->bnm", _bf16(q * np.float32(scale)).astype(np.float64), k)
    l = np.exp(s - s.max(-1, keepdims=True)).sum(-1)
    assert (np.abs(lse.numpy() - np.asarray(want_lse)[..., 0]) <= 1e-4 + 2.0**-8 / l).all()


@pytest.mark.parametrize("n_q,n_kv", [(92160, 5761), (16384, 1025), (65536, 4097),
                                      (368640, 23041), (8191, 4095), (8192, 4096),
                                      (8193, 4097), (100, 16383), (100, 16384), (100, 16385)])
def test_flash_fwd_auto_blocks_follow_the_jax_rule(n_q, n_kv):
    """The port's copy of ``_auto_fwd_blocks``: the paths' shapes (serve,
    the cascade's two sampling bottlenecks, the probes) and each threshold
    +- 1."""
    assert port_flash.auto_fwd_blocks(n_q, n_kv) == _auto_fwd_blocks(n_q, n_kv)


def test_mqa_attention_heads_fold_matches_jax():
    """Port folds heads token-major (free reshape), JAX head-major: same
    result since every head shares the kv. n_kv = n + 1 (null kv)."""
    rng = np.random.default_rng(7)
    b, n, h, d = 2, 40, 4, 16
    q, k, v = _np(rng, b, n, h, d), _np(rng, b, n + 1, d), _np(rng, b, n + 1, d)
    want = _o0(lambda q, k, v: jax_mqa(q, k, v, sm_scale=d**-0.5, block_q=32, block_k=32,
                                       interpret=True), q, k, v)
    got = port_flash.mqa_attention(_t(q), _t(k), _t(v), sm_scale=d**-0.5)
    assert got.shape == (b, n, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------- GroupNorm
# bf16 (rows 3 and 4 as the serving and training paths run them): the JAX
# kernel takes one-pass f32 statistics (E[x^2] - mean^2) summed block by
# block and folded over each group's lanes in lane order; the port's plain
# version follows it (the block sums in torch's own order), so a bf16 output
# differs only where the two f32 results straddle a bf16 rounding. Measured
# on these draws (CPU, XLA's lowest optimisation level,
# tests/measure_gn_shares_vs_jax.py): well-conditioned inputs (2 randn +
# 0.5) 1 of 65,536 forward outputs (0.0015%) and 6 of 65,536 dx values
# (0.0092%); inputs of mean 30 and spread 1, where the one-pass variance
# loses bits to cancellation, none of the forward's outputs and 4 dx values
# (0.0061%); each difference one bf16 step. (The two-pass plain version this
# replaced differed in 0.81% and 1.08% at mean 30.) Each bound sits near
# its measure.
GN_BF16_SHARE = {"bf16": 1e-4, "bf16-mean30": 5e-5}
GN_BF16_BWD_SHARE = {"bf16": 2e-4, "bf16-mean30": 2e-4}


def _gn_bf16_inputs(kind, b, l, c, seed):
    """x (2 randn + 0.5, or 30 + randn for "bf16-mean30") and the FiLM
    parameters, rounded to bf16 (held in f32 for both sides)."""
    rng = np.random.default_rng(seed)
    x = _np(rng, b, l, c)
    x = x + 30.0 if kind == "bf16-mean30" else x * 2.0 + 0.5
    return [_bf16(a) for a in (x, _np(rng, c) * 0.1 + 1.0, _np(rng, c) * 0.1,
                               _np(rng, b, c) * 0.1, _np(rng, b, c) * 0.1)]


def _bf16_steps_np(got, want):
    """Largest |got - want| in bf16 steps of the larger value, taken at no
    less than gn_rows.STEP_FLOOR of the (batch, channel)'s largest |want|
    (the card's step count, gn_rows.bf16_steps)."""
    floor = gn_rows.STEP_FLOOR * np.abs(want).max(1, keepdims=True)
    scale = np.maximum(np.maximum(np.abs(got), np.abs(want)), floor)
    return float((np.abs(got - want) / _bf16_ulp(scale)).max())


_GN_FWD_CASES = [(8, 8, 200, "f32"), (64, 8, 200, "f32"), (64, 8, 77, "f32"), (16, 4, 33, "f32"),
                 (64, 8, 512, "bf16"), (64, 8, 512, "bf16-mean30")]


@pytest.mark.parametrize("c,groups,l,kind", _GN_FWD_CASES,
                         ids=[f"{c}-{g}-{l}" + ("" if k == "f32" else f"-{k}")
                              for c, g, l, k in _GN_FWD_CASES])
def test_groupnorm_film_silu_matches_jax(c, groups, l, kind):
    """C = 8 (one channel per group, the SR unet's first stage), C = 64, and
    ragged L (77, 33: not a multiple of the TPU block), in f32; and the
    bf16 cases (GN_BF16_SHARE): within one bf16 step, the share that
    differs bounded, on well-conditioned inputs and at mean 30. The port's
    plain version sums in the JAX kernel's block_l order (64 here)."""
    b = 2
    if kind != "f32":
        args = _gn_bf16_inputs(kind, b, l, c, seed=c + l)
        to_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        want = _o0(lambda *a: jax_gn(*[to_jax(t) for t in a], groups, 1e-5, 64, True), *args)
        want = np.asarray(want.astype(jnp.float32))
        got = port_gn.groupnorm_film_silu(*[_t(a).to(torch.bfloat16) for a in args],
                                          groups=groups, eps=1e-5, block_l=64).float().numpy()
        share = float((got != want).mean())
        assert share <= GN_BF16_SHARE[kind], f"{share:.4%} of the bf16 outputs differ"
        assert _bf16_steps_np(got, want) <= 1.0
        return
    rng = np.random.default_rng(c + l)
    x = _np(rng, b, l, c) * 2.0 + 0.5
    gamma = _np(rng, c) * 0.1 + 1.0
    beta = _np(rng, c) * 0.1
    scale = _np(rng, b, c) * 0.1
    shift = _np(rng, b, c) * 0.1
    want = _o0(lambda *a: jax_gn(*a, groups, 1e-5, 64, True), x, gamma, beta, scale, shift)
    got = port_gn.groupnorm_film_silu(*[_t(a) for a in (x, gamma, beta, scale, shift)],
                                      groups=groups, eps=1e-5, block_l=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_groupnorm_stats_and_no_film_match_jax():
    """mean/rstd outputs (per-channel broadcast, as the TPU kernel emits),
    and scale/shift absent == zeros."""
    rng = np.random.default_rng(11)
    b, l, c, g = 2, 50, 16, 4
    x, gamma, beta = _np(rng, b, l, c), _np(rng, c), _np(rng, c)
    zeros = np.zeros((b, c), np.float32)
    out, mean, rstd = _o0(lambda *a: jax_gn_fwd(*a, g, 1e-5, 64, True),
                          x, gamma, beta, zeros, zeros)
    got, gm, gr = port_gn.groupnorm_film_silu(_t(x), _t(gamma), _t(beta), None, None,
                                              groups=g, block_l=64, return_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(mean)[:, 0, :c], atol=ATOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(rstd)[:, 0, :c], atol=1e-4)


def test_groupnorm_hold_admits_the_jax_kernel_and_refuses_another_function():
    """The card's bf16 check of rows 3 and 4 (gn_rows.hold_fwd), here on the
    CPU: the JAX kernel -- one-pass f32 statistics, another f32
    implementation of the function -- passes it against the plain version;
    the unbiased variance, a function 1/n away, fails it."""
    b, l, c, groups = 2, 512, 64, 8
    args = [_t(a).to(torch.bfloat16) for a in _gn_bf16_inputs("bf16", b, l, c, seed=7)]
    compiled = {}

    def jax_run(x, gamma, beta, scale, shift, groups):
        ins = [jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
               for t in (x, gamma, beta, scale, shift)]
        if "f" not in compiled:
            compiled["f"] = jax.jit(lambda *a: jax_gn_fwd(*a, groups, 1e-5, 64, True)).lower(
                *ins).compile(compiler_options=_O0)
        y, mean, rstd = compiled["f"](*ins)
        return (_t(np.asarray(y.astype(jnp.float32))).to(torch.bfloat16),
                _t(np.asarray(mean)[:, 0, :c]), _t(np.asarray(rstd)[:, 0, :c]))

    m = gn_rows.measure_fwd(jax_run, port_gn, *args, groups)
    gn_rows.hold_fwd(m)
    assert m["share"] > 0  # the two f32 orders do differ somewhere

    def unbiased(x, gamma, beta, scale, shift, groups):
        xf = x.float().reshape(b, l, groups, c // groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        rstd = torch.rsqrt(xf.var(dim=(1, 3), keepdim=True, unbiased=True) + 1e-5)
        z = (((xf - mean) * rstd).reshape(b, l, c) * gamma.float() + beta.float()) * (
            scale.float()[:, None] + 1) + shift.float()[:, None]
        per_c = lambda t: t.reshape(b, groups, 1).expand(b, groups, c // groups).reshape(b, c)  # noqa: E731
        return (z * torch.sigmoid(z)).to(x.dtype), per_c(mean), per_c(rstd)

    with pytest.raises(AssertionError):
        gn_rows.hold_fwd(gn_rows.measure_fwd(unbiased, port_gn, *args, groups))


def test_groupnorm_near_constant_group_stays_finite():
    """A group whose values are all 100 but one in a thousand 100.5 (true
    rstd ~45): one-pass f32 statistics lose its variance to cancellation
    (E[x^2] - mean^2 = 0; below -eps it would be NaN), and the JAX kernel
    returns rsqrt(eps) = 316.2 there. The port's plain version follows the
    JAX kernel and clamps the variance at 0: finite, rstd = rsqrt(eps) as
    the JAX kernel's. Its f64 oracle keeps the true rstd. The card's kernel
    does the same as the plain version
    (tests/test_torch_port_cuda.py::test_groupnorm_kernel_clamps_a_near_constant_group)."""
    b, l, c, groups = 1, 1024, 16, 8
    x = _np(np.random.default_rng(0), b, l, c)
    flip = np.random.default_rng(1).random((b, l, 2)) < 1e-3
    x[..., :2] = np.where(flip, 100.5, 100.0)  # group 0: channels 0-1
    x = _bf16(x)
    ones, zeros = np.ones(c, np.float32), np.zeros(c, np.float32)
    zb = np.zeros((b, c), np.float32)
    to_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
    _, _, jax_rstd = _o0(lambda *a: jax_gn_fwd(*[to_jax(t) for t in a], groups, 1e-5, 64, True),
                         x, ones, zeros, zb, zb)
    y, _, rstd = port_gn.groupnorm_film_silu(_t(x), _t(ones), _t(zeros), None, None, groups,
                                             block_l=64, return_stats=True)
    _, _, orstd = port_gn.groupnorm_film_reference(_t(x), _t(ones), _t(zeros), None, None,
                                                   groups, 1e-5, return_stats=True,
                                                   work=torch.float64)
    assert torch.isfinite(y).all()
    np.testing.assert_allclose(rstd.numpy()[0, 0], 1e-5**-0.5, rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jax_rstd)[0, 0, 0], 1e-5**-0.5, rtol=1e-6)
    assert 20 < float(orstd[0, 0]) < 100


def test_groupnorm_kernel_plan_fits_the_grid():
    """The kernels' grid (port_gn.plan): every batch row at once on
    GRID_BLOCKS // b blocks; past GRID_BLOCKS rows, passes of a divisor of
    b; never more blocks than the card holds at once."""
    for b in (1, 2, 3, 4, 132, 133, 264, 1000):
        k, rows = port_gn.plan(b)
        assert b % rows == 0 and rows * k <= port_gn.GRID_BLOCKS and k >= 1
        if b <= port_gn.GRID_BLOCKS:
            assert (k, rows) == (port_gn.GRID_BLOCKS // b, b)


def test_groupnorm_map_follows_the_unet_structure():
    """probes/gn_rows.py's map, counted on meta tensors, gives chip_smoke.py's
    launch counts: row 3 at 54 / 66 sites per forward of unet 1 / 2 (twice
    per ResnetBlock3D) -- 16 (L, C) shapes, 32 at CFG batch 2 and 4 --, row
    4 the same sites per backward, row 9 the 44 / 19 fused sites."""
    pallas, fused = gn_rows.sites("pallas"), gn_rows.sites("fused")
    assert [sum(pallas[u].values()) for u in (1, 2)] == [54, 66]
    assert [sum(fused[u].values()) for u in (1, 2)] == [44, 19]
    shapes = gn_rows.all_shapes()
    assert [len(shapes[k]) for k in (gn_rows.FWD, gn_rows.BWD, gn_rows.ROW9)] == [32, 16, 9]
    assert sum(gn_rows.serve_step(4).values()) == 120
    assert max(shapes[gn_rows.FWD], key=lambda s: s[0] * s[1] * s[2]) == (4, 90 * 64 * 64, 64, 8)


# ---------------------------------------------------------- cross-attention
@pytest.mark.parametrize("m", [3, 7])  # SR unet (time + null), base unet (+4 video)
def test_cross_attention_matches_jax(m):
    rng = np.random.default_rng(m)
    b, n, h, d = 2, 100, 8, 64
    q, k, v = _np(rng, b, n, h, d), _np(rng, b, m, h, d), _np(rng, b, m, h, d)
    want = _o0(lambda q, k, v: jax_cross(q, k, v, sm_scale=d**-0.5, block_n=32, interpret=True),
               q, k, v)
    got = port_cross.cross_attention(_t(q), _t(k), _t(v), sm_scale=d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("m", [3, 7])
def test_cross_attention_plain_bf16_follows_the_jax_kernel(m):
    """bf16: the plain version computes ``fused_cross_attention``'s function
    (``_kernel``): f32 logits from the bf16 product, times sm_scale in f32,
    jax.nn.softmax in f32, p rounded to bf16, p v in f32, one rounding of
    the output. n = 300 is not a multiple of block_n. The two sides sum in
    another f32 order, so a probability now and then rounds to the
    neighbouring bf16 value: at most 0.5% of the outputs may differ, none
    by more than 2^-7 of the largest |output|."""
    rng = np.random.default_rng(40 + m)
    b, n, h, d = 2, 300, 8, 64
    q, k, v = (_bf16(_np(rng, b, s, h, d)) for s in (n, m, m))
    to_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)
    want = _o0(lambda q, k, v: jax_cross(to_jax(q), to_jax(k), to_jax(v), sm_scale=d**-0.5,
                                         block_n=128, interpret=True), q, k, v)
    want = np.asarray(want.astype(jnp.float32))
    bf = lambda a: _t(a).to(torch.bfloat16)
    got = port_cross.cross_attention(bf(q), bf(k), bf(v), sm_scale=d**-0.5).float().numpy()
    differ = got != want
    assert differ.mean() <= 5e-3, f"{differ.mean():.2%} of the bf16 outputs differ"
    gap = float(np.abs(got - want).max())
    assert gap <= 2.0**-7 * np.abs(want).max(), f"largest gap {gap:.3e}"


def _bf16_xattn_inputs(m, n=4096):
    g = torch.Generator().manual_seed(m)
    return tuple(torch.randn(2, s, 8, 64, generator=g).to(torch.bfloat16) for s in (n, m, m))


def _f32_logits(q, k, sm_scale, split=64):
    """q k^T * sm_scale in f32, the channels summed in steps of ``split``."""
    qf, kf = q.float(), k.float()
    return sum(torch.einsum("bnhd,bmhd->bhnm", qf[..., i:i + split], kf[..., i:i + split])
               for i in range(0, q.shape[-1], split)) * sm_scale


@pytest.mark.parametrize("m", [3, 7])
def test_cross_attention_bf16_hold_admits_another_f32_order_only(m):
    """The card's bf16 row-5 check (xattn_rows.hold_bf16), here on the CPU:
    the JAX kernel's function in another f32 order (logits in four
    16-channel steps as the tensor cores take them, p v key by key) passes
    it; the function without the rounding of p fails it."""
    q, k, v = _bf16_xattn_inputs(m)
    sc = 64**-0.5
    ref = port_cross.fused_cross_attention_reference(q, k, v, sc)
    s = _f32_logits(q, k, sc, split=16)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float().transpose(1, 2)
    other = sum(p[..., j, None] * v[:, j:j + 1].float() for j in range(m)).to(torch.bfloat16)
    res = xattn_rows.hold_bf16(other, ref, q, k, v, sc)
    assert res["worst_share"] <= 1.0 and res["steps"] <= 1.0
    unrounded = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), v.float())
    with pytest.raises(AssertionError):
        xattn_rows.hold_bf16(unrounded.to(torch.bfloat16), ref, q, k, v, sc)


def test_cross_attention_flip_window_covers_the_f32_error():
    """hold_bf16 grants a flip of p only where the f64 p lies within
    NEAR_MIDPOINT of a bf16 midpoint: more than three times the relative
    f32 error of p the plain version's order leaves at the serving widths."""
    q, k, _ = _bf16_xattn_inputs(7)
    sc = 64**-0.5
    s = _f32_logits(q, k, sc)
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p32 = (e / e.sum(-1, keepdim=True)).double()
    p64 = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q.double(), k.double()) * sc, -1)
    rel = float(((p32 - p64).abs() / p64).max())
    assert rel <= xattn_rows.NEAR_MIDPOINT / 3, f"relative f32 error of p {rel:.3e}"


# ------------------------------------------------------------ the wrappers
def test_kernel_records_name_source_and_tpu_origin():
    for mod in (port_flash, port_cross, port_gn):
        k = mod.KERNEL
        assert k.launches == 0  # CPU tensors never launch the kernel
        assert k.replaces.startswith("dalle2_video_tpu/ops/pallas/")
        assert (CSRC / k.source).exists()


def test_cpu_plain_path_does_not_count_launches():
    rng = np.random.default_rng(0)
    q = _t(_np(rng, 1, 8, 16))
    before = port_flash.KERNEL.launches
    port_flash.flash_mqa_fwd(q, q, q, sm_scale=0.25)
    assert port_flash.KERNEL.launches == before


@pytest.mark.parametrize("bad", ["rank", "dim"])
def test_wrappers_reject_bad_shapes(bad):
    x = torch.zeros(2, 4, 16)
    with pytest.raises(ValueError):
        if bad == "rank":
            port_flash.flash_mqa_fwd(x[0], x, x)
        else:
            port_gn.groupnorm_film_silu(torch.zeros(1, 4, 12), torch.ones(12),
                                        torch.zeros(12), groups=8)


# ------------------------------------------------------ backward versions
# JAX side: jax.grad through the differentiable Pallas entry points in
# interpret mode with the Pallas backward kernels (bwd_impl="pallas"). Port
# side: the plain backward versions, called directly and through the
# autograd Functions (which take them for CPU tensors). float32 throughout;
# the backward sums run over every query row (dk, dv) or key (dq) in
# another order, so the bound is 1e-4 absolute on gradients of magnitude
# ~1-10.
GRAD_ATOL = 1e-4


def _jax_flash_grads(q, k, v, g, scale, block):
    from dalle2_video_tpu.ops.pallas.flash_mqa import flash_mqa as jax_flash

    def f(q, k, v):
        out = jax_flash(q, k, v, sm_scale=scale, block_q=block, block_k=block,
                        interpret=True, bwd_impl="pallas", bwd_block_q=block,
                        bwd_block_k=block)
        return jnp.sum(out * g)

    return _o0(jax.grad(f, argnums=(0, 1, 2)), q, k, v)


@pytest.mark.parametrize("n_kv", [37, 130])  # ragged kv tails (n + 1 style)
def test_flash_bwd_plain_matches_pallas_backward(n_kv):
    rng = np.random.default_rng(20 + n_kv)
    d = 32
    q, k, v, g = _np(rng, 2, 96, d), _np(rng, 2, n_kv, d), _np(rng, 2, n_kv, d), _np(rng, 2, 96, d)
    scale = d**-0.5
    want = _jax_flash_grads(q, k, v, jnp.asarray(g), scale, 32)
    out, lse = port_flash.flash_mqa_fwd(_t(q), _t(k), _t(v), sm_scale=scale, save_lse=True)
    got = port_flash.flash_mqa_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(g), scale,
                                             chunk=40)  # chunks ragged too
    qt, kt, vt = (_t(a).requires_grad_() for a in (q, k, v))
    auto = torch.autograd.grad(port_flash.flash_mqa(qt, kt, vt, sm_scale=scale), (qt, kt, vt),
                               _t(g))
    for name, w, a, b in zip(("dq", "dk", "dv"), want, got, auto):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=name)
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-6, err_msg=name)


def test_flash_bwd_all_logits_below_minus_87():
    """Every real logit below -87, ragged n_kv = 37: the gradients stay
    finite and exact (P from the saved lse, never from a padded column)."""
    rng = np.random.default_rng(21)
    d = 16
    q = np.full((1, 8, d), 16.0, np.float32)
    k = np.full((1, 37, d), -2.0, np.float32) + 0.1 * _np(rng, 1, 37, d)
    v, g = _np(rng, 1, 37, d), _np(rng, 1, 8, d)
    scale = d**-0.5
    assert np.einsum("bnd,bmd->bnm", q * scale, k).max() < -87.0
    want = _jax_flash_grads(q, k, v, jnp.asarray(g), scale, 32)
    out, lse = port_flash.flash_mqa_fwd(_t(q), _t(k), _t(v), sm_scale=scale, save_lse=True)
    got = port_flash.flash_mqa_bwd_reference(_t(q), _t(k), _t(v), out, lse, _t(g), scale)
    for name, w, a in zip(("dq", "dk", "dv"), want, got):
        assert torch.isfinite(a).all(), name
        # |logit| ~ 124 carries f32 spacing ~8e-6: a few ulp of P's exponent
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=5e-4, err_msg=name)


@pytest.mark.parametrize("b", [2, 1])
def test_flash_bwd_plain_bf16_follows_the_jax_routing(b):
    """bf16 at b = 2, n_q = 256, ragged n_kv = 130: the JAX package's
    bwd_impl "auto" takes _bwd_pallas, which rounds the pre-scaled q, dS and
    P to bf16 before their products; at b = 1 it takes _bwd_xla_scan, all
    f32. The port's plain backward follows each: at most 1% of the values
    differ, none by more than 2^-7 of the largest. (All-f32 arithmetic
    differs from _bwd_pallas in about half of the values here.)
    Both sides get the same bf16 inputs and lse, and the port the bf16 out
    of its forward, as on the training path (``fwd_residuals``).
    _bwd_xla_scan recomputes the softmax and never reads out; at b = 1 the
    port's delta is rowsum(P * dP) as there (with rowsum(g * bf16 out) about
    12% of dq would differ), and its lse the exact f32 one (with the bf16
    forward's, from the rounded probabilities, about 9% of dq would)."""
    from dalle2_video_tpu.ops.pallas.flash_mqa import _bwd_pallas, _bwd_xla_scan

    rng = np.random.default_rng(40 + b)
    d, bf = 32, torch.bfloat16
    q, k, v, g = (_t(_np(rng, b, n, d)).to(bf) for n in (256, 130, 130, 256))
    scale = d**-0.5
    out, lse = port_flash.fwd_residuals(q, k, v, sm_scale=scale)
    assert port_flash.bwd_rounds(q) == (b == 2)
    j = lambda t: jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    if b == 2:
        want = _o0(lambda *a: _bwd_pallas(*a, sm_scale=scale, interpret=True, block_q=64,
                                          block_k=64),
                   j(q), j(k), j(v), j(out), lse.numpy()[..., None], j(g))
    else:
        want = _o0(lambda *a: _bwd_xla_scan(*a, sm_scale=scale, block_q=64), j(q), j(k), j(v),
                   j(g))
    got = port_flash.flash_mqa_bwd_reference(q, k, v, out, lse, g, scale, chunk=100)
    for name, w, a in zip(("dq", "dk", "dv"), want, got):
        assert a.dtype == bf, name
        w = np.asarray(w.astype(jnp.float32))
        diff = np.abs(a.float().numpy() - w)
        assert np.mean(diff > 0) <= 0.01, name
        assert diff.max() <= 2**-7 * np.abs(w).max(), name


_GN_BWD_CASES = [(8, 200, "f32"), (64, 77, "f32"), (64, 512, "bf16"), (64, 512, "bf16-mean30")]


@pytest.mark.parametrize("c,l,kind", _GN_BWD_CASES,  # C = 8 and C = 64, ragged L
                         ids=[f"{c}-{l}" + ("" if k == "f32" else f"-{k}")
                              for c, l, k in _GN_BWD_CASES])
def test_groupnorm_bwd_plain_matches_pallas_backward(c, l, kind):
    """All five gradients (x, gamma, beta, FiLM scale and shift) through
    the port's autograd Function, and dx / dA / dB of the plain backward,
    against jax.grad of the Pallas kernel pair in interpret mode; in bf16,
    dx through both autograds (GN_BF16_BWD_SHARE differ, within one bf16
    step)."""
    from dalle2_video_tpu.ops.pallas.groupnorm_film import _fold_ab

    b, groups = 2, 8
    if kind != "f32":
        args = _gn_bf16_inputs(kind, b, l, c, seed=30 + c + l)
        g = _bf16(_np(np.random.default_rng(c + l), b, l, c))
        to_jax = lambda a: jnp.asarray(a).astype(jnp.bfloat16)  # noqa: E731
        want = _o0(jax.grad(lambda *a: jnp.sum(
            jax_gn(*a, groups, 1e-5, 64, True).astype(jnp.float32) * jnp.asarray(g))),
            *[to_jax(a) for a in args])
        want = np.asarray(want.astype(jnp.float32))
        x = _t(args[0]).to(torch.bfloat16).requires_grad_()
        y = port_gn.groupnorm_film_silu(x, *[_t(a).to(torch.bfloat16) for a in args[1:]],
                                        groups=groups, eps=1e-5, block_l=64)
        got = torch.autograd.grad(y, x, _t(g).to(torch.bfloat16))[0].float().numpy()
        share = float((got != want).mean())
        assert share <= GN_BF16_BWD_SHARE[kind], f"{share:.4%} of the bf16 dx values differ"
        assert _bf16_steps_np(got, want) <= 1.0
        return
    rng = np.random.default_rng(30 + c)
    x = _np(rng, b, l, c) * 2.0 + 0.5
    gamma, beta = _np(rng, c) * 0.1 + 1.0, _np(rng, c) * 0.1
    scale, shift = _np(rng, b, c) * 0.1, _np(rng, b, c) * 0.1
    g = _np(rng, b, l, c)
    args = [jnp.asarray(a) for a in (x, gamma, beta, scale, shift)]
    want = _o0(jax.grad(lambda *a: jnp.sum(jax_gn(*a, groups, 1e-5, 64, True) * g),
                        argnums=(0, 1, 2, 3, 4)), *args)
    ins = [_t(a).requires_grad_() for a in (x, gamma, beta, scale, shift)]
    y = port_gn.groupnorm_film_silu(*ins, groups=groups, eps=1e-5, block_l=64)
    got = torch.autograd.grad(y, ins, _t(g))
    for name, w, a in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), want, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=name)
    _, mean, rstd = port_gn.groupnorm_film_silu(*[_t(a) for a in (x, gamma, beta, scale, shift)],
                                                groups=groups, block_l=64, return_stats=True)
    a_vec, b_vec = (torch.from_numpy(np.array(t[:, 0])) for t in _fold_ab(*args[1:]))
    torch.testing.assert_close(port_gn.fold_ab(*[_t(a) for a in (gamma, beta, scale, shift)],
                                               torch.float32, b), (a_vec, b_vec))
    dx, da, db = port_gn.groupnorm_film_bwd_reference(_t(x), _t(g), a_vec, b_vec, mean, rstd,
                                                      groups)
    np.testing.assert_allclose(dx.numpy(), np.asarray(want[0]), atol=GRAD_ATOL)
    # dgamma = sum_b dA (scale + 1), dshift = dB
    np.testing.assert_allclose((da * (_t(scale) + 1)).sum(0).numpy(), np.asarray(want[1]),
                               atol=GRAD_ATOL)
    np.testing.assert_allclose(db.numpy(), np.asarray(want[4]), atol=GRAD_ATOL)


def test_backward_kernel_records_and_cpu_grads_count_no_launch():
    for k in (port_flash.BWD_KERNEL, port_gn.BWD_KERNEL):
        assert k.replaces.startswith("dalle2_video_tpu/ops/pallas/")
        assert (CSRC / k.source).exists()
    rng = np.random.default_rng(1)
    q = _t(_np(rng, 1, 8, 16)).requires_grad_()
    x = _t(_np(rng, 1, 10, 8)).requires_grad_()
    before = {k.name: k.launches for k in _all_kernels()}
    port_flash.flash_mqa(q, q, q, sm_scale=0.25).sum().backward()
    port_gn.groupnorm_film_silu(x, torch.ones(8), torch.zeros(8)).sum().backward()
    assert q.grad is not None and x.grad is not None
    assert {k.name: k.launches for k in _all_kernels()} == before
    assert len(_all_kernels()) == 11


def _meta_calls():
    """Each raw kernel wrapper on meta tensors (stand-ins for CUDA ones)."""
    m = lambda *shape: torch.zeros(*shape, device="meta")
    q4, k4 = m(1, 4, 8, 64), m(1, 3, 8, 64)
    q, kv, lse = m(1, 8, 16), m(1, 5, 16), m(1, 8)
    x, c = m(1, 10, 8), m(8)
    bc = m(1, 8)
    cx, cw, cb = m(2, 4, 4, 64), m(64, 64, 3, 3), m(64)
    return {
        "cross_attention": ([q4], lambda: port_cross.cross_attention(q4, k4, k4, sm_scale=0.125)),
        "flash_mqa_fwd": ([q], lambda: port_flash.flash_mqa_fwd(q, kv, kv, sm_scale=0.25)),
        "flash_mqa_bwd": ([q], lambda: port_flash.flash_mqa_bwd(q, kv, kv, q, lse, q,
                                                                sm_scale=0.25)),
        "groupnorm_film_silu": ([x], lambda: port_gn.groupnorm_film_silu(
            x, c, c, groups=8, return_stats=True)),
        "groupnorm_film_bwd": ([x], lambda: port_gn.groupnorm_film_bwd(x, x, bc, bc, bc, bc, 8)),
        "conv3x3": ([cx], lambda: port_sc.conv3x3(cx, cw)),
        "conv3x3_wgrad": ([cx], lambda: port_sc.conv3x3_wgrad(cx, cx)),
        "conv_bias_stats": ([cx], lambda: port_fb.conv_bias_stats(cx, cw, cb, 1)),
    }


@pytest.mark.parametrize("name", ["cross_attention", "flash_mqa_fwd", "flash_mqa_bwd",
                                  "groupnorm_film_silu", "groupnorm_film_bwd", "conv3x3",
                                  "conv3x3_wgrad", "conv_bias_stats"])
def test_kernel_wrappers_refuse_grad_off_the_cpu(name):
    """A raw kernel call off the CPU whose input needs a gradient raises
    (meta tensors stand in for CUDA ones here) instead of returning a
    result with no grad_fn -- the forward-only cross-attention kernel, a
    forward called directly or with return_stats, a double backward.
    Without grad each goes on to the kernel's own device checks."""
    needs_grad, call = _meta_calls()[name]
    for t in needs_grad:
        t.requires_grad_()
    with pytest.raises(RuntimeError, match="not differentiable"):
        call()
    with torch.no_grad(), pytest.raises(ValueError, match="CUDA"):
        call()
