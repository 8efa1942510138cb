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

torch.set_num_threads(1)
ATOL = 2e-5


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
    want, want_lse = _flash_mqa_fwd_only(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=scale,
        block_q=64, block_k=64, interpret=True, save_lse=True)
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
    want, want_lse = _flash_mqa_fwd_only(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=scale,
        block_q=32, block_k=32, interpret=True, save_lse=True)
    got, lse = port_flash.flash_mqa_fwd(_t(q), _t(k), _t(v), sm_scale=scale,
                                        save_lse=True)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # lse ~ -124: f32 spacing there is ~8e-6, so 2e-5 is a few ulp too
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse)[..., 0], atol=5e-5)


def test_mqa_attention_heads_fold_matches_jax():
    """Port folds heads token-major (free reshape), JAX head-major: same
    result since every head shares the kv. n_kv = n + 1 (null kv)."""
    rng = np.random.default_rng(7)
    b, n, h, d = 2, 40, 4, 16
    q, k, v = _np(rng, b, n, h, d), _np(rng, b, n + 1, d), _np(rng, b, n + 1, d)
    want = jax_mqa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), sm_scale=d**-0.5,
                   block_q=32, block_k=32, interpret=True)
    got = port_flash.mqa_attention(_t(q), _t(k), _t(v), sm_scale=d**-0.5)
    assert got.shape == (b, n, h, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


# ---------------------------------------------------------------- GroupNorm
@pytest.mark.parametrize("c,groups,l", [(8, 8, 200), (64, 8, 200), (64, 8, 77), (16, 4, 33)])
def test_groupnorm_film_silu_matches_jax(c, groups, l):
    """C = 8 (one channel per group, the SR unet's first stage), C = 64, and
    ragged L (77, 33: not a multiple of the TPU block)."""
    rng = np.random.default_rng(c + l)
    b = 2
    x = _np(rng, b, l, c) * 2.0 + 0.5
    gamma = _np(rng, c) * 0.1 + 1.0
    beta = _np(rng, c) * 0.1
    scale = _np(rng, b, c) * 0.1
    shift = _np(rng, b, c) * 0.1
    args = [jnp.asarray(a) for a in (x, gamma, beta, scale, shift)]
    want = jax_gn(*args, groups, 1e-5, 64, True)
    got = port_gn.groupnorm_film_silu(*[_t(a) for a in (x, gamma, beta, scale, shift)],
                                      groups=groups, eps=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


def test_groupnorm_stats_and_no_film_match_jax():
    """mean/rstd outputs (per-channel broadcast, as the TPU kernel emits),
    and scale/shift absent == zeros."""
    rng = np.random.default_rng(11)
    b, l, c, g = 2, 50, 16, 4
    x, gamma, beta = _np(rng, b, l, c), _np(rng, c), _np(rng, c)
    zeros = np.zeros((b, c), np.float32)
    out, mean, rstd = jax_gn_fwd(jnp.asarray(x), jnp.asarray(gamma), jnp.asarray(beta),
                                 jnp.asarray(zeros), jnp.asarray(zeros), g, 1e-5, 64, True)
    got, gm, gr = port_gn.groupnorm_film_silu(_t(x), _t(gamma), _t(beta), None, None,
                                              groups=g, return_stats=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(out), atol=ATOL)
    np.testing.assert_allclose(gm.numpy(), np.asarray(mean)[:, 0, :c], atol=ATOL)
    np.testing.assert_allclose(gr.numpy(), np.asarray(rstd)[:, 0, :c], atol=1e-4)


# ---------------------------------------------------------- cross-attention
@pytest.mark.parametrize("m", [3, 7])  # SR unet (time + null), base unet (+4 video)
def test_cross_attention_matches_jax(m):
    rng = np.random.default_rng(m)
    b, n, h, d = 2, 100, 8, 64
    q, k, v = _np(rng, b, n, h, d), _np(rng, b, m, h, d), _np(rng, b, m, h, d)
    want = jax_cross(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     sm_scale=d**-0.5, block_n=32, interpret=True)
    got = port_cross.cross_attention(_t(q), _t(k), _t(v), sm_scale=d**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


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

    return jax.grad(f, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))


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


@pytest.mark.parametrize("c,l", [(8, 200), (64, 77)])  # C = 8 and C = 64, ragged L
def test_groupnorm_bwd_plain_matches_pallas_backward(c, l):
    """All five gradients (x, gamma, beta, FiLM scale and shift) through
    the port's autograd Function, and dx / dA / dB of the plain backward,
    against jax.grad of the Pallas kernel pair in interpret mode."""
    from dalle2_video_tpu.ops.pallas.groupnorm_film import _fold_ab

    rng = np.random.default_rng(30 + c)
    b, groups = 2, 8
    x = _np(rng, b, l, c) * 2.0 + 0.5
    gamma, beta = _np(rng, c) * 0.1 + 1.0, _np(rng, c) * 0.1
    scale, shift = _np(rng, b, c) * 0.1, _np(rng, b, c) * 0.1
    g = _np(rng, b, l, c)
    args = [jnp.asarray(a) for a in (x, gamma, beta, scale, shift)]
    want = jax.grad(lambda *a: jnp.sum(jax_gn(*a, groups, 1e-5, 64, True) * g),
                    argnums=(0, 1, 2, 3, 4))(*args)
    ins = [_t(a).requires_grad_() for a in (x, gamma, beta, scale, shift)]
    y = port_gn.groupnorm_film_silu(*ins, groups=groups, eps=1e-5)
    got = torch.autograd.grad(y, ins, _t(g))
    for name, w, a in zip(("dx", "dgamma", "dbeta", "dscale", "dshift"), want, got):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), atol=GRAD_ATOL, err_msg=name)
    _, mean, rstd = port_gn.groupnorm_film_silu(*[_t(a) for a in (x, gamma, beta, scale, shift)],
                                                groups=groups, return_stats=True)
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
    assert len(_all_kernels()) == 9


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
