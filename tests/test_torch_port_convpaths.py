"""The opt-in conv paths (``groupnorm_impl: fused``, ``spatial_conv_impl:
pallas_small``) against the JAX package.

On the CPU each port wrapper runs its plain PyTorch version; the JAX side
runs its Pallas kernels in interpret mode, as tests/test_pallas.py does
(the JAX modules pick interpret mode themselves on the CPU). Inputs come
from numpy with a fixed seed and are handed to both.

Tolerances, float32 throughout: outputs 3e-5 absolute and gradients 2e-4
(rtol and atol), tests/test_pallas.py's levels for these kernels -- the
same sums in another order. Where a test says otherwise, its docstring
gives the reason.
"""

from __future__ import annotations

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.models.layers import Block3D as JaxBlock3D, SpatialConv as JaxSpatialConv
from dalle2_video_tpu.models.unet3d import UNet3D as JaxUNet, UNet3DConfig as JaxUCfg
from dalle2_video_tpu.ops.pallas.fused_block import (
    _conv_bias_stats,
    fused_block3d as jax_fused_block3d,
)
from dalle2_video_tpu.ops.pallas.spatial_conv import (
    _wgrad_packed,
    conv3x3_spatial as jax_conv3x3_spatial,
    pack_kernel_matrix,
    pack_width,
    unpack_kernel_grad,
    unpack_width,
)
from dalle2_video_tpu_torch.models import layers
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.ops import fused_block as port_fb
from dalle2_video_tpu_torch.ops import spatial_conv as port_sc
from dalle2_video_tpu_torch.weights import load_from_jax

torch.set_num_threads(1)
ATOL = 3e-5
GRAD_TOL = 2e-4


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _oihw(w_hwio):
    return _t(np.asarray(w_hwio).transpose(3, 2, 0, 1))


# The JAX side's interpret-mode kernels make this file's time, most of it
# in XLA's CPU passes: compile at the lowest optimisation level (results
# agree with the default level to ~4e-7).
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


_COMPILED = {}


def _run_jax(fn, *args, key=None):
    """fn(*args), jitted and compiled at _O0 (kept under ``key`` for a
    second call with the same shapes)."""
    compiled = _COMPILED.get(key) if key is not None else None
    if compiled is None:
        compiled = jax.jit(fn).lower(*args).compile(compiler_options=_O0)
        if key is not None:
            _COMPILED[key] = compiled
    return compiled(*args)


def _value_and_vjp(f, args, g):
    """f(*args) and its vjp with cotangent g, in one function for _run_jax."""
    out, vjp = jax.vjp(f, *args)
    return out, vjp(g)


def _close(got, want, tol, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol,
                               err_msg=name)


# ------------------------------------------------------------ kernel 6 / 7
@pytest.mark.parametrize("c,co", [(16, 16), (16, 8)])  # Co == C and Co != C
def test_conv3x3_and_its_gradients_match_jax_packed_conv(c, co):
    """Forward: conv3x3 (plain on the CPU) vs the packed Pallas conv.
    Gradients: conv3x3_spatial's autograd (dx as the conv of the flipped,
    transposed weight, dW from conv3x3_wgrad) vs the JAX custom_vjp, whose
    dx and dW are the Pallas dgrad and wgrad kernels."""
    rng = np.random.default_rng(c + co)
    x, w, g = _np(rng, 2, 8, 16, c), _np(rng, 3, 3, c, co, scale=0.2), _np(rng, 2, 8, 16, co)
    f = lambda a, b: jax_conv3x3_spatial(a, b, True)
    want, (jdx, jdw) = _run_jax(lambda a, b, gg: _value_and_vjp(f, (a, b), gg),
                                *map(jnp.asarray, (x, w, g)))
    xt, wt = _t(x).requires_grad_(), _oihw(w).requires_grad_()
    got = port_sc.conv3x3_spatial(xt, wt)
    _close(got.detach(), want, ATOL)
    dx, dw = torch.autograd.grad(got, (xt, wt), _t(g))
    _close(dx, jdx, GRAD_TOL, "dx")
    _close(dw, np.asarray(jdw).transpose(3, 2, 0, 1), GRAD_TOL, "dw")


def test_conv3x3_wgrad_matches_jax_wgrad_kernel():
    """dW from the plain weight gradient vs the Pallas wgrad kernel's packed
    (12C, 2Co) sum folded back (unpack_kernel_grad); H = 12 is not a
    multiple of the TPU kernel's 8-row blocks."""
    rng = np.random.default_rng(5)
    n, h, wd, c, co = 3, 12, 8, 8, 16
    x, dy = _np(rng, n, h, wd, c), _np(rng, n, h, wd, co)
    db = _run_jax(lambda a, b: _wgrad_packed(pack_width(a), pack_width(b), interpret=True),
                  jnp.asarray(x), jnp.asarray(dy))
    want = np.asarray(unpack_kernel_grad(db, c, co)).transpose(3, 2, 0, 1)
    got = port_sc.conv3x3_wgrad(_t(x), _t(dy))
    assert got.dtype == torch.float32 and got.shape == (co, c, 3, 3)
    _close(got, want, GRAD_TOL)


# ---------------------------------------------------------------- kernel 8
@pytest.mark.parametrize("shape", [(180, 64, 64, 64, 64), (180, 32, 32, 128, 128),
                                   (180, 16, 16, 256, 256), (180, 8, 8, 512, 256),
                                   (180, 128, 128, 64, 64), (7, 9, 10, 64, 64),
                                   (3, 5, 70, 512, 64), (2, 13, 3, 64, 512),
                                   (180, 32, 32, 192, 128), (180, 16, 16, 384, 256),
                                   (180, 8, 8, 64, 64)])
def test_wgrad_plan_fits_the_kernel_and_keeps_sums_short(shape):
    """The bf16 weight-gradient kernel's plan (csrc/conv3x3_wgrad.cu stages
    a group of `rows` frame rows of a `seg`-column segment at a pitch of
    seg + 2 pixels, at most WGRAD_MAX_K of them, seg at most WGRAD_SEG,
    both built into the kernel from the wrapper's values): the groups cover
    every row and column, no split sums more than WGRAD_CHAIN pixels, and
    the (tile, split) blocks leave less than a split's tiles idle in their
    last wave of 132 (one block per SM) where the groups allow. The unet's
    stages, the cascade's 128 px, ragged and narrow frames."""
    n, h, w, c, co = shape
    rows, seg, groups, n_split = port_sc.wgrad_plan(n, h, w, c, co)
    assert 1 <= rows <= h and 1 <= seg <= min(w, port_sc.WGRAD_SEG)
    assert -(-rows * (seg + 2) // 16) * 16 <= port_sc.WGRAD_MAX_K
    assert groups == n * -(-h // rows) * -(-w // seg)
    assert 1 <= n_split <= groups
    assert -(-groups // n_split) * rows * seg <= port_sc.WGRAD_CHAIN
    tiles = (c // 64) * (co // 64)
    blocks = tiles * n_split
    assert blocks > -(-blocks // 132) * 132 - tiles or n_split == groups


def test_conv_plan_fits_the_kernel_and_covers_every_pixel_once():
    """The bf16 conv kernel's plan (csrc/conv3x3.cu: a block owns a
    CONV_BN-wide Co tile and walks every blocks_per_co-th tile; a tile is
    frames x rows x seg output pixels, staged with a halo row above and
    below and a one-pixel border at a pitch of seg + 2): at every (H, W, C,
    Co) of the conv paths and ragged ones, at 1, 2 and 4 batch rows, the
    tile fits the kernel's 8 warps of 64 pixels and its staged pixels the
    two-stage ring (which fits an SM's 227 KB beside the weights and the
    statistics fold; 128 f32 accumulators a thread), no tile straddles two
    batch rows, the tiles cover every output pixel exactly once, and the
    blocks -- at most one wave of 132 -- walk every tile of their Co tile
    exactly once."""
    sc = port_sc
    row = (sc.CONV_BK + 8) * 2  # a staged pixel's padded row, bytes
    smem = 2 * sc.CONV_STAGED * row + 2 * 9 * sc.CONV_BN * row + 8 * sc.CONV_BN * 2 * 4
    assert smem <= 227 * 1024 and sc.CONV_TILE == 8 * 64 and sc.CONV_TILE * sc.CONV_BN * 2 <= \
        sc.CONV_STAGED * row  # an x stage holds the rounded output tile
    assert 64 * sc.CONV_BN // 32 == 128
    shapes = [(h, w, c, co) for h, w, c, co in (
        (64, 64, 64, 64), (64, 64, 128, 64), (32, 32, 64, 64), (32, 32, 192, 128),
        (16, 16, 384, 256), (8, 8, 256, 256), (8, 8, 512, 512), (16, 16, 64, 64),
        (8, 8, 64, 64), (8, 8, 192, 128), (7, 9, 32, 64), (4, 160, 64, 64), (6, 20, 192, 64),
        (128, 128, 64, 64), (1, 1, 32, 64))]
    for (h, w, c, co), (batch, t) in [(s, bt) for s in shapes
                                       for bt in ((1, 180), (2, 90), (4, 90), (2, 3))]:
        n = batch * t
        p = sc.conv_plan(n, h, w, c, co, batch)
        assert 1 <= p.seg <= min(w, sc.CONV_SEG) and 1 <= p.rows <= h and 1 <= p.frames <= t
        assert p.frames * p.rows * p.seg <= sc.CONV_TILE
        assert p.frames * (p.rows + 2) * (p.seg + 2) <= sc.CONV_STAGED
        n_fg, n_rg, n_seg = -(-t // p.frames), -(-h // p.rows), -(-w // p.seg)
        assert p.tiles_per_row == n_fg * n_rg * n_seg
        n_co = co // sc.CONV_BN
        assert p.blocks % n_co == 0 and n_co <= p.blocks <= max(132, n_co)
        per_co, tiles = p.blocks // n_co, batch * p.tiles_per_row
        walked = sorted(t0 + k * per_co for t0 in range(per_co)
                        for k in range(-(-(tiles - t0) // per_co)))
        assert walked == list(range(tiles))
        cover = np.zeros((n, h, w), np.int32)
        for tile in range(tiles):  # the kernel's tile_at
            brow, rem = divmod(tile, p.tiles_per_row)
            rem, sg = divmod(rem, n_seg)
            fg, rg = divmod(rem, n_rg)
            f0 = brow * t + fg * p.frames
            f1 = min(f0 + p.frames, (brow + 1) * t)
            assert f0 < f1  # every tile holds pixels of its own batch row
            cover[f0:f1, rg * p.rows:(rg + 1) * p.rows, sg * p.seg:(sg + 1) * p.seg] += 1
        assert (cover == 1).all(), (h, w, c, co, batch, t, p)


def test_conv_bias_stats_matches_jax_epilogue():
    """y, and the per-(batch row, channel) sums of y and y^2 from the f32
    value: the JAX per-lane sums are folded over the pixel pair's two lanes.
    Sums over T*H*W = 384 values of magnitude ~5: 1e-4 absolute."""
    rng = np.random.default_rng(6)
    b, t, h, wd, c, co = 2, 3, 8, 16, 8, 16
    x, w = _np(rng, b * t, h, wd, c), _np(rng, 3, 3, c, co, scale=0.3)
    bias = _np(rng, co, scale=0.5)
    bias2 = jnp.tile(jnp.asarray(bias)[None, :], (1, 2))
    yp, s, ss = _run_jax(lambda a, m: _conv_bias_stats(pack_width(a), pack_kernel_matrix(m),
                                                       bias2, b, t, interpret=True),
                         jnp.asarray(x), jnp.asarray(w))
    fold = lambda v: np.asarray(v)[:, 0].reshape(b, 2, co).sum(1)
    y, gs, gss = port_fb.conv_bias_stats(_t(x), _oihw(w), _t(bias), b)
    _close(y, unpack_width(yp), ATOL, "y")
    _close(gs, fold(s), 1e-4, "sum")
    _close(gss, fold(ss), 1e-4 * float(np.abs(fold(ss)).max()), "sum of squares")


# ------------------------------------------------- fused block and modules
@pytest.mark.parametrize("film", [True, False])
def test_fused_block3d_forward_and_seven_gradients_match_jax(film):
    """Forward and the gradients of x, w, bias, gamma, beta, scale, shift
    (the closed-form dbias included) vs the JAX custom_vjp. Without FiLM
    the port takes None where the JAX block passes zeros."""
    rng = np.random.default_rng(7)
    b, t, h, wd, c, co, groups = 2, 2, 8, 8, 8, 16, 4
    x, w = _np(rng, b, t, h, wd, c), _np(rng, 3, 3, c, co, scale=0.2)
    vecs = [_np(rng, co, scale=0.1), 1 + _np(rng, co, scale=0.1), _np(rng, co, scale=0.2)]
    ss = [_np(rng, b, co, scale=0.1), _np(rng, b, co, scale=0.2)]
    if not film:
        ss = [np.zeros((b, co), np.float32)] * 2
    g = _np(rng, b, t, h, wd, co)
    f = lambda *a: jax_fused_block3d(*a, groups, 1e-5, True)
    want, jgrads = _run_jax(lambda jargs, gg: _value_and_vjp(f, jargs, gg),
                            [jnp.asarray(a) for a in (x, w, *vecs, *ss)], jnp.asarray(g),
                            key="fused_block3d")
    ins = [_t(x), _oihw(w)] + [_t(v) for v in vecs] + ([_t(a) for a in ss] if film else [])
    ins = [a.requires_grad_() for a in ins]
    args = ins + [None] * (7 - len(ins))
    got = port_fb.fused_block3d(*args, groups=groups, eps=1e-5)
    _close(got.detach(), want, ATOL)
    grads = torch.autograd.grad(got, ins, _t(g))
    names = ["dx", "dw", "dbias", "dgamma", "dbeta", "dscale", "dshift"]
    for name, gp, gj in zip(names, grads, jgrads):
        gj = np.asarray(gj)
        _close(gp, gj.transpose(3, 2, 0, 1) if name == "dw" else gj, GRAD_TOL, name)


def _redraw(params, seed, std=0.2):
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [(rng.standard_normal(l.shape) * std).astype(np.float32) for l in leaves])


def _param_grads_close(jgrads, tmod, tol, scale_floor=1.0):
    """Every parameter gradient of the port module vs the JAX tree's, each
    within tol of its own largest value (floored at scale_floor)."""
    from dalle2_video_tpu_torch.weights import params_from_jax

    want = params_from_jax(jax.tree_util.tree_map(np.asarray, jgrads))
    got = {k: p.grad for k, p in tmod.named_parameters()}
    assert set(want) == set(got)
    for k, wv in want.items():
        atol = tol * max(scale_floor, float(wv.abs().max()))
        np.testing.assert_allclose(got[k].numpy(), wv.numpy(), rtol=tol, atol=atol, err_msg=k)


@pytest.mark.parametrize("case", ["fused", "fallback"])
def test_block3d_fused_matches_jax_block(case):
    """Block3D(norm_impl="fused", conv_impl="pallas_small") vs its JAX twin
    on shared weights, with FiLM: at C = Co = 64, W = 8 the fused kernels
    run; at C = 8 (the SR unet's width) the block falls back to the plain
    conv and GroupNorm on both sides. Forward, input and parameter
    gradients; the port's routing is checked by counting calls."""
    c, co = (64, 64) if case == "fused" else (8, 16)
    rng = np.random.default_rng(8)
    b, t, h, wd = 2, 2, 8, 8
    x, g = _np(rng, b, t, h, wd, c), _np(rng, b, t, h, wd, co)
    ss = (_np(rng, b, co, scale=0.1), _np(rng, b, co, scale=0.1))
    jb = JaxBlock3D(co, groups=8, norm_impl="fused", conv_impl="pallas_small")
    # the param tree is the same on every impl: take its shapes from the
    # plain block, which traces faster
    params = _redraw(jax.eval_shape(JaxBlock3D(co, groups=8).init, jax.random.PRNGKey(0),
                                    jnp.asarray(x), tuple(map(jnp.asarray, ss))), 9, std=0.1)
    jss = tuple(map(jnp.asarray, ss))
    want, (jgx, jgp) = _run_jax(
        lambda xx, pp, gg: _value_and_vjp(lambda a, q: jb.apply(q, a, jss), (xx, pp), gg),
        jnp.asarray(x), params, jnp.asarray(g))
    tb = load_from_jax(layers.Block3D(c, co, 8, norm_impl="fused", conv_impl="pallas_small"),
                       params)
    xt = _t(x).requires_grad_()
    with mock.patch.object(layers, "fused_block3d", wraps=layers.fused_block3d) as spy:
        got = tb(xt, tuple(map(_t, ss)))
    assert spy.call_count == int(case == "fused")
    _close(got.detach(), want, ATOL)
    got.backward(_t(g))
    _close(xt.grad, jgx, GRAD_TOL, "dx")
    _param_grads_close(jgp, tb, GRAD_TOL)


@pytest.mark.parametrize("hw,c,routed", [(8, 64, True), (32, 64, False), (8, 32, False)])
def test_spatial_conv_pallas_small_matches_jax(hw, c, routed):
    """SpatialConv(impl="pallas_small") vs its JAX twin: an 8x8 site at
    C = 64 takes the conv kernel (then the plain conv's backward); 32x32
    (h*w > 256) and C = 32 fall back to the plain conv on both sides."""
    rng = np.random.default_rng(hw + c)
    x, g = _np(rng, 1, 2, hw, hw, c), _np(rng, 1, 2, hw, hw, 64)
    jc = JaxSpatialConv(64, 3, impl="pallas_small")
    params = _redraw(jax.eval_shape(JaxSpatialConv(64, 3).init, jax.random.PRNGKey(1),
                                    jnp.asarray(x)), 10, 0.1)
    want, (jgp,) = _run_jax(
        lambda pp, gg: _value_and_vjp(lambda q: jc.apply(q, jnp.asarray(x)), (pp,), gg),
        params, jnp.asarray(g))
    tc = load_from_jax(layers.SpatialConv(c, 64, 3, impl="pallas_small"), params)
    with mock.patch.object(layers, "conv3x3_spatial_xbwd",
                           wraps=layers.conv3x3_spatial_xbwd) as spy:
        got = tc(_t(x))
    assert spy.call_count == int(routed)
    _close(got.detach(), want, ATOL)
    got.backward(_t(g))
    # a gradient sums up to 2*hw*hw products of magnitude ~1
    _param_grads_close(jgp, tc, GRAD_TOL)


# ----------------------------------------------------------- small unet
# dim 64 with a 320-wide second stage: in f32 its 3x3 sites exceed the
# fused bound (12*C*2*Co*4 bytes > 8 MiB) and take pallas_small, the
# 64-wide ones take the fused block, and the 32- and 96-wide ones (init_dim
# 32 and its skips) fall back to the plain conv and GroupNorm. No resnet
# blocks beyond each stage's first: the JAX side's compile of the
# interpret-mode kernels is most of this file's time.
SMALL = dict(dim=64, init_dim=32, dim_mults=(1, 5), num_resnet_blocks=0, attn_heads=2,
             attn_dim_head=8, cond_on_video_embeds=True, video_embed_dim=16)
KNOBS = dict(groupnorm_impl="fused", spatial_conv_impl="pallas_small")


def _small_inputs():
    rng = np.random.default_rng(11)
    x = _np(rng, 2, 2, 16, 16, 3)
    ve = _np(rng, 2, 16)
    target = _np(rng, 2, 2, 16, 16, 3)
    return x, np.array([10, 700], np.int32), ve, np.array([True, False]), target


@pytest.fixture(scope="module")
def small_unet():
    x, time, ve, keep, target = _small_inputs()
    ju = JaxUNet(JaxUCfg(**SMALL, **KNOBS))
    jargs = dict(video_embed=jnp.asarray(ve), video_keep_mask=jnp.asarray(keep))
    # shapes from the plain unet (same param tree, faster to trace)
    params = _redraw(jax.eval_shape(JaxUNet(JaxUCfg(**SMALL)).init, jax.random.PRNGKey(0),
                                    jnp.asarray(x), jnp.asarray(time), **jargs), 12, std=0.05)

    def loss(p):
        out = ju.apply(p, jnp.asarray(x), jnp.asarray(time), **jargs)
        return jnp.mean((out - target) ** 2), out

    (jloss, jout), jgrads = _run_jax(jax.value_and_grad(loss, has_aux=True), params)
    return params, (jloss, jout, jgrads)


def test_small_unet_conv_paths_match_jax(small_unet):
    """The UNet3D with both knobs vs the JAX UNet3D with both knobs (Pallas
    in interpret mode): forward and one loss's parameter gradients. The
    port's routing counts: 4 fused blocks (the 64-wide sites), 6
    pallas_small convs (the 320-wide mid and up blocks), and 4 plain.
    Outputs 2e-4 of their scale (layers of convs, attention and norms, as
    tests/test_torch_port_modules.py); gradients 2e-3 of each tensor's
    largest value, through ~20 layers of f32 sums in another order."""
    params, (jloss, jout, jgrads) = small_unet
    x, time, ve, keep, target = _small_inputs()
    tu = load_from_jax(UNet3D(UNet3DConfig(**SMALL, **KNOBS)), params)
    with mock.patch.object(layers, "fused_block3d", wraps=layers.fused_block3d) as fused, \
            mock.patch.object(layers, "conv3x3_spatial_xbwd",
                              wraps=layers.conv3x3_spatial_xbwd) as small:
        out = tu(_t(x), torch.from_numpy(time).long(), video_embed=_t(ve),
                 video_keep_mask=torch.from_numpy(keep))
    assert (fused.call_count, small.call_count) == (4, 6)
    scale = max(1.0, float(np.abs(np.asarray(jout)).max()))
    _close(out.detach(), jout, 2e-4 * scale)
    loss = ((out - _t(target)) ** 2).mean()
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    loss.backward()
    _param_grads_close(jgrads, tu, 2e-3, scale_floor=1e-3)


def test_jax_params_load_into_conv_path_and_plain_unets(small_unet):
    """The conv paths add no parameter: one JAX tree loads strictly into the
    fused/pallas_small UNet3D and into the plain one, and both give the same
    output (on the CPU both run plain math)."""
    params = small_unet[0]
    x, time, ve, keep, _ = _small_inputs()
    fast = load_from_jax(UNet3D(UNet3DConfig(**SMALL, **KNOBS)), params)
    plain = load_from_jax(UNet3D(UNet3DConfig(**SMALL)), params)
    assert fast.state_dict().keys() == plain.state_dict().keys()
    with torch.no_grad():
        args = (_t(x), torch.from_numpy(time).long())
        kw = dict(video_embed=_t(ve), video_keep_mask=torch.from_numpy(keep))
        torch.testing.assert_close(fast(*args, **kw), plain(*args, **kw), atol=2e-5, rtol=0)


# ------------------------------------------------- the slice's site count
def _count_sites(unet_cfg, frames, size, dtype):
    """Route one forward of the unet on meta tensors (shapes only) and count
    its Block3D sites by path: fused, pallas_small conv + plain GroupNorm,
    plain conv + plain GroupNorm."""
    with torch.device("meta"):
        unet = UNet3D(unet_cfg).to(dtype)
    counts = {"fused": 0, "pallas_small": 0, "plain_gn": 0}

    def fused(x, w, *a, **k):
        counts["fused"] += 1
        return x.new_empty(*x.shape[:-1], w.shape[0])

    def small(x, w):
        counts["pallas_small"] += 1
        return x.new_empty(*x.shape[:-1], w.shape[0])

    def plain_gn(x, *a, **k):
        counts["plain_gn"] += 1
        return torch.empty_like(x)

    b = 2
    x = torch.empty(b, frames, size, size, 3, device="meta", dtype=dtype)
    kw = {}
    if unet_cfg.cond_on_video_embeds:
        kw.update(video_embed=torch.empty(b, unet_cfg.video_embed_dim, device="meta",
                                          dtype=dtype))
    if unet_cfg.lowres_cond:
        kw.update(lowres_cond_video=torch.empty_like(x))
    if unet_cfg.lowres_noise_cond:
        kw.update(lowres_noise_level=torch.zeros(b, dtype=torch.long, device="meta"))
    with mock.patch.object(layers, "fused_block3d", fused), \
            mock.patch.object(layers, "conv3x3_spatial_xbwd", small), \
            mock.patch.object(layers, "groupnorm_film_silu_as_jax", plain_gn), \
            torch.no_grad():
        unet(x, torch.zeros(b, dtype=torch.long, device="meta"), **kw)
    return counts


def test_slice_sites_follow_the_unet_structure():
    """The full-width celebv_text cascade at 90 frames, bf16, both knobs:
    the sites of each unet's forward are the launch counts chip_smoke.py
    holds the card to (kernel 8 per fused site, kernel 6 per pallas_small
    site; the rest plain)."""
    from dalle2_video_tpu_torch.engine import decoder
    from dalle2_video_tpu_torch.utils.config import load_config

    over = [f"unet{u}.{k}={v}" for u in (1, 2) for k, v in KNOBS.items()]
    cfg = load_config(None, ["frame_numbers=[90,90]", *over])
    # the cascade's unet configs as build_decoder resolves them; the unets
    # themselves are built below on the meta device
    with mock.patch.object(decoder, "UNet3D", lambda c: torch.nn.Identity()):
        cfgs = decoder.build_decoder(cfg, "cpu").unet_configs
    assert [c.spatial_conv_impl for c in cfgs] == ["pallas_small"] * 2
    assert _count_sites(cfgs[0], 90, 64, torch.bfloat16) == dict(fused=44, pallas_small=7,
                                                                 plain_gn=10)
    assert _count_sites(cfgs[1], 90, 128, torch.bfloat16) == dict(fused=19, pallas_small=0,
                                                                  plain_gn=47)
