"""Serving's request options against the JAX package: the broadcast
cross-attention and the skip norm, negative prompts, inpainting by
replacement and by reconstruction guidance in the DDPM, DDIM and DPM++
loops, chunked cascade sampling, long video, and the serving callable.

Same recipe as tests/test_torch_port_slice.py: JAX parameters redrawn from
a seeded normal (the zero-initialised output conv would make the unet
ignore its input) and carried across with ``weights.load_from_jax``; the
JAX samplers compiled at XLA's lowest optimisation level; every random draw
of a JAX run (x_T, each step's noise, each step's known-region noise)
recomputed from its key tree with dalle2_video_tpu.utils.keys and injected
into the port, whose loops then compute the same function.

Tolerances: modules 2e-4 absolute in f32 (as the modules file), bf16 held
as a share of differing values (at most 1%) and one bf16 step of the
output's scale (as PR 3's bf16 attention test). Samples 2e-3 absolute on
videos in [0, 1], as the slice file: the first DDIM step at t = 999 scales
the f32 disagreement of one forward by ~1/sqrt(a-bar) ~ 1e2. The known
region under replacement is exact up to the normalisation's round trip
(1e-6).
"""

from __future__ import annotations

import functools
import logging
import unittest.mock as mock
from concurrent.futures import wait

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.engine.dalle2video import DALLE2Video as JaxD2V
from dalle2_video_tpu.engine.decoder import (
    VideoDecoder as JaxDecoder,
    VideoDecoderConfig as JaxDecoderConfig,
    ddim_time_pairs,
)
from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
from dalle2_video_tpu.models.prior import DiffusionPriorConfig as JaxPriorConfig
from dalle2_video_tpu.models.prior import PriorNetworkConfig as JaxPriorNetCfg
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.prior import (
    DiffusionPrior,
    DiffusionPriorConfig,
    PriorNetworkConfig,
)
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.ops.video import resize_video
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import load_from_jax

torch.set_num_threads(1)

D = 16  # prior / video embed dim
UNET = dict(dim=8, dim_mults=(1,), num_resnet_blocks=1, attn_heads=2, attn_dim_head=8,
            resnet_groups=4, init_cross_embed=False, init_conv_ksize=3, video_embed_dim=D)
# one stage, 10 timesteps: DDPM runs all 10, DDIM and DPM++ 3. The unets
# predict v: an eps-predicting random unet drives nearly every value into
# the clip (x0 = (x - sqrt(1 - a-bar) eps) / sqrt(a-bar)), v keeps ~80% of
# them inside (0, 1), so the comparison sees the values
STAGE = dict(frame_sizes=(8,), frame_numbers=(2,), timesteps=10, sample_timesteps=(3,),
             learned_variance=False, predict_v=True)
# the cascade: 4 frames at 8 px, then 16 px
CASCADE = dict(frame_sizes=(8, 16), frame_numbers=(4, 4), timesteps=1000,
               sample_timesteps=(2, 2), learned_variance=False, predict_v=True)
PRIOR_NET = dict(dim=D, depth=1, heads=2, dim_head=8)
N_CAND = 2
COND_SCALE = 3.0
ATOL = 2e-3

_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


def redraw(tree, seed, std):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        td, [jnp.asarray(rng.standard_normal(l.shape) * std, jnp.float32) for l in leaves])


def t_(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _decoders(knobs: tuple):
    """A JAX decoder with redrawn parameters and the port's on the same
    weights, for the config ``knobs`` (items of VideoDecoderConfig)."""
    kw = dict(knobs)
    n = len(kw["frame_sizes"])
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET),) * n, **kw))
    params = redraw(jax.eval_shape(jdec.init_params, jax.random.PRNGKey(0)), 1, 0.15)
    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),) * n, **kw),
                       device=torch.device("cpu"))
    for i, unet in enumerate(dec.unets):
        load_from_jax(unet, params[f"unet_{i}"])
    return jdec, params, dec


def _stage_draws(rng, shape, n_steps: int, sampler: str):
    """x_T, each step's noise and known-region noise that a JAX loop draws
    from its stage key (decoder.py sample_stage -> p_sample_loop_*), the
    per-step draws stacked on a leading step axis (a scan keeps the replay's
    program small)."""
    _, k_loop = jkeys.split(rng)
    k_init, key = jkeys.split(k_loop)

    def step(key, _):
        if sampler == "dpmpp":
            key, k_known = jkeys.split(key)
            return key, (jnp.zeros(()), jkeys.normal(k_known, shape))
        key, k_noise, k_known = jkeys.split(key, 3)
        return key, (jkeys.normal(k_noise, shape), jkeys.normal(k_known, shape))

    _, (steps, known) = jax.lax.scan(step, key, None, length=n_steps)
    return jkeys.normal(k_init, shape), (None if sampler == "dpmpp" else steps), known


def _cascade_draws(rng, b: int, cfg: dict):
    """decoder.sample's per-stage draws: (init_noises, known_noises)."""
    inits, knowns = [], []
    for i, k in enumerate(jkeys.split(rng, len(cfg["frame_sizes"]))):
        s, t = cfg["frame_sizes"][i], cfg["frame_numbers"][i]
        n = len(ddim_time_pairs(cfg["timesteps"], cfg["sample_timesteps"][i]))
        x_t, _, known = _stage_draws(k, (b, t, s, s, 3), n, "ddim")
        inits.append(x_t)
        knowns.append(known)
    return inits, knowns


def _prior_noise(k_prior, b: int):
    """The prior's best-of-N x_T from its key (candidate j: fold_in(k, j))."""
    cand = jax.vmap(lambda k: jnp.stack([jax.random.fold_in(k, j)
                                         for j in range(N_CAND)]))(k_prior)
    k_init, _ = jkeys.split(cand.reshape((b * N_CAND,) + cand.shape[2:]))
    return jkeys.normal(k_init, (b * N_CAND, D))


def replay(fn, rng, *static):
    """A key-tree replay as one compiled program (op by op, each new shape
    compiles on its own), its draws as torch tensors."""
    return jax.tree_util.tree_map(t_, _jit(lambda r: fn(r, *static), rng))


@functools.lru_cache(maxsize=1)
def _priors():
    jprior = JaxPrior(JaxPriorConfig(network=JaxPriorNetCfg(**PRIOR_NET), sample_timesteps=2))
    params = redraw(jax.eval_shape(jprior.init_params, jax.random.PRNGKey(1)), 2, 0.3)
    prior = DiffusionPrior(DiffusionPriorConfig(network=PriorNetworkConfig(**PRIOR_NET),
                                                sample_timesteps=2), device=torch.device("cpu"))
    load_from_jax(prior.network, params)
    return jprior, params, prior


def _inputs(b, t, s, seed=5):
    rng = np.random.default_rng(seed)
    embed = rng.standard_normal((b, D)).astype(np.float32)
    known = rng.random((b, t, s + 3, s + 3, 3)).astype(np.float32)  # resized to s
    mask = np.zeros((1, t, 1, 1, 1), np.float32)
    mask[:, : t // 2] = 1.0  # video extension: the leading frames known
    return embed, known, mask


def _hold(got, want, atol=ATOL):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=atol)
    inside = (want > 0.0) & (want < 1.0)  # not vacuous: values off the clip
    assert int(inside.sum()) > 0.5 * want.size


def _hold_known(got, known, frames: int):
    """The known frames of a sample are the known video resized nearest to
    its size, up to the normalisation's round trip."""
    want = resize_video(t_(known), got.shape[2], clamp_range=(0.0, 1.0)).numpy()
    np.testing.assert_allclose(got[:, :frames], want[:, :frames], atol=1e-6)


# ------------------------------------------------------------------ layers
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_broadcast_cross_attention_matches_jax(dtype, masked):
    """CrossAttention(impl="broadcast") against the jitted JAX module on
    the same weights and inputs, with and without a context mask (one row
    masks every context token: only the null token is left). dim_head 24
    makes the scale round in bf16. f32: 2e-4; bf16: the port rounds where
    the jitted program does (ops/cross_attention.py::broadcast_cross_attention),
    so at most 1% of the values differ, none by more than one bf16 step of
    the output's scale."""
    from dalle2_video_tpu.models.layers import CrossAttention as JaxXAttn
    from dalle2_video_tpu_torch.models.layers import CrossAttention

    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 300, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    mask = np.array([[1, 1, 0, 1, 0, 1], [0] * 6], bool) if masked else None
    jm = JaxXAttn(64, context_dim=32, heads=4, dim_head=24, impl="broadcast")
    params = redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                                   jnp.asarray(ctx)), 5, 0.5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = [jnp.asarray(x, jdt), jnp.asarray(ctx, jdt)] + ([] if mask is None
                                                          else [jnp.asarray(mask)])
    want = np.asarray(_jit(jm.apply, jax.tree_util.tree_map(lambda a: a.astype(jdt), params),
                           *args).astype(jnp.float32))
    tm = load_from_jax(CrossAttention(64, 32, heads=4, dim_head=24, impl="broadcast"),
                       params).to(tdt)
    with torch.no_grad():
        got = tm(torch.from_numpy(x).to(tdt), torch.from_numpy(ctx).to(tdt),
                 None if mask is None else torch.from_numpy(mask)).float().numpy()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-4)
        return
    assert np.mean(got != want) <= 0.01, f"{np.mean(got != want):.2%} of the values differ"
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-7 * np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_skip_norm_block_matches_jax(dtype):
    """Block3D(norm_impl="skip"): conv, the norm's affine with no
    statistics, FiLM, SiLU, op by op in the activation dtype, with and
    without FiLM, against the jitted JAX block (same parameter names)."""
    from dalle2_video_tpu.models.layers import Block3D as JaxBlock
    from dalle2_video_tpu_torch.models.layers import Block3D

    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 2, 4, 4, 8)).astype(np.float32)
    sc, sh = (rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2))
    jb = JaxBlock(16, groups=4, norm_impl="skip")
    params = redraw(jax.eval_shape(jb.init, jax.random.PRNGKey(0), jnp.asarray(x)), 3, 0.5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tb = load_from_jax(Block3D(8, 16, 4, norm_impl="skip"), params).to(tdt)
    for film in (None, (sc, sh)):
        jfilm = None if film is None else tuple(jnp.asarray(a, jdt) for a in film)
        want = np.asarray(_jit(jb.apply, jax.tree_util.tree_map(lambda a: a.astype(jdt), params),
                               jnp.asarray(x, jdt), jfilm).astype(jnp.float32))
        with torch.no_grad():
            got = tb(torch.from_numpy(x).to(tdt),
                     None if film is None else tuple(torch.from_numpy(a).to(tdt) for a in film))
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, atol=2e-4)
        else:
            assert np.mean(got != want) <= 0.01
            np.testing.assert_allclose(got, want, rtol=0, atol=2**-7 * np.abs(want).max())


# ------------------------------------------------------------- the decoder
def test_unet_apply_with_negative_embed_matches_jax():
    """Under CFG the baseline half is the negative embed, broadcast from
    (1, d) and kept, in place of the learned null: one forward against
    JAX's, and the two-pass algebra neg + (cond - neg) * scale."""
    jdec, params, dec = _decoders(tuple(STAGE.items()))
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 2, 8, 8, 3)).astype(np.float32)
    t = np.array([9, 4], np.int32)
    embed, _, _ = _inputs(2, 2, 8)
    neg = rng.standard_normal((1, D)).astype(np.float32)
    want = np.asarray(_jit(lambda p, x, t, e, n: jdec._unet_apply(
        0, p, x, t, cond_scale=COND_SCALE, video_embed=e, negative_video_embed=n),
        params["unet_0"], jnp.asarray(x), jnp.asarray(t), jnp.asarray(embed), jnp.asarray(neg)))
    with torch.no_grad():
        got = dec._unet_apply(0, t_(x), t_(t).long(), cond_scale=COND_SCALE,
                              video_embed=t_(embed), negative_video_embed=t_(neg))
        cond = dec._unet_apply(0, t_(x), t_(t).long(), video_embed=t_(embed))
        base = dec._unet_apply(0, t_(x), t_(t).long(), video_embed=t_(neg).expand(2, D))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
    torch.testing.assert_close(got, base + (cond - base) * COND_SCALE, atol=1e-5, rtol=0)
    assert np.abs(want).mean() > 0.1  # the redrawn output conv is not zero


@pytest.mark.parametrize("loop,method", [("ddim", "replace"), ("ddim", "guided"),
                                         ("ddpm", "replace"), ("ddpm", "guided")])
def test_inpaint_stage_matches_jax(loop, method):
    """One stage (DDIM 3 steps, or DDPM over all 10 timesteps) with CFG
    and inpainting, the first of two frames known: replacement, or VDM
    eq. 7 reconstruction guidance (weight 10, the gradient through the
    unet). The known video is resized to the stage's 8 px; the known frame
    of the output is the resized video (guidance also replaces)."""
    knobs = dict(STAGE, sample_timesteps=(3,) if loop == "ddim" else None)
    jdec, params, dec = _decoders(tuple(knobs.items()))
    b, shape = 2, (2, 2, 8, 8, 3)
    embed, known, mask = _inputs(b, 2, 8)
    rng = jax.random.PRNGKey(21)
    n = 3 if loop == "ddim" else 10
    x_t, steps, knowns = replay(_stage_draws, rng, shape, n, "ddim")
    want = np.asarray(_jit(lambda p, k, e, v, m: jdec.sample_stage(
        0, p, k, batch_size=b, video_embed=e, cond_scale=COND_SCALE, inpaint_video=v,
        inpaint_mask=m, inpaint_method=method),
        params, rng, jnp.asarray(embed), jnp.asarray(known), jnp.asarray(mask)))
    got = dec.sample_stage(0, RowKeys([0, 1]), batch_size=b, video_embed=t_(embed),
                           cond_scale=COND_SCALE, inpaint_video=t_(known),
                           inpaint_mask=t_(mask), inpaint_method=method,
                           init_noise=x_t, step_noises=steps, known_noises=knowns).numpy()
    _hold(got, want)
    _hold_known(got, known, 1)


@pytest.mark.parametrize("method", [None, "replace", "guided"])
def test_dpmpp_stage_matches_jax(method):
    """DPM-Solver++(2M), 3 steps (first order on the first and the last),
    with host-side float64 coefficients, alone and with inpainting."""
    jdec, params, dec = _decoders(tuple(dict(STAGE, sampler="dpmpp").items()))
    b, shape = 2, (2, 2, 8, 8, 3)
    embed, known, mask = _inputs(b, 2, 8)
    rng = jax.random.PRNGKey(22)
    x_t, _, knowns = replay(_stage_draws, rng, shape, 3, "dpmpp")
    if method is None:
        want = _jit(lambda p, k, e: jdec.sample_stage(
            0, p, k, batch_size=b, video_embed=e, cond_scale=COND_SCALE),
            params, rng, jnp.asarray(embed))
        inp = {}
    else:
        want = _jit(lambda p, k, e, v, m: jdec.sample_stage(
            0, p, k, batch_size=b, video_embed=e, cond_scale=COND_SCALE, inpaint_video=v,
            inpaint_mask=m, inpaint_method=method),
            params, rng, jnp.asarray(embed), jnp.asarray(known), jnp.asarray(mask))
        inp = dict(inpaint_video=t_(known), inpaint_mask=t_(mask), inpaint_method=method)
    got = dec.sample_stage(0, RowKeys([0, 1]), batch_size=b, video_embed=t_(embed),
                           cond_scale=COND_SCALE, init_noise=x_t, known_noises=knowns,
                           **inp).numpy()
    _hold(got, np.asarray(want))
    if method is not None:
        _hold_known(got, known, 1)


def test_dpmpp_coefficients_first_order_at_both_ends():
    """The host-side coefficients: first order at both ends, and at the
    terminal step (t_next = -1, lambda = +inf) coef_x = 0, coef_d = 1, so
    x equals its data prediction (as the DDIM loop's last step)."""
    from dalle2_video_tpu_torch.engine.decoder import ddim_time_pairs as pairs_of
    from dalle2_video_tpu_torch.engine.decoder import dpmpp_coefficients

    _, _, dec = _decoders(tuple(dict(STAGE, sampler="dpmpp").items()))
    pairs = pairs_of(10, 3)
    c = dpmpp_coefficients(dec.schedules[0].alphas_cumprod.numpy(), pairs)
    assert c.dtype == np.float32 and c.shape == (3, 5)
    assert c[-1, 0] == 0.0 and c[-1, 1] == 1.0 and c[-1, 4] == 1.0
    assert c[0, 2] == 0.0 and c[-1, 2] == 0.0 and c[1, 2] != 0.0


def test_chunked_cascade_with_shared_mask_and_negative_matches_jax():
    """decoder.sample over the two-stage cascade with a (1, ...) mask and a
    (1, d) negative embed shared by every row, chunked by max_batch_size=2
    over 3 rows (spans (0, 2), (2, 1)): each row keeps its key, so it
    equals the JAX package's unchunked run with per-row keys (and its own
    unchunked run); the constraint is re-applied at 8 and at 16 px."""
    jdec, params, dec = _decoders(tuple(CASCADE.items()))
    b = 3
    embed, known, mask = _inputs(b, 4, 16, seed=7)
    neg = np.random.default_rng(8).standard_normal((1, D)).astype(np.float32)
    rng = jkeys.batch_keys([4, 5, 6])
    inits, knowns = replay(_cascade_draws, rng, b, CASCADE)
    want = np.asarray(_jit(lambda p, k, e, v, m, n: jdec.sample(
        p, k, video_embed=e, cond_scale=COND_SCALE, inpaint_video=v, inpaint_mask=m,
        negative_video_embed=n),
        params, rng, jnp.asarray(embed), jnp.asarray(known), jnp.asarray(mask),
        jnp.asarray(neg)))
    kw = dict(video_embed=t_(embed), cond_scale=COND_SCALE, inpaint_video=t_(known),
              inpaint_mask=t_(mask), negative_video_embed=t_(neg), init_noises=inits,
              known_noises=knowns)
    got = dec.sample(RowKeys([4, 5, 6]), max_batch_size=2, **kw).numpy()
    _hold(got, want)
    _hold_known(got, known, 2)
    np.testing.assert_allclose(got, dec.sample(RowKeys([4, 5, 6]), **kw).numpy(), atol=1e-5)


# ------------------------------------------------------------- the wrapper
def test_generate_with_negative_prompt_matches_jax():
    """generate(negative_text_embed=...): the prior runs a second time on
    the negative, broadcast from (1, d), from its own key fold_in(k_prior,
    1), and its embed is the decoder's CFG baseline; the positive stream's
    draws do not move (its prior embed equals the run without a negative)."""
    jdec, dparams, dec = _decoders(tuple(STAGE.items()))
    jprior, pparams, prior = _priors()
    b, seeds = 2, [3, 9]
    embed, _, _ = _inputs(b, 2, 8, seed=9)
    neg = np.random.default_rng(10).standard_normal((1, D)).astype(np.float32)
    rng = jkeys.batch_keys(seeds)
    k_prior, k_dec = jkeys.split(rng)
    # every draw of the run in one replayed program
    (inits, _), pos_z, neg_z = replay(lambda k, b: (
        _cascade_draws(k[1], b, STAGE), _prior_noise(k[0], b),
        _prior_noise(jkeys.fold_in(k[0], 1), b)), jnp.stack([k_prior, k_dec]), b)
    want = np.asarray(_jit(lambda pp, dp, k, e, n: JaxD2V(jprior, jdec, prior_num_samples=N_CAND)
                           .generate(pp, dp, k, e, cond_scale=COND_SCALE,
                                     negative_text_embed=n),
                           pparams, dparams, rng, jnp.asarray(embed), jnp.asarray(neg)))
    wrapper = DALLE2Video(prior, dec, prior_num_samples=N_CAND)
    draws = dict(prior_init_noise=pos_z, negative_prior_init_noise=neg_z)
    got = wrapper.generate(RowKeys(seeds), t_(embed), cond_scale=COND_SCALE,
                           negative_text_embed=t_(neg), decoder_init_noises=inits,
                           **draws).numpy()
    _hold(got, want)
    # the positive stream is untouched by the negative's prior run
    keys = RowKeys(seeds)
    pos, negv = wrapper._prior_embeds(keys.split()[0], t_(embed), 1.0, None, t_(neg))
    alone, none = wrapper._prior_embeds(keys.split()[0], t_(embed), 1.0, None)
    assert none is None and torch.equal(pos, alone) and not torch.allclose(pos, negv)


def test_generate_long_two_windows_matches_jax():
    """generate_long: 3 frames from the 2-frame decoder, overlap 1, so two
    windows, each from its own split of the row keys; window 1 inpaints its
    first frame from window 0's tail by replacement, so the frames window 0
    emitted are unchanged. Against JAX's generate_long with every window's
    draws replayed; and the validation errors of JAX's."""
    jdec, dparams, dec = _decoders(tuple(STAGE.items()))
    jprior, pparams, prior = _priors()
    b, seeds = 2, [1, 2]
    embed, _, _ = _inputs(b, 2, 8, seed=11)
    rng = jkeys.batch_keys(seeds)
    k_prior, k_dec = jkeys.split(rng)
    # every draw of the run in one replayed program: each window's, the prior's
    windows, prior_z = replay(lambda k, b: (
        [_cascade_draws(kw, b, STAGE) for kw in jkeys.split(k[1], 2)],
        _prior_noise(k[0], b)), jnp.stack([k_prior, k_dec]), b)
    draws = [dict(zip(("init_noises", "known_noises"), w)) for w in windows]
    want = np.asarray(_jit(lambda pp, dp, k, e: JaxD2V(jprior, jdec, prior_num_samples=N_CAND)
                           .generate_long(pp, dp, k, e, n_frames=3, overlap=1,
                                          cond_scale=COND_SCALE),
                           pparams, dparams, rng, jnp.asarray(embed)))
    wrapper = DALLE2Video(prior, dec, prior_num_samples=N_CAND)
    kw = dict(cond_scale=COND_SCALE, prior_init_noise=prior_z)
    got = wrapper.generate_long(RowKeys(seeds), t_(embed), n_frames=3, overlap=1,
                                draws=draws, **kw).numpy()
    assert got.shape == (2, 3, 8, 8, 3)
    _hold(got, want)
    first = wrapper.generate_long(RowKeys(seeds), t_(embed), n_frames=2, overlap=1,
                                  draws=draws[:1], **kw).numpy()
    np.testing.assert_array_equal(got[:, :2], first)
    from dalle2_video_tpu.engine.longvideo import generate_long_video as jax_long
    from dalle2_video_tpu_torch.engine.longvideo import generate_long_video

    for bad in (dict(n_frames=3, overlap=2), dict(n_frames=3, overlap=0),
                dict(n_frames=1)):
        with pytest.raises(ValueError) as jax_err:
            jax_long(jdec, dparams, rng, video_embed=jnp.asarray(embed), **bad)
        with pytest.raises(ValueError) as port_err:
            generate_long_video(dec, RowKeys(seeds), video_embed=t_(embed), **bad)
        assert str(port_err.value) == str(jax_err.value)


def test_split_batch_and_chunked_apply_match_jax():
    from dalle2_video_tpu.utils.chunked import chunked_apply as jax_chunked
    from dalle2_video_tpu.utils.chunked import split_batch as jax_split
    from dalle2_video_tpu_torch.utils.chunked import chunked_apply, split_batch

    for n, m in [(0, 3), (1, 3), (7, 3), (6, 3), (5, 8)]:
        assert list(split_batch(n, m)) == list(jax_split(n, m))
    x = np.arange(7 * 2, dtype=np.float32).reshape(7, 2)
    seen = []

    def fn(a, scale=1.0):
        seen.append(tuple(a.shape))
        return (a * scale, {"s": a.sum(-1)})

    # the port pads no tail chunk: eager PyTorch compiles no shape
    got = chunked_apply(fn, 7, 3, torch.from_numpy(x), scale=2.0)
    want = jax_chunked(fn, 7, 3, jnp.asarray(x), scale=2.0, pad_tail=False)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1]["s"].numpy(), np.asarray(want[1]["s"]))
    assert seen[:3] == [(3, 2), (3, 2), (1, 2)]


def test_guided_inpainting_refused_with_flash_cross_attention_on_both_sides():
    """The tiny-context cross-attention kernel has no backward in either
    package: JAX's grad through it fails to linearise (its Pallas kernel in
    interpret mode, as the CPU runs it), and the port refuses with the
    reason before any stage samples: a stage, a cascade sample and a long
    video whose second window would inpaint. Replacement runs on both."""
    from dalle2_video_tpu.ops.pallas import cross_attention as ca_mod
    from dalle2_video_tpu_torch.engine.longvideo import generate_long_video

    flash = dict(UNET, cross_attention_impl="flash")
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**flash),), **STAGE))
    params = jax.eval_shape(jdec.init_params, jax.random.PRNGKey(0))
    embed, known, mask = _inputs(2, 2, 8)
    orig = ca_mod.fused_cross_attention
    interpret = lambda q, k, v, sm_scale, block_n=1024, interpret=False: orig(
        q, k, v, sm_scale=sm_scale, block_n=block_n, interpret=True)
    for method in ("replace", "guided"):
        run = jax.jit(lambda p, k, e, v, m: jdec.sample_stage(
            0, p, k, batch_size=2, video_embed=e, cond_scale=COND_SCALE, inpaint_video=v,
            inpaint_mask=m, inpaint_method=method))
        args = (params, jax.random.PRNGKey(0), jnp.asarray(embed), jnp.asarray(known),
                jnp.asarray(mask))
        with mock.patch.object(ca_mod, "fused_cross_attention", interpret):
            if method == "guided":
                with pytest.raises(ValueError, match="Linearization failed"):
                    run.lower(*args)
            else:
                run.lower(*args)

    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**flash),), **STAGE),
                       device=torch.device("cpu"))
    kw = dict(batch_size=2, video_embed=t_(embed), cond_scale=COND_SCALE,
              inpaint_video=t_(known), inpaint_mask=t_(mask))
    with pytest.raises(ValueError, match="forward-only"):
        dec.sample_stage(0, RowKeys([0, 1]), inpaint_method="guided", **kw)
    with mock.patch.object(dec, "sample_stage", side_effect=AssertionError("sampled")):
        with pytest.raises(ValueError, match="forward-only"):
            dec.sample(RowKeys([0, 1]), inpaint_method="guided", **kw)
        with pytest.raises(ValueError, match="forward-only"):
            generate_long_video(dec, RowKeys([0, 1]), n_frames=3, video_embed=t_(embed),
                                inpaint_method="guided")
    assert dec.sample_stage(0, RowKeys([0, 1]), **kw).shape == (2, 2, 8, 8, 3)


# ------------------------------------------------------------ the serving
def test_serving_stack_answers_every_request_option(tmp_path):
    """build_generate_batch (the smoke stack, sampler from a config
    override) behind GenerationEngine answers a negative prompt,
    inpainting by replacement and by guidance, long video and the DPM++
    sampler; takes exactly the keywords of scripts/serve.py::generate_batch;
    and the engine still refuses long video with inpainting."""
    import inspect

    from dalle2_video_tpu_torch.serve.engine import GenerationEngine, GenRequest
    from dalle2_video_tpu_torch.serve.stack import apply_smoke, build_generate_batch
    from dalle2_video_tpu_torch.utils.config import config_from_argv

    rng = np.random.default_rng(12)
    known = rng.random((2, 24, 24, 3)).astype(np.float32)
    mask = np.zeros((2, 1, 1, 1), np.float32)
    mask[:1] = 1.0
    requests = {
        "negative": dict(negative_prompt="a frown"),
        "replace": dict(inpaint_video=known, inpaint_mask=mask),
        "guided": dict(inpaint_video=known, inpaint_mask=mask, inpaint_method="guided"),
        "long": dict(n_frames=3, overlap=1),
    }
    for sampler in ("ddim", "dpmpp"):
        cfg = apply_smoke(config_from_argv([f"sampler={sampler}", f"run_dir={tmp_path}"]))
        gb = build_generate_batch(cfg, logging.getLogger("test"), device="cpu")
        if sampler == "ddim":
            want = set(inspect.signature(gb).parameters)
            assert want == {"prompts", "seeds", "cond_scale", "ddim_steps", "inpaint_video",
                            "inpaint_mask", "inpaint_method", "inpaint_guidance_weight",
                            "negative_prompts", "n_frames", "overlap"}
        todo = requests if sampler == "ddim" else {"dpmpp": {}}
        eng = GenerationEngine(gb, buckets=(1, 2), max_wait_ms=20.0,
                               default_cond_scale=3.0, default_ddim_steps=2)
        try:
            futs = {name: eng.submit(GenRequest("a smile", seed=3, cond_scale=3.0,
                                                ddim_steps=2, **kw))
                    for name, kw in todo.items()}
            done, _ = wait(list(futs.values()), timeout=300)
            assert len(done) == len(futs)
            for name, f in futs.items():
                v = f.result()["video"]
                assert v.shape == ((3 if name == "long" else 2), 32, 32, 3), name
                assert np.isfinite(v).all() and v.min() >= 0.0 and v.max() <= 1.0
                if name in ("replace", "guided"):
                    _hold_known(v[None], known[None], 1)
            with pytest.raises(ValueError, match="mutually exclusive"):
                eng.submit(GenRequest("x", n_frames=3, inpaint_video=known, inpaint_mask=mask))
        finally:
            eng.close()


def test_config_overrides_reach_the_sampler_and_the_plain_impls():
    """``sampler``, ``unetN.cross_attention_impl`` and
    ``unetN.groupnorm_impl`` read from the config or an override reach the
    decoder (JAX scripts/train_decoder.py reads ``sampler`` the same way)
    and the modules; an unknown value raises where the module is built."""
    from dalle2_video_tpu_torch.engine.decoder import build_decoder
    from dalle2_video_tpu_torch.models.layers import Block3D, CrossAttention
    from dalle2_video_tpu_torch.utils.config import config_from_argv

    small = ["unet1.dim=8", "unet1.dim_mults=[1,2]", "unet2.dim=8", "unet2.dim_mults=[1,2]"]
    cfg = config_from_argv([*small, "sampler=dpmpp", "unet1.cross_attention_impl=broadcast",
                            "unet2.groupnorm_impl=skip"])
    dec = build_decoder(cfg, device="cpu")
    assert dec.config.sampler == "dpmpp"
    kinds = lambda u, cls, attr: {getattr(m, attr) for m in dec.unets[u].modules()
                                  if isinstance(m, cls)}
    assert kinds(0, CrossAttention, "impl") == {"broadcast"}
    assert kinds(1, Block3D, "norm_impl") == {"skip"}
    assert kinds(0, Block3D, "norm_impl") == kinds(1, CrossAttention, "impl") == {"xla"}
    for bad in ("sampler=euler", "unet1.cross_attention_impl=sdpa"):
        with pytest.raises(ValueError):
            build_decoder(config_from_argv([*small, bad]), device="cpu")
