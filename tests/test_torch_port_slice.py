"""The serving slice end to end against the JAX package: tokens -> CLIP
text tower -> prior best-of-2 (DDIM) -> two-stage cascade (DDIM, eta 0,
cond_scale 3.0 with 2x-batched CFG), in float32, on the same weights.

JAX's threefry draws cannot be reproduced in PyTorch, so the test walks the
JAX package's key tree (dalle2_video_tpu.utils.keys, per-row keys from the
request seeds) to compute every initial noise the JAX run draws, and injects
those into the port. With x_T fixed both DDIM loops are deterministic
(prior.py:512-541, decoder.py:908-909).

Tolerance: 2e-3 absolute on videos in [0, 1] (looser than the 2e-4 of one
unet forward). The first DDIM step sits at t = 999 of the cosine schedule,
where x0 = x_t / sqrt(abar) - eps * sqrt(1/abar - 1) multiplies the
forward's f32 disagreement by ~1/sqrt(abar) ~ 1e2; the two stages and the
guidance scale of 3 compound it. The prior's candidate choice is checked
separately, with a margin, so an argmax near-tie cannot flip it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dalle2_video_tpu.data.tokenizer import tokenize as jax_tokenize
from dalle2_video_tpu.engine.dalle2video import DALLE2Video as JaxD2V
from dalle2_video_tpu.engine.decoder import (
    VideoDecoder as JaxDecoder,
    VideoDecoderConfig as JaxDecoderConfig,
)
from dalle2_video_tpu.models.clip_text import CLIPTextConfig as JaxCLIPCfg
from dalle2_video_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
from dalle2_video_tpu.models.prior import DiffusionPriorConfig as JaxPriorConfig
from dalle2_video_tpu.models.prior import PriorNetworkConfig as JaxPriorNetCfg
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.data.tokenizer import tokenize
from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from dalle2_video_tpu_torch.models.prior import (
    DiffusionPrior,
    DiffusionPriorConfig,
    PriorNetworkConfig,
)
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.utils.contrastive import l2_normalize
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import load_from_jax

torch.set_num_threads(1)

D = 16  # CLIP / prior embed dim
UNET = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=2,
            attn_dim_head=8, video_embed_dim=D)
DEC = dict(frame_sizes=(16, 32), frame_numbers=(2, 3), timesteps=1000,
           sample_timesteps=(3, 3), learned_variance=False)
PRIOR_NET = dict(dim=D, depth=1, heads=2, dim_head=8)
CLIP = dict(width=32, heads=2, layers=2, embed_dim=D)
PROMPTS = ["a woman smiling", "a man talking", "someone laughing"]
SEEDS = [3, 11, 42]
N_CAND = 2
COND_SCALE = 3.0


# the JAX samplers are jitted and compiled at XLA's lowest optimisation
# level: a third less compile time than the default, same f32 arithmetic
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


def redraw(tree, seed, std):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        td, [jnp.asarray(rng.standard_normal(l.shape) * std, jnp.float32) for l in leaves])


@functools.lru_cache(maxsize=1)
def _jax_stack():
    """The JAX stack and its redrawn parameters, made once for the file."""
    dec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET), JaxUCfg(**UNET)), **DEC))
    dec_params = redraw(jax.eval_shape(dec.init_params, jax.random.PRNGKey(0)), 1, 0.15)
    prior = JaxPrior(JaxPriorConfig(network=JaxPriorNetCfg(**PRIOR_NET), sample_timesteps=2))
    prior_params = redraw(jax.eval_shape(prior.init_params, jax.random.PRNGKey(1)), 2, 0.3)
    clip = JaxCLIP(JaxCLIPCfg(**CLIP))
    tokens = jnp.asarray(jax_tokenize(PROMPTS))
    clip_params = redraw(jax.eval_shape(clip.init, jax.random.PRNGKey(2), tokens), 3, 0.1)
    return dec, dec_params, prior, prior_params, clip, clip_params


def _jax_draws(dec):
    """Every initial noise the JAX generate() draws, from its key tree."""
    b = len(SEEDS)
    rng = jkeys.batch_keys(SEEDS)
    k_prior, k_dec = jkeys.split(rng)
    cand = jax.vmap(lambda k: jnp.stack([jax.random.fold_in(k, j)
                                         for j in range(N_CAND)]))(k_prior)
    k_init, _ = jkeys.split(cand.reshape((b * N_CAND,) + cand.shape[2:]))
    prior_noise = np.array(jkeys.normal(k_init, (b * N_CAND, D)))
    stage_noise = []
    for i, k_stage in enumerate(jkeys.split(k_dec, 2)):
        _, k_loop = jkeys.split(k_stage)
        k_init, _ = jkeys.split(k_loop)
        s, t = DEC["frame_sizes"][i], DEC["frame_numbers"][i]
        stage_noise.append(np.array(jkeys.normal(k_init, (b, t, s, s, 3))))
    return prior_noise, stage_noise


def _port_stack(dec_params, prior_params, clip_params):
    cpu = torch.device("cpu")
    dec = VideoDecoder(VideoDecoderConfig(
        unets=(UNet3DConfig(**UNET), UNet3DConfig(**UNET)), **DEC), device=cpu)
    for i, unet in enumerate(dec.unets):
        load_from_jax(unet, dec_params[f"unet_{i}"])
    prior = DiffusionPrior(DiffusionPriorConfig(
        network=PriorNetworkConfig(**PRIOR_NET), sample_timesteps=2), device=cpu)
    load_from_jax(prior.network, prior_params)
    clip = load_from_jax(CLIPTextEncoder(CLIPTextConfig(**CLIP)), clip_params)
    return dec, prior, clip


def test_generate_matches_jax_end_to_end():
    jdec, jdec_params, jprior, jprior_params, jclip, jclip_params = _jax_stack()
    prior_noise, stage_noise = _jax_draws(jdec)
    tokens = jax_tokenize(PROMPTS)
    jembed = jclip.apply(jclip_params, jnp.asarray(tokens))
    want = np.asarray(_jit(lambda pp, dp, k, e: JaxD2V(jprior, jdec, prior_num_samples=N_CAND)
                           .generate(pp, dp, k, e, cond_scale=COND_SCALE),
                           jprior_params, jdec_params, jkeys.batch_keys(SEEDS), jembed))

    dec, prior, clip = _port_stack(jdec_params, jprior_params, jclip_params)
    with torch.no_grad():
        embed = clip(torch.from_numpy(tokenize(PROMPTS)))
    np.testing.assert_allclose(embed.numpy(), np.asarray(jembed), atol=2e-4)

    # the prior's best-of-2 choice: same candidate as JAX, with a margin
    with torch.no_grad():
        cands = prior.sample_loop(RowKeys(range(len(SEEDS) * N_CAND)),
                                  embed.repeat_interleave(N_CAND, 0),
                                  init_noise=torch.from_numpy(prior_noise))
    sims = torch.einsum("bd,bnd->bn", l2_normalize(embed),
                        l2_normalize(cands.reshape(len(SEEDS), N_CAND, D)))
    assert (sims[:, 0] - sims[:, 1]).abs().min() > 1e-3, sims
    got_embed = prior.sample(RowKeys(SEEDS), embed, N_CAND,
                             init_noise=torch.from_numpy(prior_noise))
    jax_embed = _jit(lambda p, k, e: jprior.sample(p, k, e, num_samples_per_batch=N_CAND),
                     jprior_params, jkeys.split(jkeys.batch_keys(SEEDS))[0], jembed)
    np.testing.assert_allclose(got_embed.numpy(), np.asarray(jax_embed), atol=5e-4)

    got = DALLE2Video(prior, dec, prior_num_samples=N_CAND).generate(
        RowKeys.from_request_seeds(SEEDS), embed, cond_scale=COND_SCALE,
        prior_init_noise=torch.from_numpy(prior_noise),
        decoder_init_noises=[torch.from_numpy(z) for z in stage_noise],
    ).numpy()
    assert got.shape == want.shape == (3, 3, 32, 32, 3)
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=2e-3)
    # not vacuous: random weights drive most pixels into the [0, 1] clip,
    # but ~5% of them (over a thousand values) land strictly inside it
    inside = (want > 0.0) & (want < 1.0)
    assert int(inside.sum()) > 1000
    np.testing.assert_allclose(got[inside], want[inside], atol=2e-3)


def test_ddim_stage_with_cfg_matches_jax():
    """One SR stage alone (lowres conditioning from a given 16 px video,
    resized in space and time), DDIM with CFG, f32."""
    jdec, jdec_params, _, jprior_params, _, jclip_params = _jax_stack()
    dec, _, _ = _port_stack(jdec_params, jprior_params, jclip_params)
    rng = np.random.default_rng(5)
    b = 2
    prev = rng.random((b, 2, 16, 16, 3)).astype(np.float32)
    k = jax.random.PRNGKey(9)
    _, k_loop = jkeys.split(k)
    k_init, _ = jkeys.split(k_loop)
    x_t = np.array(jkeys.normal(k_init, (b, 3, 32, 32, 3)))  # the JAX loop's x_T
    want = np.asarray(_jit(lambda p, k, pv: jdec.sample_stage(
        1, p, k, batch_size=b, prev_video=pv, cond_scale=COND_SCALE),
        jdec_params, k, jnp.asarray(prev)))
    got = dec.sample_stage(1, RowKeys([0, 1]), batch_size=b,
                           prev_video=torch.from_numpy(prev), cond_scale=COND_SCALE,
                           init_noise=torch.from_numpy(x_t)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_ddpm_stage_learned_variance_matches_jax():
    """DDPM ancestral loop (20 timesteps) with learned variance, dynamic
    thresholding and CFG rescale, f32; the JAX run's x_T and every step's
    noise are recomputed from its key tree and injected."""
    knobs = dict(frame_sizes=(16, 32), frame_numbers=(2, 2), timesteps=20,
                 learned_variance=True, use_dynamic_thres=True, cfg_rescale=0.7)
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET), JaxUCfg(**UNET)), **knobs))
    params = redraw(jax.eval_shape(jdec.init_params, jax.random.PRNGKey(0)), 4, 0.1)
    dec = VideoDecoder(VideoDecoderConfig(
        unets=(UNet3DConfig(**UNET), UNet3DConfig(**UNET)), **knobs), device=torch.device("cpu"))
    for i, unet in enumerate(dec.unets):
        load_from_jax(unet, params[f"unet_{i}"])
    b, shape = 2, (2, 2, 16, 16, 3)
    embed = np.random.default_rng(6).standard_normal((b, D)).astype(np.float32)
    rng = jax.random.PRNGKey(12)
    _, k_loop = jax.random.split(rng)
    k_init, key = jax.random.split(k_loop)
    x_t = np.array(jax.random.normal(k_init, shape))
    step_noise = []
    for _ in range(20):
        key, k_noise, _ = jax.random.split(key, 3)
        step_noise.append(torch.from_numpy(np.array(jax.random.normal(k_noise, shape))))
    want = np.asarray(_jit(lambda p, k, e: jdec.sample_stage(
        0, p, k, batch_size=b, video_embed=e, cond_scale=COND_SCALE),
        params, rng, jnp.asarray(embed)))
    got = dec.sample_stage(0, RowKeys([0, 1]), batch_size=b,
                           video_embed=torch.from_numpy(embed), cond_scale=COND_SCALE,
                           init_noise=torch.from_numpy(x_t), step_noises=step_noise).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=2e-3)


def test_noise_video_matches_jax():
    """Imagen-style lowres noising at a fixed level, same noise injected."""
    from dalle2_video_tpu.engine.conditioner import (
        LowresConditionerConfig as JaxLowresCfg,
        make_noise_schedule as jax_noise_schedule,
        noise_video as jax_noise_video,
    )
    from dalle2_video_tpu_torch.engine.conditioner import (
        LowresConditionerConfig,
        make_noise_schedule,
        noise_video,
    )

    video = np.random.default_rng(8).random((2, 2, 4, 4, 3)).astype(np.float32)
    level = np.array([200, 200], np.int32)
    rng = jax.random.PRNGKey(3)
    noise = np.array(jax.random.normal(jax.random.split(rng)[1], video.shape))
    want, _ = jax_noise_video(rng, jnp.asarray(video), jax_noise_schedule(),
                              JaxLowresCfg(use_noise=True), jnp.asarray(level))
    got, _ = noise_video(RowKeys([0, 1]), torch.from_numpy(video), make_noise_schedule(),
                         LowresConditionerConfig(use_noise=True), torch.from_numpy(level).long(),
                         noise=torch.from_numpy(noise))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
