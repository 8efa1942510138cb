"""Latent diffusion through the decoder against the JAX package, on the
CPU: a VQVAE stage with ``predict_x_start_for_latent_diffusion`` -- the
loss (encoded video, no [-1, 1] map), DDIM and DDPM sampling (no clip, no
unnormalise, ``vae.decode`` at the end), latent inpainting (the known video
encoded, the pixel mask min-pooled to the latent grid), one
``DecoderTrainer`` step with the frozen ``vae_0`` (and its checkpoint and
sampling-params round trips), and one distill step on the latent stage.

One stage of 2 frames at 16 px over 20 timesteps; the VQVAE (base 8, one
down, a 16-code book) encodes it to 2 x 8 x 8 x 4 latents. The unet's
parameters are redrawn from a seeded normal (its output conv starts at 0),
the VAE's are the JAX init's; both ride across with ``weights``. Every JAX
draw is replayed from its key (one compiled program a replay) and injected
into the port. float32 throughout; the JAX programs compile at XLA's
lowest optimisation level.
"""

from __future__ import annotations

import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle2_video_tpu.engine.decoder import VideoDecoder as JaxDecoder
from dalle2_video_tpu.engine.decoder import VideoDecoderConfig as JaxDecoderConfig
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.models.vqvae import VQVAE as JaxVQVAE
from dalle2_video_tpu.train import DecoderTrainer as JaxTrainer
from dalle2_video_tpu.train import DecoderTrainerConfig as JaxTrainerConfig
from dalle2_video_tpu.train.distill import DistillConfig as JaxDistillConfig
from dalle2_video_tpu.train.distill import DistillTrainer as JaxDistill
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.models.vqvae import VQVAE
from dalle2_video_tpu_torch.train import (
    DecoderTrainer,
    DecoderTrainerConfig,
    RollingCheckpointManager,
    load_decoder_sampling_params,
)
from dalle2_video_tpu_torch.train.distill import DistillConfig, DistillTrainer
from dalle2_video_tpu_torch.utils.keys import RowKeys
from test_torch_port_prior_moe import jax_tree_of
from dalle2_video_tpu_torch.weights import (
    load_distill_state_from_jax,
    load_from_jax,
    load_train_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
D = 16
B = 2
UNET = dict(dim=8, dim_mults=(1,), num_resnet_blocks=0, attn_heads=2, attn_dim_head=8,
            attend_at_middle=False, resnet_groups=4, init_cross_embed=False, init_conv_ksize=3,
            video_embed_dim=D)
VAE = dict(latent_dim=4, base_dim=8, num_down=1, codebook_size=16)
STAGE = dict(frame_sizes=(16,), frame_numbers=(2,), timesteps=10, sample_timesteps=(3,),
             learned_variance=False, predict_x_start_for_latent_diffusion=True)
LATENT = (B, 2, 8, 8, 4)
COND_SCALE = 2.0
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _jit(fn, *args):
    return _compiled(fn, *args)(*args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol, what=""):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert got.shape == want.shape and np.all(err <= atol + rtol * np.abs(want)), (
        what, float(err.max()))


def _vae_tree(vae: VQVAE):
    """A VQVAE's JAX ``init_params`` layout: one flax ``params`` collection
    per part."""
    return {k: {"params": v} for k, v in jax_tree_of(vae)["params"].items()}


@functools.lru_cache(maxsize=None)
def _jax_decoder(knobs: tuple):
    """The JAX decoder with a VQVAE stage and its params in the JAX layout
    (``jax_tree_of``: no JAX init traced): the unet's from a seeded normal,
    the VAE's the port's init from a seeded generator."""
    kw = dict(knobs)
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET),), **kw),
                      vaes=(JaxVQVAE(**VAE),))
    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),), **kw), device=CPU,
                       vaes=(VQVAE(**VAE, device=CPU, generator=torch.Generator().manual_seed(0)),))
    params = {"unet_0": jax_tree_of(dec.unets[0], seed=1, std=0.15),
              "vae_0": _vae_tree(dec.vaes[0])}
    return jdec, jax.tree_util.tree_map(jnp.asarray, params)


def _decoders(knobs: tuple = tuple(STAGE.items())):
    """The JAX decoder, its params, and a fresh port decoder on them."""
    jdec, params = _jax_decoder(knobs)
    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),), **dict(knobs)),
                       device=CPU, vaes=(VQVAE(**VAE, device=CPU),))
    load_from_jax(dec.unets[0], _np(params["unet_0"]))
    load_from_jax(dec.vaes[0], _np(params["vae_0"]))
    return jdec, params, dec


def _inputs(seed=3):
    rng = np.random.default_rng(seed)
    return (rng.random((B, 2, 16, 16, 3)).astype(np.float32),
            rng.standard_normal((B, D)).astype(np.float32))


def _loss_draws(rng):
    """decoder.loss's draws from ``rng`` at the latent shape (JAX
    decoder.py loss / _p_losses key splits)."""
    k_t, _, _, k_loss = jax.random.split(rng, 4)
    k_noise, k_vmask, _, _ = jax.random.split(k_loss, 4)
    return {"times": jax.random.randint(k_t, (B,), 0, STAGE["timesteps"], dtype=jnp.int32),
            "noise": jax.random.normal(k_noise, LATENT, jnp.float32),
            "video_keep": jax.random.bernoulli(k_vmask, 0.9, (B,))}


def _stage_draws(rng, n_steps: int):
    """A stage loop's x_T, per-step and known-region noises from the stage
    key (decoder.py sample_stage -> p_sample_loop_ddim / _ddpm)."""
    _, k_loop = jkeys.split(rng)
    k_init, key = jkeys.split(k_loop)

    def step(key, _):
        key, k_noise, k_known = jkeys.split(key, 3)
        return key, (jkeys.normal(k_noise, LATENT), jkeys.normal(k_known, LATENT))

    _, (steps, known) = jax.lax.scan(step, key, None, length=n_steps)
    return jkeys.normal(k_init, LATENT), steps, known


def _port(tree):
    return jax.tree_util.tree_map(t_, tree)


# ------------------------------------------------------------------ sampling
@pytest.mark.parametrize("loop", ["ddim", "ddpm"])
def test_latent_sample_matches_jax(loop):
    """A latent stage sampled at CFG 2 from the same x_T (and step noises):
    DDIM 3 steps through ``decoder.sample`` (its row keys' stage split),
    DDPM over all 20 timesteps through ``sample_stage``; neither clips x0
    nor unnormalises, and both end with the VAE's decode (1e-4 of the
    output's scale, which lies outside [0, 1])."""
    knobs = dict(STAGE, sample_timesteps=(3,) if loop == "ddim" else None)
    jdec, params, dec = _decoders(tuple(knobs.items()))
    _, emb = _inputs()
    rng = jax.random.PRNGKey(7)
    n = 3 if loop == "ddim" else 20
    if loop == "ddim":
        want = _jit(lambda p, r, e: jdec.sample(p, r, video_embed=e, cond_scale=COND_SCALE),
                    params, rng, emb)
        x_t, _, _ = _port(_jit(lambda r: _stage_draws(jkeys.split(r, 1)[0], n), rng))
        with mock.patch.object(dec, "dynamic_threshold",
                               side_effect=AssertionError("clipped")):
            got = dec.sample(RowKeys([0, 1]), video_embed=t_(emb), cond_scale=COND_SCALE,
                             init_noises=[x_t])
    else:
        want = _jit(lambda p, r, e: jdec.sample_stage(0, p, r, batch_size=B, video_embed=e,
                                                      cond_scale=COND_SCALE), params, rng, emb)
        x_t, steps, _ = _port(_jit(lambda r: _stage_draws(r, n), rng))
        got = dec.sample_stage(0, RowKeys([0, 1]), batch_size=B, video_embed=t_(emb),
                               cond_scale=COND_SCALE, init_noise=x_t, step_noises=steps)
    want = np.asarray(want)
    assert got.shape == want.shape == (B, 2, 16, 16, 3)
    assert want.min() < 0.0 or want.max() > 1.0  # no clip, no unnormalise
    _close(got, want, 0.0, 1e-4 * np.abs(want).max(), loop)


def test_latent_inpainting_pools_the_mask_and_matches_jax():
    """Inpainting by replacement on the latent stage (DDIM 3): the known
    video VAE-encoded and taken as it is (no normalisation), the pixel mask
    min-pooled to the latent grid (the left 5 of 16 pixel columns known:
    latent columns 0 and 1 known, column 2 -- pixels 4 and 5 -- not); the
    sample against JAX (1e-4 of its scale); a missing mask raises."""
    jdec, params, dec = _decoders()
    known, emb = _inputs(9)
    mask = np.zeros((B, 2, 16, 16, 1), np.float32)
    mask[:, :, :, :5] = 1.0
    rng = jax.random.PRNGKey(8)
    want = _jit(lambda p, r, e, v, m: jdec.sample_stage(
        0, p, r, batch_size=B, video_embed=e, cond_scale=COND_SCALE, inpaint_video=v,
        inpaint_mask=m), params, rng, emb, known, mask)
    x_t, steps, knowns = _port(_jit(lambda r: _stage_draws(r, 3), rng))
    seen = {}
    loop = dec.p_sample_loop_ddim

    def spy(*a, **kw):
        seen.update(kw)
        return loop(*a, **kw)

    with mock.patch.object(dec, "p_sample_loop_ddim", spy):
        got = dec.sample_stage(0, RowKeys([0, 1]), batch_size=B, video_embed=t_(emb),
                               cond_scale=COND_SCALE, inpaint_video=t_(known),
                               inpaint_mask=t_(mask), init_noise=x_t, step_noises=steps,
                               known_noises=knowns)
    pooled = seen["inpaint"].mask
    assert pooled.shape == (B, 2, 8, 8, 1) and seen["is_latent"]
    assert torch.equal(pooled[..., :2, 0], torch.ones(B, 2, 8, 2))
    assert float(pooled[..., 2:, 0].abs().max()) == 0.0
    with torch.no_grad():
        assert torch.equal(seen["inpaint"].x0k, dec.vaes[0].encode(t_(known)))
    _close(got, want, 0.0, 1e-4 * np.abs(np.asarray(want)).max(), "inpaint")
    with pytest.raises(ValueError, match="inpaint_mask"):
        dec.sample_stage(0, RowKeys([0, 1]), batch_size=B, video_embed=t_(emb),
                         inpaint_video=t_(known))


# ------------------------------------------------------------------ training
def test_latent_loss_and_trainer_step_with_a_frozen_vae_match_jax(tmp_path):
    """One DecoderTrainer step (AdamW, EMA) from a carried JAX TrainState
    (init_state: zero moments) whose params hold unet_0 and vae_0, the JAX
    draws injected. The loss (1e-5 relative): the unet (the VAE's 4
    channels in and out, predicting x0) sees the VAE's latents of the video,
    never mapped to [-1, 1]. The step against JAX's: the first moment is
    (1 - b1) times the clipped JAX gradient of the loss (1e-4 of each
    leaf's largest value; the gradient check) and the params are the JAX
    chain's one step from zero moments, p - lr (g / (|g| + eps) + wd p) on
    the clipped g (rtol 1e-4 + 2e-6; eps 1e-3 keeps it smooth in g).
    vae_0 bit-for-bit unchanged (and equal to JAX's), without
    gradients, in no optimiser group and no EMA; it survives the trainer's
    checkpoint into a fresh decoder and rides to the server in the sampling
    params (``vae.<name>``, loaded strictly). A JAX state without vae_0 is
    refused."""
    jdec, params, dec = _decoders()
    video, emb = _inputs(4)
    lr, eps, wd = 1e-3, 1e-3, 1e-2
    jtr = JaxTrainer(jdec, JaxTrainerConfig(lr=lr, eps=eps, wd=wd))
    state = _jit(lambda p: jtr.init_state(jax.random.PRNGKey(0), p), params)
    rng = jax.random.PRNGKey(6)
    # the loss and its gradient: the JAX step's whole program compiles
    # twice as long, and one step from zero moments has a closed form
    (loss, grads), draws = _jit(lambda p, r, v, e: (jax.value_and_grad(
        lambda u: jdec.loss(dict(p, unet_0=u), r, v, video_embed=e))(p["unet_0"]),
        _loss_draws(r)), params, rng, video, emb)

    def carried(s):
        adam = [x for x in s.opt_states[0] if isinstance(x, optax.ScaleByAdamState)][0]
        return {"params": _np(s.params),
                "opt_states": [{"mu": _np(adam.mu), "nu": _np(adam.nu),
                                "count": int(adam.count)}],
                "ema": [None if s.ema[0] is None else {"params": _np(s.ema[0].params),
                                                       "step": int(s.ema[0].step)}],
                "steps": [int(x) for x in np.asarray(s.steps)]}

    tr = DecoderTrainer(dec, DecoderTrainerConfig(lr=1e-3, eps=1e-3))
    load_train_state_from_jax(tr, carried(state))
    vae_before = {k: v.clone() for k, v in dec.vaes[0].state_dict().items()}
    assert dec.unet_configs[0].channels == dec.unet_configs[0].channels_out == 4
    assert dec.predict_x_start == (True,)
    seen = []
    network = tr._network

    def spy(i):
        net = network(i)
        return lambda x, *a, **kw: seen.append(x) or net(x, *a, **kw)

    with mock.patch.object(dec, "_normalize", side_effect=AssertionError("normalised")), \
            mock.patch.object(tr, "_network", spy):
        got = tr.train_step(t_(video), video_embed=t_(emb), draws=_port(draws))
    assert seen[0].shape == LATENT
    _close(got, loss, 1e-5, 0.0, "loss")
    g = {k: v.double() for k, v in params_from_jax(_np(grads)).items()}
    norm = float(torch.sqrt(sum((v**2).sum() for v in g.values())))
    p0 = {k: v.double() for k, v in params_from_jax(_np(params["unet_0"])).items()}
    for name, p in dec.unets[0].named_parameters():
        gc = g[name] * (0.5 / norm if norm >= 0.5 else 1.0)
        mu = 0.1 * gc
        _close(tr.optimizers[0].state[p]["exp_avg"], mu, 0.0,
               1e-4 * float(mu.abs().max()) + 1e-12, f"mu {name}")
        want_p = p0[name] - lr * (gc / (gc.abs() + eps) + (wd * p0[name] if p.ndim >= 2 else 0))
        _close(p, want_p, 1e-4, 2e-6, name)
    want_vae = params_from_jax(_np(params["vae_0"]))
    for k, v in dec.vaes[0].state_dict().items():
        assert torch.equal(v, vae_before[k]) and torch.equal(v, want_vae[k]), k
    vae_ids = {id(p) for p in dec.vaes[0].parameters()}
    assert not any(p.requires_grad or p.grad is not None for p in dec.vaes[0].parameters())
    assert not vae_ids & {id(p) for g in tr.optimizers[0].param_groups for p in g["params"]}
    assert not any(k.startswith("vae") for k in tr.ema[0].params)

    mgr = RollingCheckpointManager(str(tmp_path / "decoder_default"))
    mgr.save(1, tr.state_dict(), metrics={"val_loss": 1.0})
    fresh = VideoDecoder(dec.config, device=CPU, vaes=(VQVAE(**VAE, device=CPU),))
    DecoderTrainer(fresh, DecoderTrainerConfig(lr=1e-3, eps=1e-3)).load_state_dict(
        mgr.restore_latest())
    served = VideoDecoder(dec.config, device=CPU, vaes=(VQVAE(**VAE, device=CPU),))
    stages = load_decoder_sampling_params(str(tmp_path / "decoder_default"))
    assert {k[4:] for k in stages[0] if k.startswith("vae.")} == set(vae_before)
    served.load_sampling_params(stages)
    for other in (fresh, served):
        for k, v in dec.vaes[0].state_dict().items():
            assert torch.equal(other.vaes[0].state_dict()[k], v), k
    for k, v in tr.sampling_params()[0].items():
        want_v = (dec.vaes[0].state_dict()[k[4:]] if k.startswith("vae.")
                  else tr.ema[0].params[k])
        assert torch.equal(v, want_v), k
    bad = carried(state)
    del bad["params"]["vae_0"]
    with pytest.raises(ValueError, match="vae_0"):
        load_train_state_from_jax(tr, bad)


def test_distill_step_on_a_latent_stage_matches_jax():
    """One distill_step on the latent stage from a student far from the
    teacher (teacher_cond_scale 2), the JAX draws injected: the student's
    target is the encoded video (not normalised), x0 is not clipped; the
    loss (2e-4 relative) and the first Adam moment after, (1 - b1) times
    JAX's gradient of the loss (1e-4 of each leaf's largest value; the
    gradient check). The state bridge carries the teacher's vae_0 and
    refuses a state without it."""
    jdec, params, dec = _decoders()
    video, emb = _inputs(12)
    far = jax.tree_util.tree_map(jnp.asarray, jax_tree_of(dec.unets[0], seed=2, std=0.15))
    cfg = dict(student_steps=4, teacher_cond_scale=2.0, lr=1e-3, ema_decay=0.9)
    jtr = JaxDistill(jdec, JaxDistillConfig(**cfg))

    def loss_and_draws(p, f, key, video, emb):
        k_seg, k_noise, _ = jax.random.split(key, 3)
        draws = {"segments": jax.random.randint(k_seg, (B,), 0, jtr.t_starts.shape[0]),
                 "noise": jax.random.normal(k_noise, LATENT)}
        return jax.value_and_grad(jtr.loss)(f, p, key, video, video_embed=emb), draws

    (loss, grads), draws = _jit(loss_and_draws, params, far, jax.random.PRNGKey(13), video, emb)
    tr = DistillTrainer(dec, DistillConfig(**cfg))
    tr.init_state()
    zeros = jax.tree_util.tree_map(np.zeros_like, _np(far))
    state = {"student": _np(far), "ema": _np(far), "opt_state": {"mu": zeros, "nu": zeros,
                                                                  "count": 0},
             "step": 0, "vae_0": _np(params["vae_0"])}
    load_distill_state_from_jax(tr, state)
    with mock.patch.object(dec, "dynamic_threshold", side_effect=AssertionError("clipped")), \
            mock.patch.object(dec, "_normalize", side_effect=AssertionError("normalised")):
        got = tr.distill_step(t_(video), video_embed=t_(emb), draws=_port(draws))
    _close(got, loss, 2e-4, 0.0, "loss")
    g = params_from_jax(_np(grads))
    for k, p in tr.student.items():
        mu = 0.1 * g[k]
        _close(tr.optimizer.state[p]["exp_avg"], mu, 0.0,
               1e-4 * float(mu.abs().max()) + 1e-10, f"grad {k}")
    assert sum(float(v.abs().max()) > 0 for v in g.values()) > 10
    del state["vae_0"]
    with pytest.raises(ValueError, match="vae_0"):
        load_distill_state_from_jax(tr, state)
