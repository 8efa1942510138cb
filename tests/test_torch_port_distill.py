"""Progressive distillation against the JAX package: the grids and every
refusal, ``DistillTrainer.loss`` (w 1 and 2, eps and v, both weights,
dynamic thresholding with a tie at the clip, bf16 compute, the SR stage)
and the student's gradients, two ``distill_step`` s (Adam + EMA), the
one-step closure through the port's own DDIM update,
``serve_distill`` against scripts/serve.py::build_generate_batch on the
same student, and the entry point's phase handoff and resume.

Recipe of tests/test_torch_port_requests.py: JAX parameters drawn from a
seeded normal in the JAX layout (``jax_tree_of`` of the prior-MoE file,
in place of tracing the JAX init) and carried across with ``weights.py``;
every JAX draw (the
segments, the noise, the low-res noise) recomputed from its key and
injected; the JAX programs compiled at XLA's lowest optimisation level,
each case's loss, gradients and draws in one program.

Tolerances: f32 losses 2e-4 relative (tests/test_distill.py's), gradients
1e-4 of each tensor's largest entry, the step's parameters, EMA and Adam
moments 2e-4 absolute; the bf16 loss 1e-3 relative (measured 7e-5; the
f32 loss lies 4e-3 off); the served video 2e-3 (the requests file's).
"""

from __future__ import annotations

import functools
import logging
import sys
import unittest.mock as mock
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle2_video_tpu.engine.decoder import VideoDecoder as JaxDecoder
from dalle2_video_tpu.engine.decoder import VideoDecoderConfig as JaxDecoderConfig
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.train.distill import DistillConfig as JaxDistillConfig
from dalle2_video_tpu.train.distill import DistillTrainer as JaxDistill
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.train import distill
from dalle2_video_tpu_torch.train.distill import DistillConfig, DistillTrainer
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import (
    load_distill_state_from_jax,
    load_from_jax,
    params_from_jax,
)
from test_torch_port_prior_moe import jax_tree_of

torch.set_num_threads(1)
CPU = torch.device("cpu")
D = 16
B = 2
UNET = dict(dim=8, dim_mults=(1,), num_resnet_blocks=0, attn_heads=2, attn_dim_head=8, attend_at_middle=False,
            resnet_groups=4, init_cross_embed=False, init_conv_ksize=3, video_embed_dim=D)
# one stage of 2 frames at 8 px over 20 timesteps (tests/test_distill.py's)
STAGE = dict(frame_sizes=(8,), frame_numbers=(2,), timesteps=20, learned_variance=False)
# 3 frames at 5 px: 225 values a sample, so the 0.75 quantile is the 169th
# smallest |x0| exactly and that value ties with the clip
TIE = dict(frame_sizes=(5,), frame_numbers=(3,), timesteps=20, learned_variance=False,
           use_dynamic_thres=True, dynamic_thres_percentile=0.75)
# two stages: the SR stage conditions on the 4 px stage, noised
SR = dict(frame_sizes=(4, 8), frame_numbers=(2, 2), timesteps=20, learned_variance=False,
          use_noise_for_lowres_cond=True, predict_v=True)

_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_(a):
    return torch.from_numpy(np.array(a))


def _trees(unets, seed):
    """{"unet_<i>": flax tree} of the port's unets, drawn from a seeded
    normal (0.15): the JAX decoder's init_params layout."""
    return {f"unet_{i}": jax_tree_of(u, seed=seed + 10 * i, std=0.15)
            for i, u in enumerate(unets)}


@functools.lru_cache(maxsize=None)
def _decoders(knobs: tuple, flash: bool = False):
    """The JAX decoder with redrawn parameters (the teacher) and a second
    redrawn unet (a student far from it), and the port's decoder."""
    kw = dict(knobs)
    n = len(kw["frame_sizes"])
    ucfg = dict(UNET, cross_attention_impl="flash") if flash else UNET
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**ucfg),) * n, **kw))
    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**ucfg),) * n, **kw), device=CPU)
    params, far = _trees(dec.unets, 1), _trees(dec.unets, 2)
    for i, unet in enumerate(dec.unets):
        load_from_jax(unet, _np(params[f"unet_{i}"]))
    return jdec, params, far, dec


def _inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    video = rng.random((B, *shape)).astype(np.float32)
    return video, rng.standard_normal((B, D)).astype(np.float32)


def _jax_draws(jtr, rng, video, dec):
    """The draws of JAX DistillTrainer.loss for ``rng`` (distill.py:246-266)."""
    i = jtr.i
    k_seg, k_noise, k_lowres = jax.random.split(rng, 3)
    s, t = dec.config.frame_sizes[i], dec.config.frame_numbers[i]
    shape = (video.shape[0], t, s, s, video.shape[-1])
    out = {"segments": jax.random.randint(k_seg, (video.shape[0],), 0, jtr.t_starts.shape[0]),
           "noise": jax.random.normal(k_noise, shape)}
    if dec.use_noise_for_lowres[i]:
        out["lowres_noise"] = jkeys.normal(jkeys.split(k_lowres)[1], shape)
    return out


def _port_draws(draws):
    return {k: t_(v) for k, v in draws.items()}


def _trainers(knobs, unet_number=1, **cfg):
    jdec, params, far, dec = _decoders(tuple(knobs.items()))
    dcfg = dict(student_steps=4, unet_number=unet_number, **cfg)
    return (jdec, params, far, dec, JaxDistill(jdec, JaxDistillConfig(**dcfg)),
            DistillTrainer(dec, DistillConfig(**dcfg)))


def _close(got, want, rtol, atol, what):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert got.shape == want.shape and np.all(err <= atol + rtol * np.abs(want)), (
        what, float(err.max()))


# --------------------------------------------------------- grids, refusals
def test_grids_and_refusals_follow_the_jax_trainer():
    """The three grids at T = 20 / 4 steps and at T = 1000 over the
    entry point's halving phases; a degenerate grid, a self-conditioned
    stage and a guided teacher without conditional dropout refused by both
    packages; the port also refuses an unknown weight."""
    def bare(knobs, **u):
        return (JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET, **u),), **knobs)),
                VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET, **u),), **knobs),
                             device=CPU))

    for knobs, steps in ((STAGE, (4, 2)), (dict(STAGE, timesteps=1000), distill.PHASES)):
        jdec, dec = bare(knobs)
        for s in steps:
            jtr = JaxDistill(jdec, JaxDistillConfig(student_steps=s))
            tr = DistillTrainer(dec, DistillConfig(student_steps=s))
            for name in ("t_starts", "t_mids", "t_ends"):
                assert getattr(tr, name).tolist() == np.asarray(getattr(jtr, name)).tolist()
            assert tr.t_ends.tolist()[-1] == -1
    jdec, dec = bare(STAGE)
    with pytest.raises(ValueError, match="degenerate"):
        JaxDistill(jdec, JaxDistillConfig(student_steps=15))
    with pytest.raises(ValueError, match="degenerate"):
        DistillTrainer(dec, DistillConfig(student_steps=15))
    jdec2, dec2 = bare(dict(STAGE, video_cond_drop_prob=0.0, text_cond_drop_prob=0.0))
    with pytest.raises(ValueError, match="conditional dropout"):
        JaxDistill(jdec2, JaxDistillConfig(teacher_cond_scale=2.0))
    with pytest.raises(ValueError, match="conditional dropout"):
        DistillTrainer(dec2, DistillConfig(teacher_cond_scale=2.0))
    DistillTrainer(dec2, DistillConfig(teacher_cond_scale=1.0))
    jsc, sc = bare(STAGE, self_cond=True)
    with pytest.raises(NotImplementedError, match="self-cond"):
        JaxDistill(jsc, JaxDistillConfig())
    with pytest.raises(NotImplementedError, match="self-cond"):
        DistillTrainer(sc, DistillConfig())
    with pytest.raises(ValueError, match="weight"):
        DistillTrainer(dec, DistillConfig(weight="snr"))


def test_flash_cross_attention_refused_on_both_sides():
    """The tiny-context cross-attention kernel has no backward: JAX's
    gradient of the distill loss through it fails to linearise (its Pallas
    kernel in interpret mode, as the CPU runs it), and the port refuses the
    trainer at construction, before any step, naming the xla route; the
    same decoder with cross_attention_impl xla is accepted."""
    from dalle2_video_tpu.ops.pallas import cross_attention as ca_mod

    jdec, params, _, dec = _decoders(tuple(STAGE.items()), flash=True)
    jtr = JaxDistill(jdec, JaxDistillConfig(student_steps=4))
    z = jnp.zeros((B, 2, 8, 8, 3))
    t, emb = jnp.array([19, 9]), jnp.zeros((B, D))
    orig = ca_mod.fused_cross_attention
    interpret = lambda q, k, v, sm_scale, block_n=1024, interpret=False: orig(  # noqa: E731
        q, k, v, sm_scale=sm_scale, block_n=block_n, interpret=True)
    # the loss's student term: its x-prediction, differentiated
    run = jax.jit(jax.grad(lambda s: jtr._xstart(
        s, z, t, cond_scale=1.0, cond_kwargs=dict(video_embed=emb)).sum()))
    with mock.patch.object(ca_mod, "fused_cross_attention", interpret):
        with pytest.raises(ValueError, match="Linearization failed"):
            run.lower(params["unet_0"])
    with pytest.raises(ValueError, match="forward-only"):
        DistillTrainer(dec, DistillConfig(student_steps=4))
    DistillTrainer(_decoders(tuple(STAGE.items()))[3], DistillConfig(student_steps=4))


# ------------------------------------------------------------- the loss
def test_sr_stage_loss_matches_jax():
    """Unet 2 of a two-stage cascade at teacher_cond_scale 1, v-prediction,
    no weight: the sampling-time low-res conditioning (nearest to 4 px and
    back, noised at the fixed sample level from the injected low-res noise,
    no blur). The loss within 2e-4 relative, the student far from the
    teacher, every draw injected (the gradients are held in the steps'
    test)."""
    jdec, params, far, dec, jtr, tr = _trainers(SR, unet_number=2, teacher_cond_scale=1.0,
                                                weight="none")
    video, emb = _inputs((2, 10, 10, 3))
    key = jax.random.PRNGKey(7)

    def fn(student, key, video, emb):
        return (jtr.loss(student, params, key, video, video_embed=emb),
                _jax_draws(jtr, key, video, jdec))

    args = (far["unet_1"], key, jnp.asarray(video), jnp.asarray(emb))
    want, draws = _compiled(fn, *args)(*args)
    assert "lowres_noise" in draws
    tr.init_state(params_from_jax(_np(params["unet_1"])), params_from_jax(_np(far["unet_1"])))
    with torch.no_grad():
        got = tr.loss(t_(video), video_embed=t_(emb), draws=_port_draws(draws))
    _close(got, want, 2e-4, 0.0, "loss")
    assert float(want) > 1e-3  # the student is far: not vacuous


def test_bf16_loss_within_its_bound():
    """sample_compute_dtype bfloat16 (the unets of both passes in bf16, the
    diffusion math f32) at w 2: the port's loss within 1e-3 relative of the
    JAX loss (measured 7e-5: the network's bf16 roundings in another
    order), while the f32 loss on the same weights and draws lies more
    than 2e-3 from it (measured 4e-3)."""
    knobs = dict(STAGE, sample_compute_dtype="bfloat16")
    jdec, params, far, dec, jtr, tr = _trainers(knobs, teacher_cond_scale=2.0)
    video, emb = _inputs((2, 8, 8, 3))
    key = jax.random.PRNGKey(8)

    def fn(student, key, video, emb):
        return (jtr.loss(student, params, key, video, video_embed=emb),
                _jax_draws(jtr, key, video, jdec))

    args = (far["unet_0"], key, jnp.asarray(video), jnp.asarray(emb))
    want, draws = _compiled(fn, *args)(*args)
    tr.init_state(params_from_jax(_np(params["unet_0"])), params_from_jax(_np(far["unet_0"])))
    with torch.no_grad():
        got = tr.loss(t_(video), video_embed=t_(emb), draws=_port_draws(draws))
    _close(got, want, 1e-3, 0.0, "bf16 loss")
    # not vacuous: the f32 loss on the same weights and draws lies further off
    tr32 = _trainers(STAGE, teacher_cond_scale=2.0)[-1]
    tr32.init_state(params_from_jax(_np(params["unet_0"])), params_from_jax(_np(far["unet_0"])))
    with torch.no_grad():
        f32 = tr32.loss(t_(video), video_embed=t_(emb), draws=_port_draws(draws))
    assert abs(float(f32) - float(want)) > 2e-3 * abs(float(want))


# ------------------------------------------------------------- the step
def test_distill_steps_match_jax():
    """Two distill_steps from a far student, each key's draws injected, at
    teacher_cond_scale 2 (eps, the truncated SNR weight, dynamic
    thresholding at 0.75 with a tie at the clip) and ema_decay 0.9, against
    two JAX distill_steps: each loss (2e-4 relative); after step 1 the
    first Adam moment, (1 - b1) times the gradient, to 1e-4 of each
    tensor's largest entry (the gradient check); after both the student,
    the EMA (d * e + (1 - d) * p), both moments (2e-4) and the counts. In
    step 1 some |x0| of the student equals its threshold s > 1, so the
    gradient runs through the quantile and the clip there on both sides.
    A state of other shapes is refused by load_distill_state_from_jax."""
    cfg = dict(teacher_cond_scale=2.0, lr=1e-3, ema_decay=0.9)
    jdec, params, far, dec, jtr, tr = _trainers(TIE, **cfg)
    video, emb = _inputs((2, 10, 10, 3))
    keys = jax.random.split(jax.random.PRNGKey(11))

    def step(state, key, video, emb):
        new, loss = jtr.distill_step(state, params, key, video, video_embed=emb)
        return new, loss, _jax_draws(jtr, key, video, jdec)

    # one program in place of init_state's eager per-leaf ops
    s0 = _compiled(lambda p, f: jtr.init_state(p, student_params=f), params, far["unet_0"])(
        params, far["unet_0"])
    args = (s0, keys[0], jnp.asarray(video), jnp.asarray(emb))
    run = _compiled(step, *args)
    states = [run(*args)]
    states.append(run(states[0][0], keys[1], jnp.asarray(video), jnp.asarray(emb)))

    tr.init_state(params_from_jax(_np(params["unet_0"])), params_from_jax(_np(far["unet_0"])))
    for n, (state, want, draws) in enumerate(states, 1):
        seen = []
        thres = dec.dynamic_threshold
        with mock.patch.object(dec, "dynamic_threshold", lambda x: seen.append(x) or thres(x)):
            got = tr.distill_step(t_(video), video_embed=t_(emb), draws=_port_draws(draws))
        _close(got, want, 2e-4, 0.0, f"loss {n}")
        adam = state.opt_state[0]
        trees = {name: params_from_jax(_np(t)) for name, t in (
            ("student", state.student), ("ema", state.ema), ("mu", adam.mu), ("nu", adam.nu))}
        assert tr.step == int(state.step) == n
        for k, p in tr.student.items():
            st = tr.optimizer.state[p]
            assert int(st["step"]) == int(adam.count) == n
            if n == 1:
                mu = trees["mu"][k]
                _close(st["exp_avg"], mu, 0.0, 1e-4 * float(mu.abs().max()) + 1e-10, f"grad {k}")
            for name, v in (("student", p), ("ema", tr.ema[k]), ("mu", st["exp_avg"]),
                            ("nu", st["exp_avg_sq"])):
                _close(v, trees[name][k], 0.0, 2e-4, f"{name} {k} after step {n}")
        if n == 1:  # the student's x0 (the third threshold): a tie at the clip
            x0 = seen[2].detach().reshape(B, -1).abs()
            s = torch.quantile(x0, 0.75, dim=-1)
            assert any(bool(s[r] > 1) and bool((x0[r] == s[r]).any()) for r in range(B))
            assert sum(float(v.abs().max()) > 0 for v in trees["mu"].values()) > 10
    bad = DistillTrainer(_decoders(tuple(SR.items()))[3],  # the SR unet: other shapes
                         DistillConfig(student_steps=4, unet_number=2))
    bad.init_state()
    with pytest.raises(ValueError, match="JAX"):
        load_distill_state_from_jax(bad, {"student": _np(s0.student), "ema": _np(s0.ema),
                                          "opt_state": {}, "step": 1})


def test_one_step_closure_through_the_port_ddim_update():
    """The target is exactly the x-prediction that makes ONE student DDIM
    step land on the teacher's two-step endpoint (tests/test_distill.py's
    closure, through the port's _ddim_to at every segment), and through the
    port's own sampler: p_sample_loop_ddim over the student grid, its unet
    replaced by one whose x0 at the first step is segment 0's target (no
    clip), enters its second step at the teacher's z_end."""
    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),), clip_denoised=False,
                                          **STAGE), device=CPU)
    tr = DistillTrainer(dec, DistillConfig(student_steps=4))
    sched = dec.schedules[0]
    rng = np.random.default_rng(0)
    shape = (3, 2, 4, 4, 3)
    z_t, x0_a, x0_b = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
                       for _ in range(3))
    full = lambda v: torch.full((3,), int(v), dtype=torch.long)  # noqa: E731
    ends = []
    for k in range(len(tr.t_starts)):
        t, t_mid, t_end = full(tr.t_starts[k]), full(tr.t_mids[k]), full(tr.t_ends[k])
        z_end = tr._ddim_to(tr._ddim_to(z_t, x0_a, t, t_mid, 5), x0_b, t_mid, t_end, 5)
        a_t, s_t = tr._alpha_sigma(t, 5)
        a_e, s_e = tr._alpha_sigma(t_end, 5)
        ratio = s_e / s_t
        target = (z_end - ratio * z_t) / (a_e - ratio * a_t)
        torch.testing.assert_close(tr._ddim_to(z_t, target, t, t_end, 5), z_end,
                                   rtol=1e-4, atol=1e-4)
        ends.append((target, z_end))
    target, z_end = ends[0]
    seen = []

    def unet(i, x, t, **kw):  # eps whose x0 is segment 0's target
        seen.append(x.clone())
        return sched.predict_noise_from_start(x, t, target)

    with mock.patch.object(dec, "_unet_apply", unet):
        dec.p_sample_loop_ddim(0, RowKeys([0, 1, 2]), shape, timesteps=4,
                               init_noise=dec._normalize(z_t) * 0 + z_t)
    assert len(seen) == 4 and torch.equal(seen[0], z_t)
    torch.testing.assert_close(seen[1], z_end, rtol=1e-4, atol=1e-4)


# ------------------------------------------------------------- serving
def _serve_cfg(run_dir, **extra):
    """A tiny f32 stack of the config (8 -> 16 px, 2 frames, 20
    timesteps, stage 1 configured at 6 DDIM steps, stage 2 at 3)."""
    from dalle2_video_tpu_torch.utils.config import load_config

    unet = {"dim": 8, "dim_mults": [1], "num_resnet_blocks": 0, "attn_heads": 2,
            "attn_dim_head": 8}
    cfg = load_config(None, [])
    cfg.update(frame_sizes=[8, 16], frame_numbers=[2, 2], dim=D, timesteps=20,
               sample_timesteps=[6, 3], sample_compute_dtype=None, run_dir=str(run_dir),
               unet1=dict(unet), unet2=dict(unet), **extra)
    cfg["prior"] = dict(cfg["prior"], depth=1, heads=2, dim_head=8, sample_timesteps=2)
    return cfg


def _shaped(fn, seed, *args):
    """``fn(*args)``'s output with its float leaves drawn from a seeded
    normal (0.15) and the rest zero: the JAX server's inits without
    compiling them."""
    shapes = jax.eval_shape(fn, *args)
    leaves, td = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(td, [
        jnp.asarray(rng.standard_normal(l.shape) * 0.15, l.dtype)
        if jnp.issubdtype(l.dtype, jnp.floating) else jnp.zeros(l.shape, l.dtype)
        for l in leaves])


def test_serve_distill_swaps_the_student_and_pins_its_grid_as_the_jax_server(tmp_path):
    """scripts/serve.py::build_generate_batch with serve_distill {ckpt, steps
    2, unet 1} (its text tower and decoder inits replaced by seeded arrays
    of their shapes, the prior's, which only the captured generate call
    would read, by an empty tree; init_state compiled as one program) and
    the port's
    build_stack with the same student (the JAX DistillState carried by
    load_distill_state_from_jax, saved by the trainer; its
    student_decoder_params swap the EMA into slot 1): both pin stage 1
    alone to 2 steps, (2, 3); the port's slot 1 holds the EMA student (not
    the student, not the decoder checkpoint's unet), slot 2 the
    checkpoint's; and the student stage's sample at cond_scale 1 (the
    per-row key tree's x_T injected) matches the JAX decoder's on the
    served params within 2e-3."""
    import scripts.serve as jserve
    from dalle2_video_tpu.engine.dalle2video import DALLE2Video as JaxD2V
    from dalle2_video_tpu.models import clip_text as jct
    from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
    from dalle2_video_tpu.train import checkpoint as jckpt
    from dalle2_video_tpu.train import trainer as jtrainer
    from dalle2_video_tpu_torch.serve import stack
    from dalle2_video_tpu_torch.train import RollingCheckpointManager, save_checkpoint

    from dalle2_video_tpu.train.distill import DistillState as JaxDistillState

    from dalle2_video_tpu_torch.engine.decoder import build_decoder

    tiny_text = dict(width=32, layers=1, heads=2)
    jcfg = _serve_cfg(tmp_path / "jax_runs")
    pcfg = _serve_cfg(tmp_path / "port_runs")
    pdec = build_decoder(pcfg, CPU)  # the JAX server's decoder's layout
    shapes = jax.tree_util.tree_map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                                    _trees(pdec.unets, 1))
    student = _trees(pdec.unets, 2)["unet_0"]
    zeros = jax.tree_util.tree_map(np.zeros_like, student)
    dstate = JaxDistillState(
        student=student, ema=_trees(pdec.unets, 3)["unet_0"],
        opt_state=(optax.ScaleByAdamState(count=np.zeros((), np.int32), mu=zeros, nu=zeros),
                   optax.EmptyState()),
        step=np.asarray(5, np.int32))
    jckpt.save_checkpoint(str(tmp_path / "jax_student"), dstate)
    jcfg["serve_distill"] = {"ckpt": str(tmp_path / "jax_student"), "steps": 2, "unet": 1}

    seen = {}

    def capture(self, prior_params, dec_params, key, text_embed, **kw):
        seen.update(decoder=self.decoder, params=dec_params, steps=self.decoder.sample_timesteps,
                    cond_scale=kw["cond_scale"])
        return jnp.zeros((text_embed.shape[0], 2, 16, 16, 3))

    orig_text_cfg = jct.CLIPTextConfig
    orig_init = jtrainer.DecoderTrainer.init_state
    orig_distill_init = JaxDistill.init_state
    shaped = lambda orig: lambda self, *a: _shaped(lambda: orig(self, *a), 4)  # noqa: E731
    with mock.patch.object(jct, "CLIPTextConfig",
                           lambda embed_dim: orig_text_cfg(embed_dim=embed_dim, **tiny_text)), \
            mock.patch.object(jct.CLIPTextEncoder, "init", shaped(jct.CLIPTextEncoder.init)), \
            mock.patch.object(JaxPrior, "init_params",  # passed on, never applied here
                              lambda self, rng: {"params": {}}), \
            mock.patch.object(JaxDistill, "init_state", lambda self, teacher: _compiled(
                lambda t: orig_distill_init(self, t), teacher)(teacher)), \
            mock.patch.object(jtrainer.DecoderTrainer, "init_state", lambda self, rng: _shaped(
                lambda p: orig_init(self, rng, params=p), 1, shapes)), \
            mock.patch.object(JaxD2V, "generate", capture):
        jserve.build_generate_batch(jcfg, logging.getLogger("test"))(
            ["a smile"], [3], cond_scale=1.0, ddim_steps=None)
    assert seen["steps"] == (2, 3) and seen["cond_scale"] == 1.0
    served = _np(seen["params"])
    for a, b in zip(jax.tree_util.tree_leaves(served["unet_0"]),
                    jax.tree_util.tree_leaves(_np(dstate.ema))):
        np.testing.assert_array_equal(a, b)

    # the port: the decoder checkpoint (slot 1 zeros: the swap must fill it),
    # the student saved by the port's trainer from the same JAX state
    sds = [{k: torch.zeros_like(v) for k, v in pdec.unets[0].state_dict().items()},
           dict(params_from_jax(served["unet_1"]))]
    RollingCheckpointManager(str(tmp_path / "port_runs/decoder_default")).save(
        1, {"params": sds, "ema": [None, None], "steps": [1, 1]})
    tr = DistillTrainer(pdec, DistillConfig(student_steps=2))
    tr.init_state()
    adam = dstate.opt_state[0]
    load_distill_state_from_jax(tr, {
        "student": _np(dstate.student), "ema": _np(dstate.ema),
        "opt_state": {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": adam.count},
        "step": dstate.step})
    save_checkpoint(str(tmp_path / "port_student"), tr.state_dict())
    swapped = tr.student_decoder_params([dict(u.named_parameters()) for u in pdec.unets])
    assert all(torch.equal(v, tr.ema[k]) for k, v in swapped[0].items())
    assert all(v is p for (k, v), p in zip(swapped[1].items(), pdec.unets[1].parameters()))
    pcfg["serve_distill"] = {"ckpt": str(tmp_path / "port_student"), "steps": 2, "unet": 1}
    orig_port_cfg = stack.CLIPTextConfig
    with mock.patch.object(stack, "CLIPTextConfig",
                           lambda embed_dim: orig_port_cfg(embed_dim=embed_dim, **tiny_text)):
        _, wrapper = stack.build_stack(pcfg, CPU)
    dec = wrapper.decoder
    assert dec.sample_timesteps == (2, 3)
    ema, student = params_from_jax(served["unet_0"]), params_from_jax(_np(dstate.student))
    for k, p in dec.unets[0].named_parameters():
        assert torch.equal(p, ema[k])
    assert not all(torch.equal(p, student[k]) for k, p in dec.unets[0].named_parameters())
    for k, p in dec.unets[1].named_parameters():
        assert torch.equal(p, sds[1][k])

    emb = np.random.default_rng(6).standard_normal((1, D)).astype(np.float32)
    rng = jkeys.batch_keys([3])
    want = np.asarray(_compiled(lambda p, k, e: seen["decoder"].sample(
        p, k, video_embed=e, cond_scale=1.0, stop_at_unet_number=1), seen["params"], rng,
        jnp.asarray(emb))(seen["params"], rng, jnp.asarray(emb)))

    def inits(rng):  # stage 1's x_T from its key (decoder.sample -> the loop)
        k_init, _ = jkeys.split(jkeys.split(jkeys.split(rng, 2)[0])[1])
        return jkeys.normal(k_init, (1, 2, 8, 8, 3))

    x_t = [t_(_compiled(inits, rng)(rng)), None]
    kw = dict(video_embed=t_(emb), cond_scale=1.0, stop_at_unet_number=1, init_noises=x_t)
    got = dec.sample(RowKeys([3]), **kw).numpy()
    assert got.shape == want.shape == (1, 2, 8, 8, 3)
    np.testing.assert_allclose(got, want, atol=2e-3)
    # not vacuous: the slot's weights show (the student in place of the EMA
    # moves the video)
    with torch.no_grad():
        for k, p in dec.unets[0].named_parameters():
            p.copy_(student[k])
    dec._sampling_unets.clear()
    moved = dec.sample(RowKeys([3]), **kw).numpy()
    assert np.abs(moved - want).max() > 0.1


# ---------------------------------------------------------- entry point
def test_entry_point_hands_each_phase_on_and_resumes(tmp_path):
    """python -m ...train.distill on a 7-clip store after a one-step
    decoder run: the JAX script's phases (32, 16, 8, 4), guidance 2.0 in
    the first and 1 after, lr 1e-4 (scripts/distill_decoder.py's
    constants); phase 1's teacher the decoder checkpoint's sampling unet,
    each later phase's the EMA its predecessor saved; student_<n>/state and
    done per phase; a rerun after phase 4's marker is removed reloads 32,
    16 and 8 (no step) and trains phase 4 alone from phase 8's EMA."""
    sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "scripts"))
    import distill_decoder as jscript
    from dalle2_video_tpu_torch.train import load_decoder_sampling_params, load_checkpoint
    from dalle2_video_tpu_torch.train.__main__ import main as train_decoder_main
    from test_torch_port_clip import write_clip_store
    from test_torch_port_prior_train import _DECODER

    assert (distill.PHASES, distill.COND_SCALE, distill.LR) == (
        jscript.PHASES, jscript.COND_SCALE, jscript.LR)
    args = write_clip_store(tmp_path)
    (tmp_path / "embeds").mkdir()
    np.save(tmp_path / "embeds/videos.npy",
            np.random.default_rng(1).standard_normal((7, 24)).astype(np.float32))
    args = args + _DECODER
    train_decoder_main(args + ["max_steps=1"])
    run = tmp_path / "distill"
    calls = []
    orig_init, orig_step = DistillTrainer.init_state, DistillTrainer.distill_step

    def init_state(self, teacher=None, student=None):
        calls.append(("init", self.cfg, {k: v.detach().clone() for k, v in teacher.items()}))
        return orig_init(self, teacher, student)

    def step(self, *a, **kw):
        calls.append(("step", self.cfg.student_steps))
        return orig_step(self, *a, **kw)

    with mock.patch.object(DistillTrainer, "init_state", init_state), \
            mock.patch.object(DistillTrainer, "distill_step", step):
        out = distill.main(args + ["--run", str(run), "--steps", "1"])
        inits = [c for c in calls if c[0] == "init"]
        assert [c[1].student_steps for c in inits] == list(jscript.PHASES)
        assert [c[1].teacher_cond_scale for c in inits] == [2.0, 1.0, 1.0, 1.0]
        assert {c[1].lr for c in inits} == {1e-4}
        assert [c[1] for c in calls if c[0] == "step"] == list(jscript.PHASES)
        teacher0 = load_decoder_sampling_params(str(tmp_path / "runs/decoder_default"))[0]
        assert all(torch.equal(inits[0][2][k], teacher0[k]) for k in inits[0][2])
        states = {n: load_checkpoint(str(run / f"student_{n}/state")) for n in jscript.PHASES}
        for prev, nxt in zip(jscript.PHASES, inits[1:]):
            assert all(torch.equal(nxt[2][k], v) for k, v in states[prev]["ema"].items())
        assert all((run / f"student_{n}/done").exists() for n in jscript.PHASES)
        assert out["trainer"].step == 1 and np.isfinite(out["phase4_losses"][0])

        (run / "student_4/done").unlink()
        calls.clear()
        out = distill.main(args + ["--run", str(run), "--steps", "1"])
    assert [c[1] for c in calls if c[0] == "step"] == [4]
    inits = [c for c in calls if c[0] == "init"]
    assert all(torch.equal(inits[-1][2][k], v) for k, v in states[8]["ema"].items())
    assert out["trainer"].step == 1
