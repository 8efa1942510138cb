"""The training slice against the JAX package, on the CPU: the schedule's
loss helpers, ``lowres_condition``, ``decoder.loss`` and its gradients, one
``train_step``, the EMA, the TrainState bridge, and the port's own trainer
mechanics (skip_nonfinite, the weight-decay mask, grad_accum, checkpoints,
the entry point).

The cascade is scripts/train_decoder.py's smoke widths (unet 1 dim 16,
unet 2 dim 8, mults (1, 2), one block, 2 frames at 16 / 32 px) with 10
timesteps, learned variance and p2 weights on unet 1, v-prediction and
self-conditioning on unet 2. JAX parameters are initialised, every leaf is
redrawn from a seeded normal (so the zero-initialised output conv passes
gradients) and carried across with ``weights.load_from_jax``. JAX's
threefry draws cannot be made in PyTorch, so each test walks the JAX key
splits of ``decoder.loss`` (decoder.py:533-534, :600-613;
conditioner.py:97, :108) to compute every draw and injects it into the
port. Everything runs in float32.
"""

from __future__ import annotations

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle2_video_tpu.diffusion import schedule as jsched
from dalle2_video_tpu.engine.conditioner import (
    LowresConditionerConfig as JaxLowresCfg,
    lowres_condition as jax_lowres_condition,
    make_noise_schedule as jax_noise_schedule,
)
from dalle2_video_tpu.engine.decoder import (
    VideoDecoder as JaxDecoder,
    VideoDecoderConfig as JaxDecoderConfig,
)
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.train import DecoderTrainer as JaxTrainer
from dalle2_video_tpu.train import DecoderTrainerConfig as JaxTrainerConfig
from dalle2_video_tpu.train import EMAConfig as JaxEMAConfig
from dalle2_video_tpu.train.ema import current_decay as jax_current_decay
from dalle2_video_tpu.train.ema import ema_init as jax_ema_init
from dalle2_video_tpu.train.ema import ema_update as jax_ema_update
from dalle2_video_tpu_torch.diffusion import schedule as sched
from dalle2_video_tpu_torch.engine.conditioner import (
    LowresConditionerConfig,
    lowres_condition,
    make_noise_schedule,
)
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.train import (
    DecoderTrainer,
    DecoderTrainerConfig,
    EMAConfig,
    PreemptionGuard,
    RollingCheckpointManager,
    has_checkpoint,
    load_checkpoint,
    load_latest,
    save_checkpoint,
)
from dalle2_video_tpu_torch.train.__main__ import main as train_main
from dalle2_video_tpu_torch.train.ema import current_decay, ema_init, ema_update
from dalle2_video_tpu_torch.weights import (
    load_from_jax,
    load_train_state_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)
CPU = torch.device("cpu")
D = 32  # video embed dim
B = 2
UNET1 = dict(dim=16, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=2,
             attn_dim_head=8, video_embed_dim=D)
UNET2 = dict(UNET1, dim=8, self_cond=True)
DEC = dict(frame_sizes=(16, 32), frame_numbers=(2, 2), timesteps=10,
           learned_variance=(True, False), predict_v=(False, True),
           p2_loss_weight_gamma=0.5)
EMA = dict(beta=0.99, update_after_step=-5, update_every=1)  # blends at step 1
LR = 1e-3
# Adam's first step is lr * g / (|g| + eps): at the default eps (1e-8) a
# gradient within f32 noise of zero may move its param by +-lr on either
# side. eps 1e-3 keeps the step smooth in g (|d step| <= lr |dg| / eps),
# so the steps below compare tightly in units of lr.
ADAM_EPS = 1e-3


# unet 2's JAX loss and the optax step are jitted and compiled at XLA's
# lowest optimisation level: a third less compile time
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _jax_decoder():
    return JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET1), JaxUCfg(**UNET2)), **DEC))


def _port_decoder(params):
    dec = VideoDecoder(VideoDecoderConfig(
        unets=(UNet3DConfig(**UNET1), UNet3DConfig(**UNET2)), **DEC), device=CPU)
    for i, unet in enumerate(dec.unets):
        load_from_jax(unet, params[f"unet_{i}"])
    return dec


def _jax_draws(jdec, rng, unet_number, shape):
    """Every draw the JAX decoder.loss makes from ``rng``, as the port's
    ``draws`` dict."""
    i = unet_number - 1
    cfg = jdec.config
    k_t, k_lowres, _, k_loss = jax.random.split(rng, 4)
    k_blur, _ = jax.random.split(k_lowres)
    k_noise, k_vmask, _, k_sc = jax.random.split(k_loss, 4)
    t = lambda a: torch.from_numpy(np.array(a))
    draws = {
        "times": t(jax.random.randint(k_t, (shape[0],), 0, cfg.timesteps, dtype=jnp.int32)),
        "noise": t(jax.random.normal(k_noise, shape, jnp.float32)),
        "video_keep": t(jax.random.bernoulli(k_vmask, 1.0 - cfg.video_cond_drop_prob,
                                             (shape[0],))),
        "self_cond": bool(jax.random.bernoulli(k_sc, 0.5)),
    }
    if i > 0:
        draws["blur"] = bool(jax.random.bernoulli(k_blur, cfg.blur_prob))
    return draws


def _find_key(jdec, unet_number, shape, want):
    for seed in range(1000):
        rng = jax.random.PRNGKey(seed)
        d = _jax_draws(jdec, rng, unet_number, shape)
        if want(d):
            return rng, d
    raise AssertionError("no key gives the wanted draws")


@pytest.fixture(scope="module")
def stage():
    """JAX decoder, redrawn params, a batch, and per unet the JAX loss and
    gradients at a key whose draws exercise the branches: unet 1 has t = 0
    (the VLB's NLL term) beside t > 0 and one dropped video embed; unet 2
    draws the blur coin and the self-conditioning coin."""
    jdec = _jax_decoder()
    shapes = jax.eval_shape(jdec.init_params, jax.random.PRNGKey(0))
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(1)
    params = jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(rng.standard_normal(l.shape) * 0.15, jnp.float32) for l in leaves])
    video = np.random.default_rng(2).random((B, 2, 32, 32, 3)).astype(np.float32)
    embed = np.random.default_rng(3).standard_normal((B, D)).astype(np.float32)
    cases = {  # name: (unet number, wanted draws)
        1: (1, lambda d: 0 in d["times"].tolist() and d["times"].max() > 0
            and not bool(d["video_keep"].all())),
        2: (2, lambda d: d["blur"] and d["self_cond"]),
        # the train-step tests: t > 0 only (see test_train_step_matches_jax)
        "step": (1, lambda d: 0 not in d["times"].tolist() and not bool(d["video_keep"].all())),
    }
    out = {"jdec": jdec, "params": params, "video": video, "embed": embed}
    loss_fns = {}
    for name, (u, want) in cases.items():
        size = DEC["frame_sizes"][u - 1]
        key, draws = _find_key(jdec, u, (B, 2, size, size, 3), want)
        if u not in loss_fns:
            fn = jax.value_and_grad(lambda p, k, u=u: jdec.loss(
                {**params, f"unet_{u - 1}": p}, k, jnp.asarray(video),
                video_embed=jnp.asarray(embed), unet_number=u))
            # unet 1's VLB at t = 0 (case 1) moves with the compiler's
            # floating-point contractions past its tolerance: default compile
            loss_fns[u] = (jax.jit(fn) if u == 1
                           else _compiled(fn, params[f"unet_{u - 1}"], key))
        loss, grads = loss_fns[u](params[f"unet_{u - 1}"], key)
        out[name] = dict(key=key, draws=draws, loss=float(loss), grads=grads)
    return out


# ------------------------------------------------------------ loss helpers
@pytest.mark.parametrize("loss_type", ["l1", "l2", "huber"])
def test_schedule_loss_helpers_match_jax(loss_type):
    """loss_fn, p2 weights / p2_reweigh_loss and sample_random_times' range;
    f32 elementwise math on both sides: 1e-6."""
    rng = np.random.default_rng(4)
    pred, target = rng.standard_normal((2, 3, 4)) * 2, rng.standard_normal((2, 3, 4))
    t = np.array([0, 7])
    js = jsched.DiffusionSchedule.create("cosine", 10, loss_type, 0.5, 1.0)
    ps = sched.DiffusionSchedule.create("cosine", 10, loss_type=loss_type,
                                        p2_loss_weight_gamma=0.5, p2_loss_weight_k=1.0)
    f32 = lambda a: np.asarray(a, np.float32)
    want = js.p2_reweigh_loss(js.loss_fn(jnp.asarray(f32(pred)), jnp.asarray(f32(target))),
                              jnp.asarray(t))
    got = ps.p2_reweigh_loss(ps.loss_fn(torch.from_numpy(f32(pred)),
                                        torch.from_numpy(f32(target))), torch.from_numpy(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ps.p2_loss_weight.numpy(), np.asarray(js.p2_loss_weight),
                               rtol=1e-6)
    times = ps.sample_random_times(1000, torch.Generator().manual_seed(0))
    assert times.dtype == torch.int64 and 0 <= int(times.min()) and int(times.max()) == 9


def test_vlb_helpers_match_jax():
    """normal_kl and the discretized Gaussian log-likelihood on both sides
    of the +-0.999 thresholds; f32: 1e-5 relative. Means lie within ~1 sd of
    x: far in the tails cdf_plus - cdf_min cancels to a few ulp and the two
    frameworks' f32 tanh give different logs of it."""
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.uniform(-1, 1, 50), [-1.0, 1.0, -0.9995, 0.9995]]).astype(np.float32)
    lv1, lv2 = (rng.uniform(-3, 0, x.shape).astype(np.float32) for _ in range(2))
    m1 = (x + 0.5 * np.exp(0.5 * lv1) * rng.standard_normal(x.shape)).astype(np.float32)
    m2 = (rng.standard_normal(x.shape) * 0.3).astype(np.float32)
    j, t = jnp.asarray, torch.from_numpy
    np.testing.assert_allclose(sched.normal_kl(t(m1), t(lv1), t(m2), t(lv2)).numpy(),
                               np.asarray(jsched.normal_kl(j(m1), j(lv1), j(m2), j(lv2))),
                               rtol=1e-5, atol=1e-6)
    want = jsched.discretized_gaussian_log_likelihood(j(x), means=j(m1), log_scales=j(0.5 * lv1))
    got = sched.discretized_gaussian_log_likelihood(t(x), means=t(m1), log_scales=t(0.5 * lv1))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    assert abs(sched.NAT - float(jsched.NAT)) < 1e-12


@pytest.mark.parametrize("use_noise", [False, True])
def test_lowres_condition_matches_jax(use_noise):
    """Nearest down in space and time, the blur coin, nearest up, and the
    optional noising, with the JAX key splits replayed; 1e-6 on [0, 1]."""
    video = np.random.default_rng(6).random((2, 4, 16, 16, 3)).astype(np.float32)
    kw = dict(target_frame_size=16, downsample_frame_size=8, target_frame_number=4,
              downsample_frame_number=2)
    jcfg = JaxLowresCfg(use_noise=use_noise, blur_prob=1.0)
    pcfg = LowresConditionerConfig(use_noise=use_noise, blur_prob=1.0)
    rng = jax.random.PRNGKey(8)
    want, want_lv = jax_lowres_condition(rng, jnp.asarray(video), jcfg,
                                         noise_schedule=jax_noise_schedule(), **kw)
    _, k_noise = jax.random.split(rng)
    k_t, k_n = jax.random.split(k_noise)
    draws = {}
    if use_noise:
        draws = dict(noise_levels=torch.from_numpy(np.array(
            jax.random.randint(k_t, (2,), 0, 1000, dtype=jnp.int32))).long(),
            noise=torch.from_numpy(np.array(jax.random.normal(k_n, (2, 4, 16, 16, 3)))))
    got, lv = lowres_condition(torch.from_numpy(video), pcfg,
                               noise_schedule=make_noise_schedule(), blur=True, **kw, **draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    if use_noise:
        np.testing.assert_array_equal(lv.numpy(), np.asarray(want_lv))
    else:
        assert lv is None and want_lv is None


# ------------------------------------------------------------ decoder.loss
@pytest.mark.parametrize("case", [1, 2, "step"])
def test_decoder_loss_and_grads_match_jax(stage, case):
    """Loss and every parameter gradient against jax.value_and_grad of the
    JAX decoder.loss, draws replayed; f32 on both sides. Without a t = 0
    row ("step", unet 2) the two agree to ~3e-7 of the largest gradient
    entry (convolutions and the backward summed in other orders): 1e-5 of
    it. Case 1 has a t = 0 row, whose VLB term takes logs of cdf_plus -
    cdf_min, two nearly equal tanh values far in the tails: the frameworks'
    f32 tanh differ there by an ulp, which moves the loss by ~1e-5 relative
    and single gradient entries by up to 1e-3 of the largest one
    (measured): 2e-3 of it. Loss 5e-5 relative; gradients also 2e-3
    relative."""
    s = stage[case]
    u = 2 if case == 2 else 1
    grad_tol = 2e-3 if case == 1 else 1e-5
    dec = _port_decoder(stage["params"])
    loss = dec.loss(torch.from_numpy(stage["video"]), video_embed=torch.from_numpy(stage["embed"]),
                    unet_number=u, draws=s["draws"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), s["loss"], rtol=5e-5)
    want = params_from_jax(s["grads"])
    got = dict(dec.unets[u - 1].named_parameters())
    assert set(want) == set(got)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = got[name].grad
        assert g is not None, name
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3, atol=grad_tol * gmax,
                                   err_msg=name)
    # not vacuous: the gradient reaches the first conv and the null embeds
    assert float(got["init_conv.conv0.Conv_0.weight"].grad.abs().max()) > 0
    if u == 1:
        assert float(got["null_video_embed"].grad.abs().max()) > 0


@pytest.mark.parametrize("policy", ["nothing", "dots", "dots_no_batch", "conv", "conv_attn",
                                    "conv_dots"])
def test_decoder_loss_grads_under_each_remat_policy_match_jax(stage, policy):
    """Unet 2's loss (case 2) with its ResnetBlock3Ds checkpointed under
    each remat policy, against the JAX gradients of the same loss. A
    policy changes what the backward saves and recomputes, not the
    arithmetic (JAX's remat gives one gradient for every policy), so the
    tolerance is the loss test's: 1e-5 of the largest entry."""
    s = stage[2]
    dec = VideoDecoder(VideoDecoderConfig(unets=(
        UNet3DConfig(**UNET1),
        UNet3DConfig(**UNET2, checkpoint_during_training=True, remat_policy=policy)), **DEC),
        device=CPU)
    for i, unet in enumerate(dec.unets):
        load_from_jax(unet, stage["params"][f"unet_{i}"])
    loss = dec.loss(torch.from_numpy(stage["video"]), video_embed=torch.from_numpy(stage["embed"]),
                    unet_number=2, draws=s["draws"])
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), s["loss"], rtol=5e-5)
    want = params_from_jax(s["grads"])
    got = dict(dec.unets[1].named_parameters())
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        np.testing.assert_allclose(got[name].grad.numpy(), w.numpy(), rtol=2e-3,
                                   atol=1e-5 * gmax, err_msg=name)


def test_kernel_impls_give_the_plain_gradients_on_cpu(stage):
    """groupnorm_impl pallas and attention_impl flash route through the
    port's autograd Functions (plain backward versions on the CPU): same
    loss and gradients as the xla impls on the same weights; 1e-5."""
    params = stage["params"]
    fast_cfg = dict(UNET1, groupnorm_impl="pallas", attention_impl="flash")
    dec_fast = VideoDecoder(VideoDecoderConfig(
        unets=(UNet3DConfig(**fast_cfg), UNet3DConfig(**UNET2)), **DEC), device=CPU)
    load_from_jax(dec_fast.unets[0], params["unet_0"])
    dec = _port_decoder(params)
    grads = []
    for d in (dec, dec_fast):
        loss = d.loss(torch.from_numpy(stage["video"]), video_embed=torch.from_numpy(stage["embed"]),
                      unet_number=1, draws=stage[1]["draws"])
        loss.backward()
        grads.append({k: p.grad for k, p in d.unets[0].named_parameters()})
    for k in grads[0]:
        torch.testing.assert_close(grads[1][k], grads[0][k], atol=1e-5, rtol=1e-5, msg=k)


# ------------------------------------------------------------ train step
def _export(jstate):
    """A JAX TrainState as the numpy trees weights.load_train_state_from_jax
    takes (the Adam moments from optax's ScaleByAdamState)."""
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)
    opt = []
    for st in jstate.opt_states:
        adam = [s for s in st if isinstance(s, optax.ScaleByAdamState)][0]
        opt.append({"mu": np_tree(adam.mu), "nu": np_tree(adam.nu), "count": int(adam.count)})
    return {"params": np_tree(jstate.params), "opt_states": opt,
            "ema": [None if e is None else {"params": np_tree(e.params), "step": int(e.step)}
                    for e in jstate.ema],
            "steps": [int(s) for s in np.asarray(jstate.steps)]}


def _trainers(stage, **cfg):
    cfg.setdefault("eps", ADAM_EPS)
    jcfg = JaxTrainerConfig(lr=LR, ema=JaxEMAConfig(**EMA), **cfg)
    jtrainer = JaxTrainer(stage["jdec"], jcfg)
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), params=stage["params"])
    trainer = DecoderTrainer(_port_decoder(stage["params"]),
                             DecoderTrainerConfig(lr=LR, ema=EMAConfig(**EMA), **cfg))
    load_train_state_from_jax(trainer, _export(jstate))
    return jtrainer, jstate, trainer


def test_train_step_matches_jax(stage):
    """One unet-1 step: clip 0.5 -> Adam -> decoupled wd on >= 2-dim
    params -> lr, then the EMA blend. The JAX side applies its trainer's own
    optax chain and ema_update to the JAX gradients of the loss test's
    "step" case (the pieces of train_step, jitted apart: the whole JAX step
    takes ~45 s to compile here). The gradients agree to ~3e-7 of the
    largest entry (0.19), so with ADAM_EPS the new params and the EMA
    shadow agree to ~1e-4 lr: 2e-3 lr. Moments: mu 1e-3 relative, nu 2e-3
    (it squares g), of each tensor's largest value."""
    jtrainer, jstate, trainer = _trainers(stage)
    s = stage["step"]
    g = s["grads"]

    def jax_step(g, opt_state, params, ema):
        updates, new_opt = jtrainer.optimizers[0].update(g, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        return new_params, new_opt, jax_ema_update(ema, new_params, jtrainer.cfg.ema)

    args = (g, jstate.opt_states[0], jstate.params["unet_0"], jstate.ema[0])
    new_params, new_opt, new_ema = _compiled(jax_step, *args)(*args)
    loss = trainer.train_step(torch.from_numpy(stage["video"]),
                              video_embed=torch.from_numpy(stage["embed"]),
                              unet_number=1, draws=s["draws"])
    np.testing.assert_allclose(float(loss), s["loss"], rtol=1e-5)
    assert trainer.steps == [1, 0] and trainer.update_count(0) == 1
    assert trainer.ema[0].step == 1 and trainer.ema[1].step == 0
    got = trainer.params(0)
    before = params_from_jax(jstate.params["unet_0"])
    moved = 0
    for name, w in params_from_jax(new_params).items():
        diff = float((got[name].detach() - w).abs().max()) / LR
        assert diff <= 2e-3, (name, diff)
        moved += int(not torch.equal(got[name].detach(), before[name]))
    assert moved == len(got)  # every parameter moved
    adam = [s for s in new_opt if isinstance(s, optax.ScaleByAdamState)][0]
    state = trainer.optimizers[0].state
    for key, tree, rtol in (("exp_avg", adam.mu, 1e-3), ("exp_avg_sq", adam.nu, 2e-3)):
        for name, w in params_from_jax(tree).items():
            v = state[got[name]][key]
            np.testing.assert_allclose(v.numpy(), w.numpy(), rtol=rtol,
                                       atol=rtol * float(w.abs().max()) + 1e-12, err_msg=name)
    assert 0.0 < current_decay(1, EMAConfig(**EMA)) < 1.0  # a real blend
    for name, w in params_from_jax(new_ema.params).items():
        diff = float((trainer.ema[0].params[name] - w).abs().max()) / LR
        assert diff <= 2e-3, (name, diff)


def test_train_state_bridge_is_strict(stage):
    """Every JAX leaf (params, both moments, the EMA shadow) lands on exactly
    one port tensor with its shape; a missing or an extra leaf raises."""
    jtrainer, jstate, trainer = _trainers(stage)
    exported = _export(jstate)
    for i in range(2):
        names = dict(trainer.decoder.unets[i].named_parameters())
        n_leaves = len(jax.tree_util.tree_leaves(jstate.params[f"unet_{i}"]))
        assert n_leaves == len(names) == len(trainer.optimizers[i].state)
        for name, w in params_from_jax(jstate.params[f"unet_{i}"]).items():
            assert torch.equal(names[name].detach(), w)
            assert torch.equal(trainer.ema[i].params[name], w)
            assert float(trainer.optimizers[i].state[names[name]]["exp_avg"].abs().max()) == 0
    bad = _export(jstate)
    bad["opt_states"][0]["mu"]["params"]["extra"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="unused"):
        load_train_state_from_jax(trainer, bad)
    bad = _export(jstate)
    del bad["ema"][1]["params"]["params"]["to_out"]
    with pytest.raises(ValueError, match="missing"):
        load_train_state_from_jax(trainer, bad)
    load_train_state_from_jax(trainer, exported)


def test_ema_matches_jax():
    """current_decay over the warmup copy phase and the clamped ramp, and a
    run of ema_update with update_every 3 (no-op calls keep the shadow)."""
    cfg = dict(beta=0.9, update_after_step=4, update_every=3, power=0.5)
    for step in range(40):
        np.testing.assert_allclose(current_decay(step, EMAConfig(**cfg)),
                                   float(jax_current_decay(jnp.asarray(step), JaxEMAConfig(**cfg))),
                                   rtol=1e-6, atol=1e-7)
    rng = np.random.default_rng(9)
    online = [{"w": rng.standard_normal((3, 4)).astype(np.float32)} for _ in range(12)]
    js = jax_ema_init({"w": jnp.zeros((3, 4))})
    ps = ema_init({"w": torch.zeros(3, 4)})
    for o in online:
        js = jax_ema_update(js, {"w": jnp.asarray(o["w"])}, JaxEMAConfig(**cfg))
        ps = ema_update(ps, {"w": torch.from_numpy(o["w"])}, EMAConfig(**cfg))
        np.testing.assert_allclose(ps.params["w"].numpy(), np.asarray(js.params["w"]), atol=1e-6)
    assert ps.step == int(js.step) == 12


def test_skip_nonfinite_leaves_params_and_adam_untouched(stage):
    """A NaN batch: loss reported NaN; params, Adam state and the update
    count stay; the step counters still advance (as in the JAX step)."""
    _, _, trainer = _trainers(stage)
    vid, emb = torch.from_numpy(stage["video"]), torch.from_numpy(stage["embed"])
    trainer.train_step(vid, video_embed=emb, unet_number=1, draws=stage["step"]["draws"])
    params = {k: v.detach().clone() for k, v in trainer.params(0).items()}
    adam = {k: {n: t.clone() for n, t in st.items()}
            for k, st in zip(params, trainer.optimizers[0].state.values())}
    loss = trainer.train_step(vid * float("nan"), video_embed=emb, unet_number=1,
                              draws=stage["step"]["draws"])
    assert torch.isnan(loss)
    assert trainer.steps == [2, 0] and trainer.update_count(0) == 1 and trainer.ema[0].step == 2
    for k, v in trainer.params(0).items():
        assert torch.equal(v.detach(), params[k]), k
    for k, st in zip(params, trainer.optimizers[0].state.values()):
        for n, t in st.items():
            assert torch.equal(t, adam[k][n]), (k, n)


def test_weight_decay_mask_and_lr_schedule(stage):
    """Weight decay on >= 2-dim params only (group_wd_params); warmup and
    cosine follow optax (trainer.py:97-120)."""
    dec = _port_decoder(stage["params"])
    trainer = DecoderTrainer(dec, DecoderTrainerConfig(wd=0.05))
    for opt, unet in zip(trainer.optimizers, dec.unets):
        wd_of = {id(p): g["weight_decay"] for g in opt.param_groups for p in g["params"]}
        assert len(wd_of) == len(list(unet.parameters()))
        for p in unet.parameters():
            assert wd_of[id(p)] == (0.05 if p.ndim >= 2 else 0.0)
    from dalle2_video_tpu_torch.train.trainer import lr_at

    sched_j = optax.cosine_decay_schedule(3e-4, 100)
    for step in (0, 1, 9, 50, 99, 150):
        want = float(sched_j(step)) * min(1.0, (step + 1) / 10)
        assert abs(lr_at(step, 3e-4, 10, 100) - want) < 1e-9
    assert lr_at(5, 3e-4, None, None) == 3e-4


def test_grad_accum_2_equals_the_full_batch(stage):
    """grad_accum = 2 on two one-sample microbatches takes the same step as
    one two-sample batch with the same draws (the loss is a batch mean):
    same loss to 1e-6, params to 1e-4 lr (f32 sums in another order, Adam
    with ADAM_EPS)."""
    params, draws = stage["params"], stage["step"]["draws"]
    vid, emb = torch.from_numpy(stage["video"]), torch.from_numpy(stage["embed"])
    split = [{k: (v[j:j + 1] if torch.is_tensor(v) else v) for k, v in draws.items()}
             for j in range(2)]
    runs = []
    for accum, d in ((1, draws), (2, split)):
        t = DecoderTrainer(_port_decoder(params), DecoderTrainerConfig(
            lr=LR, eps=ADAM_EPS, grad_accum=accum))
        loss = t.train_step(vid, video_embed=emb, unet_number=1, draws=d)
        runs.append((float(loss), t.params(0)))
    np.testing.assert_allclose(runs[1][0], runs[0][0], rtol=1e-6)
    for k, v in runs[0][1].items():
        assert float((runs[1][1][k] - v).detach().abs().max()) <= 1e-4 * LR, k


def test_checkpoint_round_trip_and_retention(stage, tmp_path):
    """save -> load of the whole train state into a fresh trainer; rolling
    retention (newest 2, best 1, every 3rd step kept); the preemption flag."""
    _, _, trainer = _trainers(stage)
    vid, emb = torch.from_numpy(stage["video"]), torch.from_numpy(stage["embed"])
    trainer.train_step(vid, video_embed=emb, unet_number=2, draws=stage[2]["draws"])
    save_checkpoint(str(tmp_path / "ck"), trainer.state_dict())
    _, _, fresh = _trainers(stage)
    fresh.load_state_dict(load_checkpoint(str(tmp_path / "ck")))
    assert fresh.steps == trainer.steps == [0, 1]
    assert torch.equal(fresh.generator.get_state(), trainer.generator.get_state())
    for i in range(2):
        for k, v in trainer.params(i).items():
            assert torch.equal(fresh.params(i)[k], v), k
            assert torch.equal(fresh.ema[i].params[k], trainer.ema[i].params[k]), k
        a, b = trainer.optimizers[i].state_dict(), fresh.optimizers[i].state_dict()
        assert a["param_groups"] == b["param_groups"] and a["state"].keys() == b["state"].keys()
        for k in a["state"]:
            for n in a["state"][k]:
                assert torch.equal(a["state"][k][n], b["state"][k][n])

    mgr = RollingCheckpointManager(str(tmp_path / "roll"), max_to_keep=2, keep_period=3)
    for step, metric in zip(range(1, 8), (5.0, 3.0, 4.0, 9.0, 6.0, 7.0, 8.0)):
        mgr.save(step, {"step": step}, metrics={"val_loss": metric})
    assert mgr.all_steps() == [3, 6, 7] and mgr.latest_step() == 7 and mgr.best_step() == 2
    assert mgr.restore_best()["step"] == 2 and load_latest(str(tmp_path / "roll"))["step"] == 7
    assert has_checkpoint(str(tmp_path / "roll")) and not has_checkpoint(str(tmp_path / "none"))
    guard = PreemptionGuard(signals=(signal.SIGUSR1,))
    try:
        assert not guard.preempted
        os.kill(os.getpid(), signal.SIGUSR1)
        assert guard.preempted
        guard.emergency_save(mgr, 8, {"step": 8})
        assert mgr.latest_step() == 8 and (mgr.directory / "PREEMPTED").read_text() == "8"
    finally:
        guard.restore_handlers()


def test_train_entry_point_smoke_and_resume(tmp_path):
    """python -m dalle2_video_tpu_torch.train smoke=true on the CPU: one
    batch through both unets, validation, a checkpoint; resume=true picks it
    up. The dataset path and a multi-device mesh raise."""
    args = ["smoke=true", "device=cpu", f"run_dir={tmp_path}", "decoder.bf16_compute=false",
            "dim=16", "log_level=WARNING"]
    train_main(args)
    train_main(args + ["resume=true"])
    state = load_latest(str(tmp_path / "decoder_default"))
    assert state["steps"] == [2, 2] and state["ema"][0]["step"] == 2
    lines = (tmp_path / "decoder_default.metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 and all("nan" not in line for line in lines)
    with pytest.raises(NotImplementedError, match="dataset"):
        train_main(["device=cpu"])
    with pytest.raises(NotImplementedError, match="mesh"):
        train_main(args + ["mesh.data=4"])


def test_split_and_batch_loader_match_jax():
    """split_indices and two epochs of BatchLoader (seeded shuffle, drop
    remainder) give the JAX package's indices and batches exactly; a read
    error in the loader's thread fails the epoch."""
    from dalle2_video_tpu.data.datasets import BatchLoader as JaxLoader
    from dalle2_video_tpu.data.datasets import split_indices as jax_split
    from dalle2_video_tpu_torch.data.datasets import BatchLoader, split_indices

    for n in (10, 37):
        for k, v in jax_split(n).items():
            np.testing.assert_array_equal(split_indices(n)[k], v)

    class Rows:
        def __len__(self):
            return 11

        def batch_items(self, idx):
            return {"i": np.asarray(idx)}

    ours = BatchLoader(Rows(), 3, np.arange(2, 11), seed=4)
    theirs = JaxLoader(Rows(), 3, np.arange(2, 11), seed=4)
    assert len(ours) == len(theirs) == 3
    for _ in range(2):
        got, want = [b["i"] for b in ours], [b["i"] for b in theirs]
        assert len(got) == 3 and all(np.array_equal(a, w) for a, w in zip(got, want))
    assert [b["i"].tolist() for b in BatchLoader(Rows(), 4, shuffle=False)] == [
        [0, 1, 2, 3], [4, 5, 6, 7]]

    class Broken(Rows):
        def batch_items(self, idx):
            raise OSError("unreadable shard")

    with pytest.raises(OSError, match="unreadable"):
        list(BatchLoader(Broken(), 2))


# ------------------------------------------------------------ the model
def test_initialisers_follow_the_jax_package():
    """Zero biases, the zero output conv, kernels in U(+-1/sqrt(fan_in)),
    and the ICNR upsample (all four subpixels of a channel equal)."""
    torch.manual_seed(0)
    unet = UNet3D(UNet3DConfig(**UNET1, cond_on_video_embeds=True))
    n_bias = n_kernel = 0
    for name, p in unet.named_parameters():
        if name.endswith("bias"):
            assert float(p.detach().abs().max()) == 0.0, name
            n_bias += 1
        elif name.endswith(".weight") and p.ndim in (2, 4) and not name.startswith("to_out"):
            fan_in = p[0].numel()
            assert float(p.detach().abs().max()) <= fan_in**-0.5, name
            assert float(p.detach().abs().max()) > 0.5 * fan_in**-0.5, name
            n_kernel += 1
    assert n_bias > 10 and n_kernel > 20
    assert float(unet.to_out.Conv_0.weight.detach().abs().max()) == 0.0
    ups = [m for m in unet.modules() if type(m).__name__ == "PixelShuffleUpsample3D"]
    assert ups
    for m in ups:
        w = m.conv.detach().reshape(m.conv.shape[0], -1, 4)
        assert torch.equal(w, w[..., :1].expand_as(w))
        assert float(w.abs().max()) <= m.conv.shape[0] ** -0.5


def test_checkpointed_blocks_under_bf16_functional_call():
    """checkpoint_during_training with enable_checkpoint: every ResnetBlock3D
    recomputes in the backward inside the trainer's bf16 functional call,
    under remat_policy "nothing" (all of it) and "conv" (all but its convs),
    giving the gradients of the unchecked run exactly (same bf16 ops in the
    same order). An unknown remat policy raises."""
    grads = []
    for ckpt, policy in ((False, "nothing"), (True, "nothing"), (True, "conv")):
        torch.manual_seed(0)
        unet = UNet3D(UNet3DConfig(**UNET1, cond_on_video_embeds=True,
                                   checkpoint_during_training=ckpt, remat_policy=policy))
        torch.nn.init.normal_(unet.to_out.Conv_0.weight, std=0.1)
        cast = {k: p.to(torch.bfloat16) for k, p in unet.named_parameters()}
        rng = np.random.default_rng(10)
        x = torch.from_numpy(rng.standard_normal((1, 2, 16, 16, 3)).astype(np.float32))
        ve = torch.from_numpy(rng.standard_normal((1, D)).astype(np.float32))
        out = torch.func.functional_call(
            unet, cast, (x.bfloat16(), torch.tensor([3])),
            dict(video_embed=ve.bfloat16(), enable_checkpoint=True))
        out.float().square().mean().backward()
        grads.append({k: p.grad for k, p in unet.named_parameters()})
    for k, g in grads[0].items():
        assert g is not None and g.dtype == torch.float32, k
        for other in grads[1:]:
            torch.testing.assert_close(other[k], g, atol=0, rtol=0, msg=k)
    with pytest.raises(ValueError, match="remat_policy"):
        UNet3D(UNet3DConfig(**UNET1, checkpoint_during_training=True, remat_policy="everything"))


def test_sample_swaps_in_the_ema_shadow_and_restores(stage):
    """sampling_params / sample: with use_ema the cascade samples from the
    EMA shadows (same video as a decoder holding them), without it from the
    online params; the online params are back in place after either."""
    from dalle2_video_tpu_torch.utils.keys import RowKeys

    _, _, trainer = _trainers(stage)
    vid, emb = torch.from_numpy(stage["video"]), torch.from_numpy(stage["embed"])
    trainer.train_step(vid, video_embed=emb, unet_number=1, draws=stage["step"]["draws"])
    online = {k: v.detach().clone() for k, v in trainer.params(0).items()}
    shadow = trainer.sampling_params(use_ema=True)
    assert any(not torch.equal(shadow[0][k], online[k]) for k in online)
    kw = dict(video_embed=emb, batch_size=B, sample_timesteps=(2, 2))
    keys = RowKeys([1, 2])
    got_ema = trainer.sample(keys, use_ema=True, **kw)
    got_online = trainer.sample(keys, use_ema=False, **kw)
    for k, v in trainer.params(0).items():
        assert torch.equal(v.detach(), online[k]), k
    ref = _port_decoder(stage["params"])
    for i, unet in enumerate(ref.unets):
        unet.load_state_dict(shadow[i])
    torch.testing.assert_close(got_ema, ref.sample(keys, **kw), atol=0, rtol=0)
    torch.testing.assert_close(got_online, trainer.decoder.sample(keys, **kw), atol=0, rtol=0)
    assert not torch.equal(got_ema, got_online)
