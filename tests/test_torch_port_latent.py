"""The latent stage's VQGAN-VAE against the JAX package, on the CPU: the
vector quantiser (both codebook modes), the EMA codebook step, ConvVAE and
VQVAE, the PatchGAN discriminator, the hinge losses and ``gradient_l1``,
the initialisers, three ``VQGanTrainer.train_step``s across
``disc_start`` with ``eval_recon``, and the ``train_vqgan`` entry point.

Tiny widths (base 8, latent 4, a 16-code book, 2 frames at 16 px). JAX
parameters come from the JAX inits and are carried across with
``weights.load_from_jax`` / ``load_vqgan_train_state_from_jax``; inputs
are numpy draws from a seed. Everything runs in float32; the JAX programs
compile at XLA's lowest optimisation level.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle2_video_tpu.models.discriminator import PatchDiscriminator as JaxDisc
from dalle2_video_tpu.models.discriminator import hinge_d_loss as jax_hinge_d
from dalle2_video_tpu.models.discriminator import hinge_g_loss as jax_hinge_g
from dalle2_video_tpu.models.vae import ConvVAE as JaxConvVAE
from dalle2_video_tpu.models.vqvae import VQVAE as JaxVQVAE
from dalle2_video_tpu.models.vqvae import VectorQuantizer as JaxVQ
from dalle2_video_tpu.models.vqvae import ema_codebook_update as jax_ema_update
from dalle2_video_tpu.train.vqgan_trainer import VQGanTrainer as JaxVQGanTrainer
from dalle2_video_tpu.train.vqgan_trainer import VQGanTrainerConfig as JaxVQGanCfg
from dalle2_video_tpu.train.vqgan_trainer import VQGanTrainState as JaxVQGanTrainState
from dalle2_video_tpu.train.vqgan_trainer import gradient_l1 as jax_gradient_l1
from dalle2_video_tpu_torch.models.discriminator import (
    PatchDiscriminator,
    hinge_d_loss,
    hinge_g_loss,
)
from dalle2_video_tpu_torch.models.vae import ConvVAE, NullVAE
from dalle2_video_tpu_torch.models.vqvae import VQVAE, VectorQuantizer, ema_codebook_update
from dalle2_video_tpu_torch.train import train_vqgan
from dalle2_video_tpu_torch.train.vqgan_trainer import (
    VQGanTrainer,
    VQGanTrainerConfig,
    clip_by_global_norm_,
    gradient_l1,
)
from dalle2_video_tpu_torch.weights import (
    load_from_jax,
    load_vqgan_train_state_from_jax,
    params_from_jax,
)
from test_torch_port_prior_moe import jax_tree_of

torch.set_num_threads(1)
CPU = torch.device("cpu")
VAE = dict(latent_dim=4, base_dim=8, num_down=1, codebook_size=16)
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def t_(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _video(seed, shape=(2, 2, 16, 16, 3)):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def _close(got, want, rtol, atol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert np.all(err <= atol + rtol * np.abs(want)), (what, float(err.max()))


@functools.lru_cache(maxsize=None)
def _jax_vqvae(ema: bool = False, num_down: int = 1):
    jv = JaxVQVAE(**dict(VAE, num_down=num_down), codebook_ema=ema)
    return jv, _jit(lambda k: jv.init_params(k, frame_size=16, frames=2), jax.random.PRNGKey(0))


def _port_vqvae(params, ema: bool = False, num_down: int = 1) -> VQVAE:
    return load_from_jax(VQVAE(**dict(VAE, num_down=num_down), codebook_ema=ema, device=CPU),
                         _np(params))


# --------------------------------------------------------------- the quantiser
@pytest.mark.parametrize("ema", [False, True], ids=["loss-codebook", "ema-codebook"])
def test_vector_quantizer_matches_jax(ema):
    """f32: the codes (exactly; argmin's first minimum), the quantised
    latents and the VQ loss (1e-6), and the straight-through gradient to z
    of sum(w * quant) + loss (1e-6); with ``ema`` the codebook is a buffer
    and takes no gradient, else it gets the embed term's."""
    rng = np.random.default_rng(3)
    z = rng.standard_normal((2, 2, 4, 4, 4)).astype(np.float32) * 0.3
    w = rng.standard_normal(z.shape).astype(np.float32)
    jvq = JaxVQ(16, 4, ema=ema)
    params = _jit(jvq.init, jax.random.PRNGKey(2), jnp.asarray(z))

    def f(p, z):
        quant, idx, loss = jvq.apply(p, z)
        return jnp.sum(quant * w) + loss, (quant, idx, loss)

    (_, (quant, idx, loss)), (g_p, g_z) = _jit(
        jax.value_and_grad(f, argnums=(0, 1), has_aux=True), params, jnp.asarray(z))
    vq = load_from_jax(VectorQuantizer(16, 4, ema=ema), _np(params))
    assert isinstance(vq.codebook, torch.nn.Parameter) != ema
    zt = t_(z).requires_grad_(True)
    q, i, l = vq(zt)
    ((q * t_(w)).sum() + l).backward()
    assert torch.equal(i, torch.from_numpy(np.asarray(idx)).long())
    _close(q.detach(), quant, 1e-6, 1e-6, "quant")
    _close(l.detach(), loss, 1e-6, 1e-7, "loss")
    _close(zt.grad, g_z, 1e-6, 1e-6, "grad z")
    if ema:
        assert vq.codebook.grad is None
        assert float(np.abs(np.asarray(g_p["params"]["codebook"])).max()) == 0.0
    else:
        _close(vq.codebook.grad, g_p["params"]["codebook"], 1e-5, 1e-7, "grad codebook")


def test_ema_codebook_update_matches_jax():
    """f32, 1e-6: the decayed counts and sums and the Laplace-smoothed
    codebook, with some codes unused."""
    rng = np.random.default_rng(4)
    cb = rng.standard_normal((16, 4)).astype(np.float32)
    cs = rng.random(16).astype(np.float32)
    ea = rng.standard_normal((16, 4)).astype(np.float32)
    z = rng.standard_normal((2, 3, 5, 4)).astype(np.float32)
    idx = rng.integers(0, 12, (2, 3, 5))
    want = _jit(lambda *a: jax_ema_update(*a, decay=0.8), cb, cs, ea, z, jnp.asarray(idx))
    got = ema_codebook_update(t_(cb), t_(cs), t_(ea), t_(z), torch.from_numpy(idx), decay=0.8)
    for g, w_, what in zip(got, want, ("codebook", "cluster_size", "embed_avg")):
        _close(g, w_, 1e-6, 1e-6, what)


# --------------------------------------------------------------- the VAEs
def test_conv_vae_matches_jax():
    """f32, 1e-5 of the output's scale: ConvVAE (two 4x4 stride-2 downs
    with the floor pad, nearest x2 ups) encode and decode; NullVAE is the
    identity."""
    jv = JaxConvVAE(latent_dim=4, base_dim=8, num_down=2)
    params = _jit(lambda k: jv.init_params(k, frame_size=16), jax.random.PRNGKey(1))
    x = _video(5, (2, 3, 16, 16, 3))
    z, rec = _jit(lambda p, x: (jv.encode(p, x), jv.decode(p, jv.encode(p, x))), params, x)
    m = load_from_jax(ConvVAE(latent_dim=4, base_dim=8, num_down=2, device=CPU), _np(params))
    with torch.no_grad():
        gz = m.encode(t_(x))
        grec = m.decode(gz)
    assert gz.shape == (2, 3, 4, 4, 4) and m.get_encoded_fmap_size(16) == 4
    _close(gz, z, 0, 1e-5 * np.abs(z).max(), "encode")
    _close(grec, rec, 0, 1e-5 * np.abs(rec).max(), "decode")
    null = NullVAE(3)
    assert null.encode(t_(x)) is not None and not null.is_latent and null.encoded_dim == 3
    assert (m.is_latent, m.encoded_dim, m.downsample_factor) == (True, 4, 4)


@pytest.mark.parametrize("ema", [False, True], ids=["loss-codebook", "ema-codebook"])
def test_vqvae_matches_jax(ema):
    """f32: encode (the quantised latents, 1e-6 of their scale),
    codebook_indices (exactly), decode (1e-5 of the output's scale), and
    loss with its parts and its gradients (1e-5 relative of each leaf's
    largest value; the straight-through estimator carries the encoder's)."""
    jv, params = _jax_vqvae(ema)
    x = _video(6)
    want = _jit(lambda p, x: (jv.encode(p, x), jv.codebook_indices(p, x),
                              jv.decode(p, jv.encode(p, x)), jv.loss(p, x),
                              jax.grad(lambda p: jv.loss(p, x)[0])(p)), params, x)
    z, idx, rec, (total, parts), grads = want
    m = _port_vqvae(params, ema)
    gz = m.encode(t_(x)).detach()
    _close(gz, z, 0, 1e-6 * np.abs(z).max(), "encode")
    assert torch.equal(m.codebook_indices(t_(x)), torch.from_numpy(np.asarray(idx)).long())
    _close(m.decode(gz).detach(), rec, 0, 1e-5 * np.abs(rec).max(), "decode")
    loss, got_parts = m.loss(t_(x))
    _close(loss.detach(), total, 1e-5, 0, "loss")
    for k in ("recon", "vq"):
        _close(got_parts[k].detach(), parts[k], 1e-5, 0, k)
    loss.backward()
    want_g = params_from_jax(_np(grads))
    for name, p in m.named_parameters():
        _close(p.grad, want_g[name], 0, 1e-5 * float(want_g[name].abs().max()) + 1e-12, name)
    assert ("vq.codebook" in dict(m.named_parameters())) != ema


# --------------------------------------------------------------- the discriminator
@pytest.mark.parametrize("layers", [1, 3])
def test_patch_discriminator_matches_jax(layers):
    """f32, 1e-5 of the logits' scale: the 4x4 pad-1 pyramid, the channel
    cap at 8x base, GroupNorm at epsilon 1e-6, LeakyReLU 0.2, the frames
    folded into the batch; and the input gradient (1e-5 of its scale)."""
    jd = JaxDisc(base_dim=8, num_layers=layers)
    size = 32 if layers == 3 else 16
    x = _video(7, (1, 2, size, size, 3))
    params = _jit(jd.init, jax.random.PRNGKey(3), x)
    out, gx = _jit(lambda p, x: (jd.apply(p, x), jax.grad(
        lambda x: jnp.sum(jd.apply(p, x) ** 2))(x)), params, x)
    d = load_from_jax(PatchDiscriminator(base_dim=8, num_layers=layers, device=CPU),
                      _np(params))
    xt = t_(x).requires_grad_(True)
    got = d(xt)
    (got**2).sum().backward()
    _close(got.detach(), out, 0, 1e-5 * np.abs(out).max(), "logits")
    _close(xt.grad, gx, 0, 1e-5 * np.abs(gx).max(), "grad x")
    assert all(m.eps == 1e-6 for m in d.modules() if isinstance(m, torch.nn.GroupNorm))


def test_hinge_losses_and_gradient_l1_match_jax():
    """f32, 1e-6: the hinge D / G losses; gradient_l1 at scales 1, 1/2 and
    1/4 (the JAX "linear" resize, antialiased when it downsamples) and its
    gradient in a (1e-6 of its scale); 0 on identical inputs."""
    rng = np.random.default_rng(8)
    lr_, lf = (rng.standard_normal((4, 3, 3, 1)).astype(np.float32) for _ in range(2))
    _close(hinge_d_loss(t_(lr_), t_(lf)), jax_hinge_d(lr_, lf), 1e-6, 1e-7, "hinge d")
    _close(hinge_g_loss(t_(lf)), jax_hinge_g(lf), 1e-6, 1e-7, "hinge g")
    a, b = _video(9), _video(10)
    want, ga = _jit(jax.value_and_grad(jax_gradient_l1), a, b)
    at = t_(a).requires_grad_(True)
    got = gradient_l1(at, t_(b))
    got.backward()
    _close(got.detach(), want, 1e-6, 1e-7, "gradient_l1")
    _close(at.grad, ga, 0, 1e-6 * np.abs(ga).max(), "grad")
    assert float(gradient_l1(t_(a), t_(a))) == 0.0


def test_initialisers_follow_the_jax_package():
    """Each leaf's init against the JAX init of the same shape: zero biases,
    unit GroupNorm scales, conv kernels in U(+-1/sqrt(fan_in)) with the
    largest |w| within 10% of the bound on both sides, and the codebook in
    U(+-sqrt(3 / K)): flax's fan-in of the (K, d) codebook is K."""
    jv, jparams = _jax_vqvae(False, 2)
    jd = JaxDisc(base_dim=8, num_layers=3)
    jdp = _jit(jd.init, jax.random.PRNGKey(4), jnp.zeros((1, 2, 32, 32, 3)))
    torch.manual_seed(0)
    pairs = [(VQVAE(**dict(VAE, num_down=2, codebook_size=512), device=CPU),
              _jit(lambda k: JaxVQVAE(**dict(VAE, num_down=2, codebook_size=512)).init_params(
                  k, frame_size=16, frames=2), jax.random.PRNGKey(5))),
             (PatchDiscriminator(base_dim=8, num_layers=3, device=CPU), jdp)]
    for module, tree in pairs:
        want = params_from_jax(_np(tree))
        got = dict(module.named_parameters())
        assert set(got) == set(want)
        for name, p in got.items():
            w = want[name]
            if name.endswith("bias"):
                assert float(p.abs().max()) == float(w.abs().max()) == 0.0, name
                continue
            if "GroupNorm" in name:
                assert torch.equal(p.detach(), torch.ones_like(p)) and torch.equal(w, p.detach())
                continue
            fan_in = p.shape[0] if name == "vq.codebook" else p[0].numel()
            bound = (3.0 / fan_in) ** 0.5 if name == "vq.codebook" else fan_in**-0.5
            for what, v in (("port", p.detach()), ("jax", w)):
                assert 0.9 * bound < float(v.abs().max()) <= bound, (what, name)
    assert jparams["vq"]["params"]["codebook"].shape == (16, 4)


# --------------------------------------------------------------- the trainer
def _adam(opt_state):
    adam = [s for s in opt_state if isinstance(s, optax.ScaleByAdamState)][0]
    return {"mu": _np(adam.mu), "nu": _np(adam.nu), "count": int(adam.count)}


def _check_adam(opt, module, want, what, frozen=()):
    """Port Adam state against optax's (rtol 1e-4 plus 1e-5 of the leaf's
    largest value: the f32 gradients differ in their last bits)."""
    mu, nu = params_from_jax(want["mu"]), params_from_jax(want["nu"])
    for name, p in module.named_parameters():
        st = opt.state[p]
        assert int(st["step"]) == want["count"], (what, name)
        for key, ref in (("exp_avg", mu[name]), ("exp_avg_sq", nu[name])):
            _close(st[key], ref, 1e-4, 1e-5 * float(ref.abs().max()) + 1e-30,
                   f"{what} {key} {name}")
    for name in frozen:
        assert float(mu[name].abs().max()) == float(nu[name].abs().max()) == 0.0


@pytest.mark.parametrize("ema", [False, True], ids=["loss-codebook", "ema-codebook"])
def test_vqgan_train_steps_match_jax(ema):
    """Three VQGanTrainer.train_steps from a carried JAX state (after one
    JAX step: step 1, the G moments non-zero, D's zero) at disc_start 2, so
    the first is gated and the next two are not: every metric with lambda
    (1e-5 relative), the VAE's and the discriminator's parameters (rtol
    1e-4 + 2e-6), both Adam states and their counts (D's count advancing
    while gated, its moments zero until the gate opens), ``vq_ema`` (1e-5),
    step, and eval_recon after (1e-5). A parameter whose gradient RMS (the
    square root of Adam's second moment) is below 1e-2 of its tensor's
    largest (and not 0) is held within the three steps' reach, 3 lr,
    instead: there Adam's step lr * m / sqrt(v) turns the f32 sums' noise
    in g (~1e-5 of the largest) into more than 1e-6 (at most 10% of a
    tensor's values). The discriminator collects no
    gradient from the G pass (its first open step's moments equal optax's
    from the D loss alone)."""
    vae = JaxVQVAE(**VAE, codebook_ema=ema, ema_decay=0.8)
    jtr = JaxVQGanTrainer(vae, JaxDisc(base_dim=8, num_layers=1),
                          JaxVQGanCfg(lr_g=1e-3, lr_d=1e-3, disc_start=2))
    # init_state's layout from the port's seeded init (jax_tree_of: no flax
    # init traced), the optax states from the JAX chains
    g = torch.Generator().manual_seed(0)
    tree = jax_tree_of(VQVAE(**VAE, device=CPU, generator=g))["params"]
    vp = {k: {"params": v} for k, v in tree.items()}
    dp = jax_tree_of(PatchDiscriminator(base_dim=8, num_layers=1, device=CPU, generator=g))
    vq_ema = None if not ema else {"cluster_size": np.zeros(16, np.float32),
                                   "embed_avg": vp["vq"]["params"]["codebook"]}
    state = _jit(lambda vp, dp, e: JaxVQGanTrainState(
        vae_params=vp, disc_params=dp, opt_g=jtr.tx_g.init(vp), opt_d=jtr.tx_d.init(dp),
        step=jnp.zeros((), jnp.int32), vq_ema=e), vp, dp, vq_ema)
    videos = [_video(20 + i) for i in range(4)]
    step = jax.jit(jtr.train_step).lower(state, videos[0]).compile(compiler_options=_O0)
    state, _ = step(state, videos[0])

    tr = VQGanTrainer(VQVAE(**VAE, codebook_ema=ema, ema_decay=0.8, device=CPU),
                      PatchDiscriminator(base_dim=8, num_layers=1, device=CPU),
                      VQGanTrainerConfig(lr_g=1e-3, lr_d=1e-3, disc_start=2))

    def carried(state):
        return {"vae_params": _np(state.vae_params), "disc_params": _np(state.disc_params),
                "opt_g": _adam(state.opt_g), "opt_d": _adam(state.opt_d),
                "step": int(state.step), "vq_ema": None if state.vq_ema is None
                else _np(state.vq_ema)}

    load_vqgan_train_state_from_jax(tr, carried(state))
    assert tr.step == 1
    for k, video in enumerate(videos[1:]):
        state, want = step(state, video)
        got = tr.train_step(t_(video))
        for key in want:
            _close(got[key], want[key], 1e-5, 1e-6, f"step {k} {key}")
        assert (float(got["lambda_adapt"]) == 0.0) == (k == 0)
    final = carried(state)
    assert tr.step == final["step"] == 4
    for module, key, opt in ((tr.vae, "vae_params", "opt_g"), (tr.disc, "disc_params", "opt_d")):
        want_p = params_from_jax(final[key])
        rms = {k: v.sqrt() for k, v in params_from_jax(final[opt]["nu"]).items()}
        trained = dict(module.named_parameters())
        for name, v in module.state_dict().items():
            if name not in trained:  # the EMA codebook: no optimiser state
                _close(v, want_p[name], 1e-4, 2e-6, f"{key} {name}")
                continue
            # Adam's step lr * m / sqrt(v) moves by ~lr * dg / g for an f32
            # error dg in g; the gradients' f32 sums are within ~1e-5 of
            # the tensor's largest, so below 1e-2 of it the step's error
            # passes 1e-6 (lr 1e-3), up to the whole step
            # (a gradient exactly 0 on both sides, an unused code's, moves
            # nothing: held tightly too)
            tight = (rms[name] >= 1e-2 * rms[name].max()) | (rms[name] == 0)
            _close(v[tight], want_p[name][tight], 1e-4, 2e-6, f"{key} {name}")
            _close(v[~tight], want_p[name][~tight], 0.0, 3 * 1e-3, f"{key} {name} (small g)")
            assert float((~tight).float().mean()) <= 0.1, (key, name)
    _check_adam(tr.opt_g, tr.vae, final["opt_g"], "G", frozen=("vq.codebook",) if ema else ())
    _check_adam(tr.opt_d, tr.disc, final["opt_d"], "D")
    if ema:
        for key in ("cluster_size", "embed_avg"):
            _close(tr.vq_ema[key], final["vq_ema"][key], 1e-5, 1e-6, key)
    want = _jit(jtr.eval_recon, state, videos[0])
    got = tr.eval_recon(t_(videos[0]))
    for key in want:
        _close(got[key], want[key], 1e-5, 1e-6, key)


def test_clip_by_global_norm_follows_optax():
    """optax.clip_by_global_norm: above the bound every leaf becomes
    g / ||g|| * max (f32, 1e-7); at or below it the leaves are untouched."""
    rng = np.random.default_rng(11)
    leaves = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (5,), (2, 2, 2))]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(leaves, None)
        got = [t_(a) for a in leaves]
        clip_by_global_norm_(got, max_norm)
        for g, w in zip(got, want):
            _close(g, w, 1e-7, 1e-8, f"max {max_norm}")
            if max_norm == 100.0:
                assert torch.equal(g, t_(np.asarray(w)))


def test_train_vqgan_entry_point_writes_and_resumes(tmp_path, monkeypatch):
    """``main`` in-process with smoke=true (the JAX script's widths and its 8
    synthetic clips): one epoch writes the whole state at step 3 (6 train
    clips at batch 2) with val_loss = val/rec_l1 and the metrics file;
    resume=true restores it and carries on to step 6 (two epochs), the VAE
    restored equal to the first run's before it trains on."""
    base = ["smoke=true", "device=cpu", f"run_dir={tmp_path}"]
    monkeypatch.setitem(train_vqgan.SMOKE_VQGAN, "epochs", 1)
    first = train_vqgan.main(base)
    tr = first["trainer"]
    assert tr.step == 3 and set(first["val"]) == {"val/rec_l1", "val/psnr", "val/vq"}
    run = tmp_path / "vqgan_default"
    assert (run / "recent" / "3").is_dir() and (run / "best" / "3").is_dir()
    assert (tmp_path / "vqgan_default.metrics.jsonl").exists()
    state = train_vqgan.load_latest(str(run))
    assert state["step"] == 3 and state["vq_ema"] is None
    assert set(state) == {"vae_params", "disc_params", "opt_g", "opt_d", "step", "vq_ema"}
    vae = train_vqgan.load_vqvae(str(run), dict(train_vqgan.SMOKE_VQGAN), CPU)
    assert not any(p.requires_grad for p in vae.parameters())
    for k, v in tr.vae.state_dict().items():
        assert torch.equal(vae.state_dict()[k], v), k
    monkeypatch.setitem(train_vqgan.SMOKE_VQGAN, "epochs", 2)
    second = train_vqgan.main(base + ["resume=true"])
    assert second["trainer"].step == 6
    assert int(second["trainer"].opt_g.state[next(iter(second["trainer"].vae.parameters()))]
               ["step"]) == 6
    assert sorted(int(p.name) for p in (run / "recent").iterdir()) == [3, 6]
