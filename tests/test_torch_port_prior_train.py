"""The prior's training against the JAX package, and the stages 1-2
pipeline of the README on the CPU: ``DiffusionPrior.loss`` with the JAX
draws injected, four Adam + EMA steps of ``train.train_prior.PriorTrainer``
against scripts/train_prior.py's jitted step, ``load_params_subtree``
choosing the EMA shadow, and the entry points in order on a store written
inside the test -- ``train_clip`` -> ``eval_clip`` (the handoff) ->
``train_prior`` (and ``resume=true``) -> the decoder trained on the
handoff's embeddings -> ``serve/stack.py::build_stack`` serving the
checkpoints those runs wrote.

A tiny prior (dim 32, depth 2, 2 heads of 8, 100 timesteps), f32. JAX's
threefry draws cannot be made in PyTorch: each test splits the JAX key as
``DiffusionPrior.loss`` does (prior.py:422-427) and injects the times, the
noise and the text keep mask. The JAX programs compile at XLA's lowest
optimisation level.
"""

from __future__ import annotations

import functools
import logging

import jax
import numpy as np
import optax
import pytest
import torch

from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
from dalle2_video_tpu.models.prior import DiffusionPriorConfig as JaxPriorCfg
from dalle2_video_tpu.models.prior import PriorNetworkConfig as JaxNetCfg
from dalle2_video_tpu.train.ema import EMAConfig as JaxEMACfg
from dalle2_video_tpu.train.ema import ema_init as jax_ema_init
from dalle2_video_tpu.train.ema import ema_update as jax_ema_update
from dalle2_video_tpu_torch.models.clip_text import CLIPTextEncoder
from dalle2_video_tpu_torch.models.prior import (
    DiffusionPrior,
    DiffusionPriorConfig,
    PriorNetworkConfig,
)
from dalle2_video_tpu_torch.serve import stack
from dalle2_video_tpu_torch.train import (
    RollingCheckpointManager,
    eval_clip,
    load_best,
    load_decoder_sampling_params,
    load_params_subtree,
    train_clip,
    train_prior,
)
from dalle2_video_tpu_torch.train.__main__ import main as train_decoder_main
from dalle2_video_tpu_torch.train.ema import EMAConfig
from dalle2_video_tpu_torch.weights import (
    load_from_jax,
    load_prior_train_state_from_jax,
    params_from_jax,
)
from test_torch_port_clip import TEXT, write_clip_store

torch.set_num_threads(1)
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
NET = dict(dim=32, depth=2, heads=2, dim_head=8)
B, T = 8, 100


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _close(got, want, rtol, atol, what):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= atol + rtol * np.abs(want)), (what, float(err.max()))


@functools.lru_cache(maxsize=None)
def _jax_params():
    jp = JaxPrior(JaxPriorCfg(network=JaxNetCfg(**NET), timesteps=T))
    k = jax.random.PRNGKey(0)
    return _compiled(jp.init_params, k)(k)


def _priors(**cfg):
    jp = JaxPrior(JaxPriorCfg(network=JaxNetCfg(**NET), timesteps=T, **cfg))
    tp = DiffusionPrior(DiffusionPriorConfig(network=PriorNetworkConfig(**NET), timesteps=T,
                                             **cfg), device="cpu")
    params = _jax_params()
    load_from_jax(tp.network, _np_tree(params))
    return jp, tp, params


@functools.lru_cache(maxsize=None)
def _draw_fn(jp, b, d):
    def fn(key):
        k_t, k_n, k_drop, _ = jax.random.split(key, 4)
        return (jp.schedule.sample_random_times(k_t, b), jax.random.normal(k_n, (b, d)),
                jax.random.bernoulli(k_drop, 1.0 - jp.config.text_cond_drop_prob, (b,)))
    return _compiled(fn, jax.random.PRNGKey(0))


def _draws(jp, key, b, d):
    """The draws of JAX DiffusionPrior.loss for ``key``, in its split order."""
    times, noise, keep = _draw_fn(jp, b, d)(key)
    return {"times": torch.from_numpy(np.asarray(times)).long(),
            "noise": torch.from_numpy(np.asarray(noise)),
            "text_keep": torch.from_numpy(np.asarray(keep))}


def _embeds(seed, b=B, d=NET["dim"]):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, d)).astype(np.float32),
            rng.standard_normal((b, d)).astype(np.float32))


@pytest.mark.parametrize("cfg", [dict(), dict(text_cond_drop_prob=0.5, predict_x_start=False,
                                              training_clamp_l2norm=True)],
                         ids=["recipe", "eps-target-clamped"])
def test_prior_loss_matches_jax(cfg):
    """f32, 1e-5 relative: x0 x embed_scale, q_sample at the drawn times on
    the cosine schedule, the null text embed where the keep mask is False,
    l2 against x0 (or the noise)."""
    jp, tp, params = _priors(**cfg)
    ve, te = _embeds(1)
    key = jax.random.PRNGKey(5)
    want = _compiled(jp.loss, params, key, ve, te)(params, key, ve, te)
    draws = _draws(jp, key, B, NET["dim"])
    if cfg:
        assert 0 < int(draws["text_keep"].sum()) < B  # both branches of the mask
    got = tp.loss(torch.from_numpy(ve), torch.from_numpy(te), draws=draws)
    _close(got, want, 1e-5, 1e-6, "loss")
    g = torch.Generator().manual_seed(0)
    assert torch.isfinite(tp.loss(torch.from_numpy(ve), torch.from_numpy(te), generator=g))


def test_prior_adam_ema_steps_match_jax():
    """K = 4 PriorTrainer steps from a carried JAX state (after one JAX step:
    non-zero moments) with each step's JAX draws injected, against
    scripts/train_prior.py's step (optax adam, ema_update): every loss
    (1e-5 relative), then the params, the Adam moments and count, and the
    EMA shadow and its step (rtol 1e-4 plus 1e-5 of each tensor's largest
    value). The EMA blends from step 2 (update_after_step 1, every step)."""
    jp, tp, params = _priors()
    lr = 1e-3
    ema_cfg = dict(beta=0.99, update_after_step=1, update_every=1)
    optimizer = optax.adam(lr)

    def step(params, opt_state, ema, key, ve, te):
        loss, grads = jax.value_and_grad(lambda p: jp.loss(p, key, ve, te))(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, jax_ema_update(ema, params, JaxEMACfg(**ema_cfg)), loss

    opt_state = _compiled(optimizer.init, params)(params)
    ema = jax_ema_init(params)
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    batches = [_embeds(20 + i) for i in range(5)]
    jstep = _compiled(step, params, opt_state, ema, keys[0], *batches[0])
    state = jstep(params, opt_state, ema, keys[0], *batches[0])

    tr = train_prior.PriorTrainer(tp, lr, use_ema=True, ema=EMAConfig(**ema_cfg))
    adam = state[1][0]
    load_prior_train_state_from_jax(tr, {
        "params": _np_tree(state[0]),
        "opt_state": {"mu": _np_tree(adam.mu), "nu": _np_tree(adam.nu), "count": adam.count},
        "ema": {"params": _np_tree(state[2].params), "step": state[2].step}, "step": 1})
    for key, (ve, te) in zip(keys[1:], batches[1:]):
        state = jstep(*state[:3], key, ve, te)
        got = tr.train_step(torch.from_numpy(ve), torch.from_numpy(te),
                            draws=_draws(jp, key, B, NET["dim"]))
        _close(got, state[3], 1e-5, 1e-6, "loss")
    assert tr.step == 5 and tr.ema.step == int(state[2].step) == 5
    adam = state[1][0]
    trees = {"params": params_from_jax(_np_tree(state[0])),
             "mu": params_from_jax(_np_tree(adam.mu)), "nu": params_from_jax(_np_tree(adam.nu)),
             "ema": params_from_jax(_np_tree(state[2].params))}
    for k, p in tr.prior.network.named_parameters():
        st = tr.optimizer.state[p]
        assert int(st["step"]) == int(adam.count) == 5
        for name, got in (("params", p.detach()), ("mu", st["exp_avg"]),
                          ("nu", st["exp_avg_sq"]), ("ema", tr.ema.params[k])):
            want = trees[name][k]
            _close(got, want, 1e-4, 1e-5 * float(want.abs().max()), f"{name} {k}")
    assert not all(torch.equal(tr.ema.params[k], p)
                   for k, p in tr.prior.network.named_parameters())


def test_load_params_subtree_prefers_the_ema_shadow(tmp_path):
    """From a full training state {params, opt_state[, ema]}: the EMA
    shadow's params when present (unless prefer_ema=False), else the
    params; best (by val_loss) or latest; bare params come back as saved."""
    def state(v, ema=True):
        s = {"params": {"w": torch.full((2,), v)}, "opt_state": {}, "step": int(v)}
        if ema:
            s["ema"] = {"params": {"w": torch.full((2,), -v)}, "step": int(v)}
        return s

    mgr = RollingCheckpointManager(str(tmp_path / "ema"), best_k=1)
    mgr.save(1, state(1.0), metrics={"val_loss": 0.5})
    mgr.save(2, state(2.0), metrics={"val_loss": 0.9})
    path = str(tmp_path / "ema")
    assert float(load_params_subtree(path)["w"][0]) == -1.0  # best, EMA
    assert float(load_params_subtree(path, which="latest")["w"][0]) == -2.0
    assert float(load_params_subtree(path, prefer_ema=False)["w"][0]) == 1.0
    assert load_best(path)["step"] == 1
    plain = RollingCheckpointManager(str(tmp_path / "plain"))
    plain.save(3, state(3.0, ema=False))
    assert float(load_params_subtree(str(tmp_path / "plain"))["w"][0]) == 3.0
    bare = RollingCheckpointManager(str(tmp_path / "bare"))
    bare.save(4, {"w": torch.ones(2)})
    assert set(load_params_subtree(str(tmp_path / "bare"))) == {"w"}
    with pytest.raises(ValueError, match="which"):
        load_params_subtree(path, which="last")


def test_load_decoder_sampling_params_prefers_each_unets_ema_shadow(tmp_path):
    """From the decoder's best training state, one state dict per unet: the
    EMA shadow's parameters where the unet has one, the other entries
    (buffers) and the EMA-less unets' as saved."""
    def state(v):
        return {"params": [{"w": torch.full((2,), v), "buf": torch.zeros(1)},
                           {"w": torch.full((2,), 2 * v)}],
                "ema": [{"params": {"w": torch.full((2,), -v)}, "step": 1}, None],
                "steps": [int(v), int(v)]}

    mgr = RollingCheckpointManager(str(tmp_path / "decoder"), best_k=1)
    mgr.save(1, state(1.0), metrics={"val_loss": 0.5})
    mgr.save(2, state(2.0), metrics={"val_loss": 0.9})
    path = str(tmp_path / "decoder")
    served = load_decoder_sampling_params(path)
    assert [set(sd) for sd in served] == [{"w", "buf"}, {"w"}]
    assert [float(sd["w"][0]) for sd in served] == [-1.0, 2.0]  # best: step 1


@pytest.mark.parametrize("override", [("mesh.data=2",), ("prior.expert_parallel=2",),
                                      ("prior.ff_experts=4", "prior.expert_parallel=4"),
                                      ("prior.pipeline_microbatches=2",)],
                         ids=["mesh.data=2", "prior.expert_parallel=2",
                              "prior.ff_experts=4-expert_parallel=4",
                              "prior.pipeline_microbatches=2"])
def test_train_prior_refuses_unported_options(tmp_path, override):
    """What needs more than one device raises: a mesh, expert parallelism,
    the pipeline (the stacked layout and the experts themselves train:
    tests/test_torch_port_prior_moe.py)."""
    ve, te = _embeds(3, b=6)
    np.save(tmp_path / "v.npy", ve)
    np.save(tmp_path / "t.npy", te)
    with pytest.raises(NotImplementedError):
        train_prior.main([f"videos.embed={tmp_path}/v.npy", f"texts.embed={tmp_path}/t.npy",
                          "device=cpu", f"run_dir={tmp_path}", "dim=32", *override])


_DECODER = ["frame_sizes=[8,16]", "frame_numbers=[2,2]", "decoder.batch_size=2",
            "decoder.epochs=1", "decoder.bf16_compute=false", "unet1.dim=16", "unet2.dim=8",
            *(f"unet{u}.{k}" for u in (1, 2) for k in (
                "dim_mults=[1,2]", "num_resnet_blocks=1", "attn_heads=2", "attn_dim_head=8"))]
_PRIOR = ["prior.depth=1", "prior.heads=2", "prior.dim_head=8", "prior.batch_size=2",
          "prior.epochs=2", "prior.use_ema=true", "prior.ema_update_after_step=1",
          "prior.ema_update_every=1", "prior.sample_timesteps=2"]


def test_stages_run_in_order_and_serve_their_checkpoints(tmp_path, monkeypatch):
    """README's order on a 7-clip store: train_clip, eval_clip (the
    handoff, its tail embedded), train_prior on the handoff (use_ema; 2
    epochs, then resume=true to a third), the decoder trained on the
    handoff's video embeds, then build_stack with that run_dir: the served
    prior equals the prior checkpoint's EMA shadow (not its online params),
    the served unets the decoder's best state's EMA shadows, the text tower
    the OpenAI checkpoint's when one is named; one request is answered."""
    for mod in (train_clip, eval_clip):
        monkeypatch.setattr(mod, "text_config", lambda cfg: train_clip.CLIPTextConfig(**TEXT))
    args = write_clip_store(tmp_path)
    train_clip.main(args)
    handoff = eval_clip.main(args)
    assert handoff["video_embeds"].shape == (7, 24)

    s = train_prior.main(args + _PRIOR)
    assert s["trainer"].step == 4 and np.isfinite(s["val_loss"])
    s = train_prior.main(args + _PRIOR + ["resume=true", "prior.epochs=3"])
    assert s["trainer"].step == 6 and s["trainer"].ema.step == 6
    prior_state = RollingCheckpointManager(str(tmp_path / "runs/prior_default")).restore_latest()
    assert set(prior_state) == {"params", "opt_state", "ema", "step", "generator"}

    train_decoder_main(args + _DECODER + ["max_steps=2"])
    dec_state = load_best(str(tmp_path / "runs/decoder_default"))
    assert dec_state["steps"] == [2, 2]

    cfg = train_clip.config_from_argv(args + _PRIOR + _DECODER)
    # an OpenAI checkpoint for the server's 12 x 512 tower: a seeded state
    # dict stands in for the file (tests/test_torch_port_clip.py holds the
    # loader itself)
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(7)
        openai_sd = CLIPTextEncoder(stack.CLIPTextConfig(embed_dim=24)).state_dict()
    read = []
    monkeypatch.setattr(stack, "load_openai_clip_text_params",
                        lambda path: read.append(path) or openai_sd)
    text_enc, wrapper = stack.build_stack(dict(cfg, clip=dict(cfg["clip"],
                                                              openai_ckpt="openai.pt")), "cpu")
    assert read == ["openai.pt"]
    assert all(torch.equal(text_enc.state_dict()[k], v) for k, v in openai_sd.items())
    best_prior = load_params_subtree(str(tmp_path / "runs/prior_default"))
    served = dict(wrapper.prior.network.named_parameters())
    assert set(served) == set(best_prior)
    assert all(torch.equal(served[k], v) for k, v in best_prior.items())
    best_state = load_best(str(tmp_path / "runs/prior_default"))
    assert not all(torch.equal(served[k], v) for k, v in best_state["params"].items())
    for i, unet in enumerate(wrapper.decoder.unets):
        shadow = dec_state["ema"][i]["params"]
        assert all(torch.equal(p, shadow[k]) for k, p in unet.named_parameters())
        assert not all(torch.equal(p, dec_state["params"][i][k])
                       for k, p in unet.named_parameters())

    generate = stack.build_generate_batch(cfg, logging.getLogger("test"), "cpu")
    video = generate(["a person smiling"], [3], cond_scale=3.0, ddim_steps=2)
    assert video.shape == (1, 2, 16, 16, 3) and np.isfinite(video).all()
