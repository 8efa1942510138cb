"""The prior's remaining options against the JAX package: ``MoEFF``
(models/moe.py: top-2 routing, capacity drops, router ties, the Switch
aux), the initialisers of the experts (flax ``lecun_normal`` on 3-D
weights), the prior network, loss (the self-conditioning coin both ways,
the MoE aux) and gradients with ``ff_experts``, ``self_cond``,
``swiglu_ff=False`` and ``scan_layers``, the self-conditioned
``sample_loop`` under CFG, the bridge's stacked layout, ``prior_from_config``
and the refusals of the pipeline.

A tiny prior (dim 16, depth 2, 2 heads of 8, 100 timesteps), f32, its JAX
parameters drawn from a seeded normal in the JAX layout (``jax_tree_of``)
and carried across with ``weights.load_from_jax``; every draw of the JAX loss (times, noise, text
keep, the self-cond coin) recomputed from its key and injected; the JAX
programs compiled at XLA's lowest optimisation level.

Tolerances: MoEFF 1e-5 (its output) and 1e-6 (aux); the prior network
2e-5, losses 1e-5 relative, gradients 1e-4 of each tensor's largest entry
(the prior-train file's); the sampled embeds 5e-4 (the slice file's).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn as nn

from dalle2_video_tpu.models.moe import MoEFF as JaxMoEFF
from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
from dalle2_video_tpu.models.prior import DiffusionPriorConfig as JaxPriorCfg
from dalle2_video_tpu.models.prior import PriorNetworkConfig as JaxNetCfg
from dalle2_video_tpu.models.prior import prior_from_config as jax_prior_from_config
from dalle2_video_tpu.parallel.pipeline import stack_transformer_params
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.models.moe import MoEFF, capacity
from dalle2_video_tpu_torch.models.prior import (
    DiffusionPrior,
    DiffusionPriorConfig,
    DiffusionPriorNetwork,
    PriorNetworkConfig,
    prior_from_config,
)
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import STACKED, load_from_jax, params_from_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")
D = 16
NET = dict(dim=D, depth=2, heads=2, dim_head=8)
T = 100
B = 6

_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def redraw(tree, seed, std):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        td, [(rng.standard_normal(l.shape) * std).astype(np.float32) for l in leaves])


def jax_tree_of(module: nn.Module, seed=None, std=0.3):
    """The flax parameter tree {"params": ...} of a port module, the inverse
    of weights.params_from_jax (Dense and conv weights back to kernels,
    norm weights to scales, the stacked layout slice by slice), its leaves
    drawn from a seeded normal of ``std`` (or the module's own with no
    seed). It stands in for jax.eval_shape of the JAX init, which traces
    the whole module; load_from_jax holds the names and shapes strictly,
    and the JAX programs refuse a tree that is not their module's."""
    tree = {}
    rng = None if seed is None else np.random.default_rng(seed)
    for mname, m in module.named_modules():
        for pname, p in m.named_parameters(recurse=False):
            a = p.detach().cpu().numpy()
            if rng is not None:
                a = (rng.standard_normal(a.shape) * std).astype(np.float32)
            path = mname.split(".") if mname else []
            lead = int(STACKED in path)
            leaf = pname
            if pname == "weight" and isinstance(m, nn.Linear):
                leaf, a = "kernel", np.swapaxes(a, -1, -2)
            elif pname == "weight" and isinstance(m, nn.Conv2d):
                leaf, a = "kernel", np.moveaxis(a, (lead, lead + 1), (-1, -2))
            elif pname == "weight" and isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
                leaf = "scale"
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = np.ascontiguousarray(a)
    return {"params": tree}


def t_(a):
    return torch.from_numpy(np.array(a))


def _close(got, want, rtol, atol, what):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert got.shape == want.shape and np.all(err <= atol + rtol * np.abs(want)), (
        what, float(err.max()))


# ------------------------------------------------------------------ MoEFF
MOE_CASES = {
    "swiglu": dict(capacity_factor=2.0, swiglu=True),
    "gelu": dict(capacity_factor=2.0, swiglu=False),
    "drops-at-cf-0.5": dict(capacity_factor=0.5, swiglu=True),
    "router-ties": dict(capacity_factor=1.0, swiglu=True),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_ff_matches_jax(case):
    """MoEFF (4 experts, 2 x 7 tokens) against the JAX module on the same
    weights: the output (1e-5) and the sown aux (1e-6). At capacity factor
    0.5 (4 slots an expert) assignments are dropped and their tokens ride
    the residual; with a zero router every probability ties and both
    packages take experts 0 and 1, in that order, for every token."""
    kw = MOE_CASES[case]
    jm = JaxMoEFF(D, num_experts=4, **kw)
    x = np.random.default_rng(1).standard_normal((2, 7, D)).astype(np.float32)
    params = redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x)), 3, 0.3)
    if case == "router-ties":
        params["params"]["router"]["kernel"] = np.zeros_like(params["params"]["router"]["kernel"])
    run = lambda p, x: jm.apply(p, x, mutable=["losses"])  # noqa: E731
    want, sown = _compiled(run, params, x)(params, x)
    m = MoEFF(D, 4, **kw)
    load_from_jax(m, params)
    got, aux = m(t_(x))
    _close(got, want, 0.0, 1e-5, "output")
    _close(aux, sown["losses"]["moe_aux"][0], 0.0, 1e-6, "aux")
    dispatch, _, _, gate_idx = m.route(m.norm(t_(x)).reshape(14, D))
    if case == "drops-at-cf-0.5":
        assert capacity(14, 4, 0.5) == 2 and int(dispatch.sum()) <= 4 * 2
        assert np.abs(np.asarray(want) - x).max(axis=-1).min() == 0.0  # a token dropped twice
    elif case == "router-ties":
        assert gate_idx.tolist() == [[0, 1]] * 14


def test_initialisers_follow_flax():
    """flax lecun_normal on the (e, d, h) expert weights counts the expert
    axis in its fan-in: std 1 / sqrt(d e) (not 1 / sqrt(d)), a normal
    truncated at two stds; the port's draws have the JAX package's stds
    (within 3%) and bound, and so do the router (U(+-1/sqrt(d))) and the
    GELU feed-forward's kernels."""
    d, e = 64, 8
    jm = JaxMoEFF(d, num_experts=e, swiglu=False)
    jp = _np(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 4, d))))["params"]
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(0)
        m = MoEFF(d, e, swiglu=False)
    for name, fan_in in (("experts_w1", d * e), ("experts_w2", 4 * d * e)):
        std = 1.0 / math.sqrt(fan_in)
        for w in (jp[name], getattr(m, name).detach().numpy()):
            assert abs(w.std() / std - 1) < 0.03, (name, w.std(), std)
            assert np.abs(w).max() <= 2 * std / 0.87962566 + 1e-7
    for w in (jp["router"]["kernel"], m.router.weight.detach().numpy()):  # 512 draws
        assert abs(w.std() * math.sqrt(3 * d) - 1) < 0.1
        assert np.abs(w).max() <= 1 / math.sqrt(d)
    net = DiffusionPriorNetwork(PriorNetworkConfig(**NET, swiglu_ff=False))
    assert net.transformer.ff0.Dense_0.weight.shape == (4 * D, D)
    w = net.transformer.ff0.Dense_1.weight.detach()
    assert float(w.abs().max()) <= 1 / math.sqrt(4 * D)


# --------------------------------------------------------------- the prior
PRIOR_CASES = {
    # (network knobs, loss knobs, what the program holds)
    "moe-gelu-scan-selfcond": (dict(ff_experts=4, swiglu_ff=False, scan_layers=True,
                                    self_cond=True), {}, "grads"),
    "moe-swiglu-aux-eps": (dict(ff_experts=4, moe_capacity_factor=1.0, moe_aux_weight=0.5),
                           dict(predict_x_start=False), "grads"),
    "dense-gelu-selfcond": (dict(swiglu_ff=False, self_cond=True), {}, "loss"),
}


@functools.lru_cache(maxsize=None)
def _priors(case):
    net, loss, _ = PRIOR_CASES[case]
    jp = JaxPrior(JaxPriorCfg(network=JaxNetCfg(**NET, **net), timesteps=T, **loss))
    tp = DiffusionPrior(DiffusionPriorConfig(network=PriorNetworkConfig(**NET, **net),
                                             timesteps=T, **loss), device=CPU)
    params = jax_tree_of(tp.network, seed=1)
    load_from_jax(tp.network, params)
    return jp, tp, params


def _loss_draws(jp, key, b):
    """JAX DiffusionPrior.loss's draws for ``key`` (prior.py:422-435)."""
    k_t, k_n, k_drop, k_sc = jax.random.split(key, 4)
    return {"times": jp.schedule.sample_random_times(k_t, b),
            "noise": jax.random.normal(k_n, (b, D)),
            "text_keep": jax.random.bernoulli(k_drop, 1.0 - jp.config.text_cond_drop_prob, (b,)),
            "self_cond": jax.random.bernoulli(k_sc, 0.5)}


def _port_draws(d):
    return {"times": t_(d["times"]).long(), "noise": t_(d["noise"]),
            "text_keep": t_(d["text_keep"]), "self_cond": t_(d["self_cond"])}


@pytest.mark.parametrize("case", list(PRIOR_CASES))
def test_prior_network_loss_and_gradients_match_jax(case):
    """The network (with a self-cond input where it takes one; 2e-5), the
    loss (1e-5 relative) at a key whose self-cond coin is heads (the no-grad
    estimate runs), and for the dense GELU case also at one whose coin is
    tails, and the gradients of the first key's loss (1e-4 of each tensor's
    largest entry) where the case holds them. The experts add moe_aux_weight times the layers' mean
    load-balance aux (0.5 in the second case: the aux moves the loss)."""
    jp, tp, params = _priors(case)
    grads_too = PRIOR_CASES[case][2] == "grads"
    self_cond = jp.config.network.self_cond
    rng = np.random.default_rng(2)
    ve, te, sc = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(3))
    t = np.array([0, 3, 17, 50, 88, 99], np.int32)
    # coin heads, then tails (bernoulli(split(key, 4)[3], 0.5))
    keys = jnp.stack([jax.random.PRNGKey(5), jax.random.PRNGKey(10)])
    two = self_cond and not grads_too

    def fn(p, keys, ve, te, sc, t):
        out = jp.network.apply(p, ve, t, text_embed=te, self_cond=sc if self_cond else None)
        if grads_too:
            loss, grads = jax.value_and_grad(jp.loss)(p, keys[0], ve, te)
        else:
            loss, grads = jp.loss(p, keys[0], ve, te), None
        return (out, loss, grads, jp.loss(p, keys[1], ve, te) if two else None,
                [_loss_draws(jp, k, B) for k in keys])

    args = (params, keys, ve, te, sc, t)
    out, loss, grads, loss2, draws = _compiled(fn, *args)(*args)
    got = tp.network(t_(ve), t_(t).long(), text_embed=t_(te),
                     self_cond=t_(sc) if self_cond else None)
    _close(got, out, 0.0, 2e-5, "network")
    assert [bool(d["self_cond"]) for d in draws] == [True, False]
    net = tp.network.train()
    net.zero_grad(set_to_none=True)
    port = tp.loss(t_(ve), t_(te), draws=_port_draws(draws[0]))
    _close(port, loss, 1e-5, 0.0, "loss")
    if two:
        _close(tp.loss(t_(ve), t_(te), draws=_port_draws(draws[1])), loss2, 1e-5, 0.0,
               "loss, tails")
    if grads_too:
        port.backward()
        want = params_from_jax(_np(grads))
        for k, p in net.named_parameters():
            g = torch.zeros_like(p) if p.grad is None else p.grad
            _close(g, want[k], 0.0, 1e-4 * float(want[k].abs().max()) + 1e-8, f"grad {k}")
    if case.startswith("moe-swiglu"):
        _, aux = tp.network(tp.schedule.q_sample(t_(ve) * tp.embed_scale, t_(t).long(),
                                                 t_(draws[0]["noise"])),
                            t_(t).long(), text_embed=t_(te), return_aux=True)
        assert 0.5 * float(aux.detach()) > 0.2  # the aux term is a visible part of the loss


def test_self_conditioned_sample_loop_matches_jax():
    """sample_loop at cond_scale 2 (the 2x-batched CFG forward, the
    previous step's x0 doubled with it) on the experts + GELU + stacked +
    self-conditioned prior, 4 DDIM steps, x_T replayed from the key:
    5e-4; without the carry (zeros every step) the embeds move."""
    jp, tp, params = _priors("moe-gelu-scan-selfcond")
    te = np.random.default_rng(4).standard_normal((3, D)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    cfg4 = dataclasses.replace(jp.config, sample_timesteps=4)
    jp4 = JaxPrior(cfg4)

    def fn(p, key, te):
        return (jp4.sample_loop(p, key, te, cond_scale=2.0),
                jkeys.normal(jkeys.split(key)[0], te.shape))

    want, x_t = _compiled(fn, params, key, te)(params, key, te)
    orig_cfg = tp.config
    tp.config = dataclasses.replace(orig_cfg, sample_timesteps=4)
    got = tp.sample_loop(RowKeys([0, 1, 2]), t_(te), cond_scale=2.0, init_noise=t_(x_t))
    _close(got, want, 0.0, 5e-4, "embeds")
    orig = tp._pred_x0
    tp._pred_x0 = lambda x, t, s, e, enc=None, sc=None: orig(x, t, s, e, enc, torch.zeros_like(x))
    try:
        no_carry = tp.sample_loop(RowKeys([0, 1, 2]), t_(te), cond_scale=2.0,
                                  init_noise=t_(x_t))
    finally:
        del tp._pred_x0
        tp.config = orig_cfg
    assert float((no_carry - got).abs().max()) > 1e-3


def test_bridge_carries_the_stacked_layout():
    """A JAX per-layer tree and its stacked form (the JAX package's own
    stack_transformer_params) load into the per-layer and the stacked port
    networks: each layer's slice equals its per-layer parameter, and the two
    networks give the same output; the bridge refuses a stacked tree for a
    per-layer network."""
    net = dict(NET, ff_experts=4)
    per = DiffusionPriorNetwork(PriorNetworkConfig(**net))
    scan = DiffusionPriorNetwork(PriorNetworkConfig(**net, scan_layers=True))
    flat = jax_tree_of(per, seed=5)
    stacked = {"params": dict(flat["params"], transformer=_np(stack_transformer_params(
        flat["params"]["transformer"])))}
    load_from_jax(per, flat)
    load_from_jax(scan, stacked)
    sd = scan.state_dict()
    assert sd["transformer.layers.ff.experts_w1"].shape == (2, 4, D, 8 * D)
    for k, v in per.state_dict().items():
        if k.startswith("transformer.attn") or k.startswith("transformer.ff"):
            head, rest = k.split(".", 2)[1], k.split(".", 2)[2]
            i, kind = int(head[-1]), head[:-1]
            assert torch.equal(sd[f"transformer.layers.{kind}.{rest}"][i], v)
    x = torch.randn(3, D, generator=torch.Generator().manual_seed(0))
    t = torch.tensor([1, 40, 99])
    torch.testing.assert_close(scan(x, t, text_embed=x), per(x, t, text_embed=x),
                               rtol=0, atol=1e-6)
    with pytest.raises(ValueError, match="does not match"):
        load_from_jax(DiffusionPriorNetwork(PriorNetworkConfig(**net)), stacked)


def test_prior_from_config_reads_the_jax_keys_and_refuses_the_pipeline():
    """prior_from_config reads the keys JAX prior_from_config reads (the
    stacked layout, the experts, their capacity and aux weight;
    pipeline_microbatches implies the stacked layout) into the same network
    config; the pipeline itself (a mesh) raises."""
    cfg = {"dim": D, "prior": dict(depth=2, heads=2, dim_head=8, timesteps=T,
                                   sample_timesteps=4, ff_experts=4, scan_layers=True,
                                   moe_capacity_factor=1.5, moe_aux_weight=0.1)}
    want = dataclasses.asdict(jax_prior_from_config(cfg).config)
    assert dataclasses.asdict(prior_from_config(cfg, CPU).config) == want
    pipe = dict(cfg, prior=dict(cfg["prior"], scan_layers=False, pipeline_microbatches=2))
    assert jax_prior_from_config(pipe).config.network.scan_layers
    with pytest.raises(NotImplementedError, match="pipeline"):
        prior_from_config(pipe, CPU)
