"""The port's pipeline and expert parallelism (``parallel/pipeline.py``,
``models/moe.py``'s expert-parallel forward, the placed prior and its entry
point) against the JAX package, on the CPU.

One module fixture starts 4 gloo ranks (``tests/torch_pipeline_ranks.py``:
torch and the port only, one thread each) and writes their inputs (the
JAX draws of each loss replayed from their keys, weights redrawn from a
seeded normal in the JAX layout); meanwhile this process computes the JAX
side on sub-meshes of the 8 virtual CPU devices, compiled at XLA's lowest
optimisation level: ``lax.ppermute`` on a model axis of 4, JAX
``pipeline_apply`` on a (2, 4) mesh, the pipelined prior (forward, loss
gradients, ``sample_loop``) under ``active_mesh`` of that mesh, and
``MoEFF`` and a stacked MoE prior with their experts split over a model
axis of 4 (``moe_sharding_tree``). The port runs the pipeline on (1, 4)
(and (2, 2) with ``batch_axis``) and the experts at EP 4, each rank
holding only its stage or its experts.

Tolerances (f32): forward and sampling 2e-5, gradients 5e-5 (rtol and
atol), the spec trees exactly.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dalle2_video_tpu.models.moe import MoEFF as JaxMoEFF
from dalle2_video_tpu.models.moe import moe_sharding_tree as jax_moe_tree
from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
from dalle2_video_tpu.models.prior import DiffusionPriorConfig as JaxPriorCfg
from dalle2_video_tpu.models.prior import PriorNetworkConfig as JaxNetCfg
from dalle2_video_tpu.parallel.mesh import active_mesh as jax_active_mesh
from dalle2_video_tpu.parallel.mesh import create_mesh as jax_mesh
from dalle2_video_tpu.parallel.pipeline import pipeline_apply as jax_pipeline_apply
from dalle2_video_tpu.parallel.pipeline import pipeline_sharding_tree as jax_pipe_tree
from dalle2_video_tpu.parallel.pipeline import stack_transformer_params as jax_stack
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.models.moe import moe_sharding_tree
from dalle2_video_tpu_torch.models.prior import (
    DiffusionPriorNetwork,
    PriorNetworkConfig,
    prior_from_config,
    prior_specs,
)
from dalle2_video_tpu_torch.parallel.mesh import Mesh
from dalle2_video_tpu_torch.parallel.pipeline import (
    pipeline_apply,
    pipeline_sharding_tree,
    stack_transformer_params,
    stage_slices,
    unstack_transformer_params,
)
from dalle2_video_tpu_torch.parallel.sharded import local_block
from dalle2_video_tpu_torch.train import load_latest, load_params_subtree, train_prior
from dalle2_video_tpu_torch.utils.config import config_from_argv
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import params_from_jax
from test_torch_port_prior_moe import jax_tree_of

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
FWD, GRAD = 2e-5, 5e-5
D = 16
NET_PP = dict(dim=D, depth=4, heads=2, dim_head=8, scan_layers=True, pipeline_microbatches=2)
NET_EP = dict(dim=D, depth=2, heads=2, dim_head=8, scan_layers=True, ff_experts=4)
B = 8
MOE = dict(dim=8, experts=4, mult=2, cap=64.0)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _redraw(tree, seed, std):
    leaves, td = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        td, [(rng.standard_normal(np.shape(l)) * std).astype(np.float32) for l in leaves])


def _plain(tree):
    """A flax tree as plain dicts of numpy arrays (the ranks import no JAX)."""
    if hasattr(tree, "items"):
        return {k: _plain(v) for k, v in tree.items()}
    return np.asarray(tree)


def _close(got, want, tol, what):
    got = got.detach() if isinstance(got, torch.Tensor) else got
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = np.abs(got - want)
    assert np.all(err <= tol + tol * np.abs(want)), (what, float(err.max()))


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _mesh24():
    return jax_mesh(data=2, model=4)


def _jax_prior(net, **kw):
    return JaxPrior(JaxPriorCfg(network=JaxNetCfg(**net), timesteps=20, sample_timesteps=4, **kw))


def _loss_draws(jp, key, b):
    """JAX DiffusionPrior.loss's draws for ``key`` (prior.py:422-427)."""
    k_t, k_n, k_drop, _ = jax.random.split(key, 4)
    return {"times": jp.schedule.sample_random_times(k_t, b),
            "noise": jax.random.normal(k_n, (b, D)),
            "text_keep": jax.random.bernoulli(k_drop, 1.0 - jp.config.text_cond_drop_prob, (b,))}


def _prior_inputs(net, seed):
    """A JAX training state for the prior of ``net`` (weights, moments and
    EMA redrawn from ``seed``, in the JAX layout), embeddings, times and
    the loss's draws."""
    jp = _jax_prior(net)
    port = DiffusionPriorNetwork(PriorNetworkConfig(**net))
    params = jax_tree_of(port, seed=seed, std=0.3)
    rng = np.random.default_rng(seed + 1)
    ve, te = (rng.standard_normal((B, D)).astype(np.float32) for _ in range(2))
    t = rng.integers(0, 20, B).astype(np.int32)
    key = jax.random.PRNGKey(seed)
    draws = _np(_compiled(lambda k: _loss_draws(jp, k, B), key)(key))
    state = {"params": params, "opt_state": {"mu": _redraw(params, seed + 2, 1e-3),
                                             "nu": _redraw(params, seed + 3, 1e-3), "count": 1},
             "ema": {"params": _redraw(params, seed + 4, 0.3), "step": 1}, "step": 1}
    return jp, key, {"net": net, "timesteps": 20, "sample_timesteps": 4, "state": state,
                     "ve": ve, "te": te, "t": t,
                     "draws": {"times": torch.from_numpy(np.array(draws["times"])).long(),
                               "noise": torch.from_numpy(np.array(draws["noise"])),
                               "text_keep": torch.from_numpy(np.array(draws["text_keep"]))}}


def _jax_prior_side(jp, key, c, mesh, placed=None):
    """The JAX network forward and the loss's value and gradients (under
    ``active_mesh(mesh)``; the params placed by ``placed`` when given)."""
    params = jax.tree_util.tree_map(jnp.asarray, c["state"]["params"])
    if placed is not None:
        params = jax.tree_util.tree_map(jax.device_put, params, placed(params, mesh))
    args = (params, key, jnp.asarray(c["ve"]), jnp.asarray(c["t"]), jnp.asarray(c["te"]))

    def fn(p, key, ve, t, te):
        with jax_active_mesh(mesh):
            out = jp.network.apply(p, ve, t, text_embed=te)
            loss, grads = jax.value_and_grad(jp.loss)(p, key, ve, te)
        return out, loss, grads

    out, loss, grads = _compiled(fn, *args)(*args)
    return np.asarray(out), float(loss), params_from_jax(_np(grads))


def _jax_sample(jp, c, mesh):
    params = jax.tree_util.tree_map(jnp.asarray, c["state"]["params"])
    key, te = jax.random.PRNGKey(31), jnp.asarray(c["sample"]["te"])

    def fn(p, key, te):
        with jax_active_mesh(mesh):
            return jp.sample_loop(p, key, te, cond_scale=2.0)

    return np.asarray(_compiled(fn, params, key, te)(params, key, te))


def _toy_inputs():
    rng = np.random.default_rng(0)
    return {"w": (rng.standard_normal((8, 8, 8)) * 0.3).astype(np.float32),
            "b": (rng.standard_normal((8, 8)) * 0.1).astype(np.float32),
            "x": rng.standard_normal((8, 8)).astype(np.float32),
            "bias": (rng.standard_normal(8) * 0.25).astype(np.float32),
            "c": rng.standard_normal((8, 8)).astype(np.float32)}


def _jax_layer(p, x, b):
    return jnp.tanh(x @ p["w"] + p["b"] + b)


def _jax_toy(toy):
    """JAX pipeline_apply on the (2, 4) mesh: M in {1, 2, 4}, and M = 2 with
    the batch over data; output and gradients of sum(out * c)."""
    mesh = _mesh24()
    args = tuple(jnp.asarray(toy[k]) for k in ("w", "b", "x", "bias", "c"))

    def fn(w, b, x, bias, c):
        res = {}
        for key, m, batch_axis in (("m1", 1, None), ("m2", 2, None), ("m4", 4, None),
                                   ("dp", 2, "data")):
            def loss(st, x, bias):
                y = jax_pipeline_apply(_jax_layer, st, x, mesh, microbatches=m,
                                       batch_axis=batch_axis, broadcast_args=(bias,))
                return jnp.sum(y * c), y

            (_, y), (g_st, g_x, g_b) = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(
                {"w": w, "b": b}, x, bias)
            res[key] = {"out": y, "w": g_st["w"], "b": g_st["b"], "x": g_x, "bias": g_b}
        return res

    return _np(_compiled(fn, *args)(*args))


def _jax_ppermute(pp):
    mesh = jax_mesh(data=1, model=4, devices=jax.devices()[:4])
    perm = [(i, (i + 1) % 4) for i in range(4)]

    def fn(x, c):
        def loss(x):
            y = shard_map(lambda v: jax.lax.ppermute(v, "model", perm), mesh=mesh,
                          in_specs=P("model"), out_specs=P("model"))(x)
            return jnp.sum(y * c), y

        (_, y), g = jax.value_and_grad(loss, has_aux=True)(x)
        return y, g

    args = (jnp.asarray(pp["x"]), jnp.asarray(pp["c"]))
    return _np(_compiled(fn, *args)(*args))


def _jax_moe(c):
    mesh = _mesh24()
    jm = JaxMoEFF(c["dim"], num_experts=c["experts"], mult=c["mult"], capacity_factor=c["cap"])
    params = jax.tree_util.tree_map(jnp.asarray, c["params"])
    params = jax.tree_util.tree_map(jax.device_put, params, jax_moe_tree(params, mesh))
    args = (params, jnp.asarray(c["x"]), jnp.asarray(c["c"]))

    def fn(p, x, cot):
        def loss(p, x):
            y, sown = jm.apply(p, x, mutable=["losses"])
            aux = sown["losses"]["moe_aux"][0]
            return jnp.sum(y * cot) + aux, (y, aux)

        (_, (y, aux)), (gp, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(p, x)
        return y, aux, gp, gx

    y, aux, gp, gx = _compiled(fn, *args)(*args)
    return np.asarray(y), float(aux), params_from_jax(_np(gp)), np.asarray(gx)


def _entry_inputs(tmp):
    rng = np.random.default_rng(40)
    np.save(tmp / "v.npy", rng.standard_normal((16, D)).astype(np.float32))
    np.save(tmp / "t.npy", rng.standard_normal((16, D)).astype(np.float32))
    args = [f"videos.embed={tmp}/v.npy", f"texts.embed={tmp}/t.npy", "device=cpu", f"dim={D}",
            "prior.depth=4", "prior.heads=2", "prior.dim_head=8", "prior.batch_size=4",
            "train_ratio=0.5", "prior.use_ema=true", "prior.ema_update_after_step=0",
            "prior.ema_update_every=1", "prior.sample_timesteps=4", "log_level=WARNING"]
    runs = {"pp": ["prior.pipeline_microbatches=2", "prior.pipeline_stages=2"],
            "ep": ["prior.ff_experts=4"]}
    return {"dir": str(tmp / "entry"), "args": args, "runs": runs}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results (``ranks[r]``), the JAX side and the inputs."""
    tmp = tmp_path_factory.mktemp("pipeline")
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    logs = [open(tmp / f"log{r}.txt", "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_pipeline_ranks.py"),
                               str(tmp / "inputs.pt"), str(tmp)],
                              env=dict(env, RANK=str(r)), cwd=ROOT, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    pool = ThreadPoolExecutor(3)
    try:
        inputs, jax_out = _inputs_and_jax(pool, tmp)
        for p in procs:
            p.wait(timeout=180)
    finally:
        pool.shutdown()
        for p, log in zip(procs, logs):
            if p.poll() is None:
                p.kill()
                p.wait()
            log.close()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{(tmp / f'log{r}.txt').read_text()[-4000:]}"
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=False) for r in range(4)]
    return {"ranks": ranks, "jax": jax_out, "inputs": inputs, "dir": tmp}


def _inputs_and_jax(pool, tmp):
    jp_pp, key_pp, pp = _prior_inputs(NET_PP, 10)
    jp_ep, key_ep, ep = _prior_inputs(NET_EP, 20)
    rng = np.random.default_rng(30)
    pp["sample"] = {"te": rng.standard_normal((4, D)).astype(np.float32)}
    k31 = jax.random.PRNGKey(31)
    pp["sample"]["x_t"] = np.asarray(_compiled(
        lambda k: jkeys.normal(jkeys.split(k)[0], (4, D)), k31)(k31))
    jm = JaxMoEFF(MOE["dim"], num_experts=MOE["experts"], mult=MOE["mult"],
                  capacity_factor=MOE["cap"])
    x = rng.standard_normal((4, 8, MOE["dim"])).astype(np.float32)
    moe = dict(MOE, params=_plain(_redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), x),
                                          32, 0.3)),
               x=x, c=rng.standard_normal(x.shape).astype(np.float32))
    inputs = {"toy": _toy_inputs(), "prior_pp": pp, "prior_ep": ep, "moe": moe,
              "ppermute": {"x": rng.standard_normal((4, 3)).astype(np.float32),
                           "c": rng.standard_normal((4, 3)).astype(np.float32)},
              "entry": _entry_inputs(tmp)}
    torch.save(inputs, tmp / "inputs.part")
    os.replace(tmp / "inputs.part", tmp / "inputs.pt")
    mesh24 = _mesh24()
    jobs = {"toy": pool.submit(_jax_toy, inputs["toy"]),
            "prior_pp": pool.submit(_jax_prior_side, jp_pp, key_pp, pp, mesh24),
            "prior_ep": pool.submit(_jax_prior_side, jp_ep, key_ep, ep, mesh24, jax_moe_tree),
            "sample": pool.submit(_jax_sample, jp_pp, pp, mesh24),
            "moe": pool.submit(_jax_moe, moe),
            "ppermute": pool.submit(_jax_ppermute, inputs["ppermute"])}
    return inputs, {k: f.result() for k, f in jobs.items()}


# ---------------------------------------------------------------- the ring
def test_ppermute_and_its_backward_match_jax(run):
    """collectives.ppermute over the ring of 4 (shift +1) against
    lax.ppermute in shard_map: each rank receives its predecessor's block,
    and the backward (the inverse permute) gives each block the cotangent
    its successor saw."""
    y, g = run["jax"]["ppermute"]
    for r, res in enumerate(run["ranks"]):
        got_y, got_g = res["ppermute"]
        _close(got_y, y[r], FWD, "ppermute")
        _close(got_g, g[r], GRAD, "ppermute backward")


@pytest.mark.parametrize("case", ["m1", "m2", "m4", "dp"])
def test_toy_pipeline_matches_jax(run, case):
    """pipeline_apply on the JAX toy layer (8 layers, a broadcast bias
    vector) at M = 1, 2, 4 over 4 stages, and at M = 2 over 2 stages x 2
    data rows with batch_axis, against JAX pipeline_apply on the (2, 4)
    mesh: the output, and the gradients of sum(out * c) for the stack, the
    input and the bias (summed over the stages and the data rows once: 1x,
    not S x), the same on every rank."""
    want = run["jax"]["toy"][case]
    for r, res in enumerate(run["ranks"]):
        got = res["toy"][case]
        if case == "dp":  # (2, 2): rank r holds data row r // 2's rows
            rows = slice((r // 2) * 4, (r // 2 + 1) * 4)
            _close(got["out"], want["out"][rows], FWD, "out")
            _close(got["x"][rows], want["x"][rows], GRAD, "x")
        else:
            _close(got["out"], want["out"], FWD, "out")
            _close(got["x"], want["x"], GRAD, "x")
        for k in ("w", "b", "bias"):
            _close(got[k], want[k], GRAD, k)


def test_pipeline_refusals_match_jax():
    """Both sides refuse layers that do not divide over the stages and
    fewer than one microbatch; a local batch that does not divide by the
    microbatches raises here (a ValueError) where JAX's assert fails."""
    mesh = Mesh(1, 4, 0, CPU, None)
    jmesh = _mesh24()
    st6 = {"w": np.zeros((6, 4, 4), np.float32), "b": np.zeros((6, 4), np.float32)}
    st8 = {k: np.zeros((8,) + v.shape[1:], np.float32) for k, v in st6.items()}
    x = np.zeros((6, 4), np.float32)
    layer = lambda p, x: torch.tanh(x @ p["w"] + p["b"])  # noqa: E731
    jlayer = lambda p, x: jnp.tanh(x @ p["w"] + p["b"])  # noqa: E731
    with pytest.raises(ValueError, match="6 layers not divisible by 4 stages"):
        jax_pipeline_apply(jlayer, st6, x, jmesh, microbatches=2)
    with pytest.raises(ValueError, match="6 layers not divisible by 4 stages"):
        stage_slices({k: torch.from_numpy(v) for k, v in st6.items()}, mesh)
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        jax_pipeline_apply(jlayer, st8, x, jmesh, microbatches=0)
    stage = stage_slices({k: torch.from_numpy(v) for k, v in st8.items()}, mesh)
    with pytest.raises(ValueError, match="microbatches must be >= 1"):
        pipeline_apply(layer, stage, torch.from_numpy(x), mesh, microbatches=0)
    with pytest.raises(AssertionError, match="not divisible by microbatches 4"):
        jax_pipeline_apply(jlayer, st8, x, jmesh, microbatches=4)
    with pytest.raises(ValueError, match="local batch 6 not divisible by microbatches 4"):
        pipeline_apply(layer, stage, torch.from_numpy(x), mesh, microbatches=4)


def _jax_specs(tree, mesh, fn):
    """{port name: spec tuple} of a JAX spec tree (kernel / scale leaves
    named as the port names them)."""
    out = {}
    for path, s in jax.tree_util.tree_flatten_with_path(fn(tree, mesh))[0]:
        keys = [str(getattr(p, "key", p)) for p in path][1:]  # drop "params"
        if keys[-1] in ("kernel", "scale"):
            keys[-1] = "weight"
        out[".".join(keys)] = tuple(s.spec)
    return out


@pytest.mark.parametrize("net", [
    dict(NET_PP), dict(NET_PP, depth=6), dict(NET_EP), dict(NET_EP, scan_layers=False),
    dict(NET_EP, ff_experts=6)],
    ids=["pp-depth4", "pp-depth6-replicated", "ep-stacked", "ep-per-layer",
         "ep-6-experts-replicated"])
def test_spec_trees_match_jax_leaf_by_leaf(net):
    """pipeline_sharding_tree / moe_sharding_tree (a spec per parameter
    name) against the JAX trees on a model axis of 4, leaf by leaf: the
    stacked layers on dim 0 when the depth divides, the experts on dim 0
    (dim 1 under the stacked layers) when they divide, everything else
    replicated; prior_specs picks the same."""
    port = DiffusionPriorNetwork(PriorNetworkConfig(**net))
    tree = jax_tree_of(port)
    named = dict(port.named_parameters())
    mesh = Mesh(2, 4, 0, CPU, None)
    jfn, pfn = ((jax_pipe_tree, pipeline_sharding_tree) if net.get("pipeline_microbatches")
                else (jax_moe_tree, moe_sharding_tree))
    want = _jax_specs(tree, _mesh24(), jfn)
    got = pfn(named, mesh)
    assert got == want
    assert prior_specs(port, mesh) == got
    assert any(got.values()) == (net["depth"] % 4 == 0 if "pipeline_microbatches" in net
                                 else net["ff_experts"] % 4 == 0)


def test_layout_converters_match_jax_and_one_axis_at_a_time():
    """stack_transformer_params / unstack_transformer_params on the port's
    state dicts equal the JAX converters on the same weights, and round
    trip; on a mesh with a model axis, a prior with both the pipeline and
    the experts raises (both take that axis)."""
    net = dict(NET_PP, scan_layers=False, pipeline_microbatches=0)
    per = DiffusionPriorNetwork(PriorNetworkConfig(**net))
    flat = jax_tree_of(per, seed=3)
    sd = {k[len("transformer."):]: v for k, v in params_from_jax(flat).items()
          if k.startswith("transformer.")}
    stacked = stack_transformer_params(sd)
    want = params_from_jax({"params": {"transformer": _np(jax_stack(
        flat["params"]["transformer"]))}})
    assert set(stacked) == {k[len("transformer."):] for k in want}
    for k, v in stacked.items():
        assert torch.equal(v, want["transformer." + k]), k
    back = unstack_transformer_params(stacked)
    assert set(back) == set(sd) and all(torch.equal(back[k], v) for k, v in sd.items())
    both = DiffusionPriorNetwork(PriorNetworkConfig(**dict(NET_PP, ff_experts=4)))
    with pytest.raises(ValueError, match="both take"):
        prior_specs(both, Mesh(1, 2, 0, CPU, None))
    assert prior_specs(both, Mesh(1, 1, 0, CPU, None)) == {}


# ---------------------------------------------------------------- the prior
def test_pipelined_prior_forward_and_gradients_match_jax(run):
    """The prior at depth 4, M = 2, each of the 4 ranks holding one layer
    (placed, the JAX state loaded by load_prior_train_state_from_jax),
    against the JAX pipelined prior under active_mesh (the setup of
    tests/test_pipeline.py::test_pipelined_prior_network_matches_local):
    the network forward and the loss (2e-5), every gradient (5e-5; the
    replicated parameters' the same on every rank: the input's and the
    relative-position bias's cotangents summed once over the stages)."""
    out, loss, grads = run["jax"]["prior_pp"]
    for res in run["ranks"]:
        got = res["prior_pp"]
        _close(got["out"], out, FWD, "forward")
        _close(got["loss"], loss, FWD, "loss")
        assert set(got["grads"]) == set(grads)
        for k, g in got["grads"].items():
            _close(g, grads[k], GRAD, f"grad {k}")


def test_pipelined_sample_loop_matches_jax(run):
    """sample_loop at cond_scale 2 (the CFG-doubled batch of 8 through
    the 4-stage pipeline at M = 2), 4 DDIM steps, x_T replayed from the
    key, against the JAX pipelined sample_loop (tests/test_pipeline.py::
    test_pipelined_prior_sampling_matches_local's setup): 2e-5."""
    want = run["jax"]["sample"]
    for res in run["ranks"]:
        _close(res["sample"], want, FWD, "sample")


def test_expert_parallel_moeff_matches_jax(run):
    """MoEFF with 4 experts, one a rank (tests/test_moe.py::
    test_moe_ep_sharded_matches_local's setup), against the JAX module
    with its experts split over a model axis of 4: output and aux (2e-5),
    the gradients of sum(out * c) + aux for the input, the norm, the
    router (through combine's gate values, gathered whole on every rank)
    and the experts (5e-5)."""
    y, aux, grads, gx = run["jax"]["moe"]
    for r, res in enumerate(run["ranks"]):
        got = res["moe"]
        assert got["held"] == 1
        assert got["specs"]["experts_w1"] == ("model",) and got["specs"]["router.weight"] == ()
        _close(got["out"], y, FWD, "out")
        _close(got["aux"], aux, FWD, "aux")
        _close(got["x"], gx, GRAD, "x")
        for k, g in got["grads"].items():
            _close(g, grads[k], GRAD, f"grad {k}")


def test_expert_parallel_scan_moe_prior_matches_jax(run):
    """The stacked MoE prior (depth 2, 4 experts, tests/test_moe.py::
    test_prior_moe_scan_layers's setup) at EP 4, each rank holding one
    expert of each layer (dim 1 of the stacked leaves), against JAX with
    moe_sharding_tree's placement: the forward (2e-5), the loss with its
    load-balance aux (2e-5) and every gradient (5e-5)."""
    out, loss, grads = run["jax"]["prior_ep"]
    for res in run["ranks"]:
        got = res["prior_ep"]
        _close(got["out"], out, FWD, "forward")
        _close(got["loss"], loss, FWD, "loss")
        for k, g in got["grads"].items():
            _close(g, grads[k], GRAD, f"grad {k}")


def test_each_rank_holds_only_its_blocks(run):
    """After the JAX state is loaded, each rank's parameters, Adam moments
    and EMA shadow are its blocks of the JAX trees (its layer, or its
    expert of each layer), and the bytes it holds are those blocks': the
    stack's (or the experts') share of 1 / 4 plus the replicated rest."""
    for name in ("prior_pp", "prior_ep"):
        c = run["inputs"][name]
        whole = {"params": params_from_jax(c["state"]["params"]),
                 "mu": params_from_jax(c["state"]["opt_state"]["mu"]),
                 "ema": params_from_jax(c["state"]["ema"]["params"])}
        total = sum(v.numel() for v in whole["params"].values())
        split = sum(v.numel() for k, v in whole["params"].items() if run["ranks"][0][name]
                    ["specs"].get(k))
        assert 0 < split < total
        for r, res in enumerate(run["ranks"]):
            got = res[name]
            mesh = Mesh(1, 4, r, CPU, None)
            for part in ("params", "mu", "ema"):
                for k, v in whole[part].items():
                    want = local_block(v, got["specs"].get(k, ()), mesh)
                    assert torch.equal(got[part][k], want), (name, part, k)
            assert got["bytes"] == (4 * (total - split + split // 4),
                                    8 * (total - split + split // 4))


@pytest.mark.parametrize("name", ["pp", "ep"])
def test_entry_point_under_four_ranks_trains_restores_and_serves(run, tmp_path, name):
    """python -m dalle2_video_tpu_torch.train.train_prior under 4 gloo
    ranks: the pipeline at 2 stages x 2 data rows (each data row the whole
    batch), the experts at EP 4; one epoch, then resume=true at the same
    mesh for a second. Each rank holds its blocks (parameter, moment and
    EMA bytes); the replicated parameters are equal on every rank (and on
    the data rows, the stages too); rank 0's checkpoint, in the
    single-device format, holds every rank's blocks and restores in one
    process, where it serves a best-of-2 sample; and one process trains
    the same run (its pipeline on the local loop) to losses within 1e-5 and
    parameters within 3e-5 of each tensor's largest entry."""
    e = run["inputs"]["entry"]
    args = [*e["args"], *e["runs"][name]]
    ranks = [res[f"entry_{name}"] for res in run["ranks"]]
    data, model = {"pp": (2, 2), "ep": (1, 4)}[name]
    state = load_latest(f"{e['dir']}/{name}/prior_default")
    assert set(state) == {"params", "opt_state", "ema", "step", "generator"}
    cfg = config_from_argv(args)
    one = train_prior.build_prior_trainer(cfg, "cpu")
    one.load_state_dict(state)  # restores in one process
    whole = dict(one.prior.network.named_parameters())
    specs = prior_specs(one.prior.network, Mesh(1, model, 0, CPU, None))
    split = sum(p.numel() for k, p in whole.items() if specs[k])
    total = sum(p.numel() for p in whole.values())
    held = total - split + split // model
    for r, got in enumerate(ranks):
        assert got["steps"] == (2, 4) and got["mesh"] == (data, model)
        assert all(np.isfinite(x) for x in got["losses"])
        assert got["bytes"] == (4 * held, 8 * held) and got["ema_bytes"] == 4 * held
        mesh = Mesh(1, model, r % model, CPU, None)
        for k, v in got["params"].items():
            assert torch.equal(v, local_block(whole[k].detach(), specs[k], mesh)), (r, k)
    assert state["step"] == 4 and state["ema"]["step"] == 4
    prior = prior_from_config(cfg, "cpu")
    prior.network.load_state_dict(load_params_subtree(f"{e['dir']}/{name}/prior_default"))
    te = torch.from_numpy(np.random.default_rng(3).standard_normal((2, D)).astype(np.float32))
    sample = prior.sample(RowKeys([1, 2]), te, num_samples_per_batch=2)
    assert sample.shape == (2, D) and bool(torch.isfinite(sample).all())
    # one process: the stages default to the one rank (pipeline_stages=2
    # would ask for a mesh of 2)
    alone = [a for a in args if not a.startswith("prior.pipeline_stages")]
    alone.append(f"run_dir={tmp_path}")
    s1 = train_prior.main(alone + ["prior.epochs=1"])
    s2 = train_prior.main(alone + ["prior.epochs=2", "resume=true"])
    np.testing.assert_allclose([s1["train_loss"], s2["train_loss"], s2["val_loss"]],
                               ranks[0]["losses"], rtol=1e-5)
    for k, p in s2["trainer"].prior.network.named_parameters():
        w = whole[k].detach()
        assert float((p.detach() - w).abs().max()) <= 3e-5 * float(w.abs().max()) + 1e-8, k
