"""The port's data and model axes (``dalle2_video_tpu_torch/parallel/``)
against the JAX package's ``parallel/`` code, on the CPU.

One module fixture starts 4 gloo ranks (``tests/torch_parallel_ranks.py``:
torch and the port only, one thread each), writes their inputs
(JAX-initialised weights, redrawn from a seeded normal; the JAX draws of
each step) and, while they run, computes the JAX side on sub-meshes of the
8 virtual CPU devices (compiled at XLA's lowest optimisation level): the
sharded decoder step on a (4, 1) mesh, sequence-parallel MQA on a model
axis of 4, the global-batch CLIP loss and the sharded CLIP step. The tests
then hold what each rank saw: the DP + ZeRO-1 step (and its scan, the
non-finite skip, the moment shards), 4 ranks against one process, TP
against DP, SP attention and a unet with ``attention_impl: sp``, the CLIP
loss's gradients (1x, not 4x), the DP distill step, the loaders' shards,
a ZeRO-1 checkpoint restored at 1 and 2 ranks, data-parallel serving, and
the decoder's entry point under 4 ranks. Everything is f32.
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
import optax
import pytest
import torch

from dalle2_video_tpu.data.datasets import BatchLoader as JaxBatchLoader
from dalle2_video_tpu.engine.decoder import VideoDecoder as JaxDecoder
from dalle2_video_tpu.engine.decoder import VideoDecoderConfig as JaxDecoderConfig
from dalle2_video_tpu.models.clip_text import CLIPTextConfig as JaxTextCfg
from dalle2_video_tpu.models.clip_text import CLIPTextEncoder as JaxText
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.models.vivit import ViViT as JaxViViT
from dalle2_video_tpu.models.vivit import ViViTConfig as JaxViViTCfg
from dalle2_video_tpu.parallel.mesh import create_mesh as jax_mesh
from dalle2_video_tpu.parallel.mesh import shard_batch as jax_shard_batch
from dalle2_video_tpu.parallel.sharded import make_sharded_train_step as jax_sharded_step
from dalle2_video_tpu.parallel.sharded import shard_state as jax_shard_state
from dalle2_video_tpu.parallel.sp_attention import sequence_parallel_mqa as jax_sp_mqa
from dalle2_video_tpu.train import DecoderTrainer as JaxTrainer
from dalle2_video_tpu.train import DecoderTrainerConfig as JaxTrainerConfig
from dalle2_video_tpu.train import EMAConfig as JaxEMAConfig
from dalle2_video_tpu.train.clip_trainer import ClipTrainer as JaxClipTrainer
from dalle2_video_tpu.train.clip_trainer import ClipTrainerConfig as JaxClipCfg
from dalle2_video_tpu.train.clip_trainer import ClipTrainState
from dalle2_video_tpu.utils import contrastive as jax_contrastive
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.models.unet3d import UNet3DConfig
from dalle2_video_tpu_torch.ops import flash_mqa as port_flash
from dalle2_video_tpu_torch.parallel.mesh import (
    Mesh,
    active_mesh,
    create_mesh,
    global_batch,
    resolve_mesh_shape,
    shard_batch,
)
from dalle2_video_tpu_torch.parallel.sharded import (
    data_parallel_buckets,
    state_shardings,
    zero1_sharding_tree,
)
from dalle2_video_tpu_torch.train import load_latest
from dalle2_video_tpu_torch.train.ema import EMAConfig
from dalle2_video_tpu_torch.utils.contrastive import clip_loss
from dalle2_video_tpu_torch.utils.keys import batch_draw
from dalle2_video_tpu_torch.weights import params_from_jax

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}
D = 16  # video embed dim
B = 4  # the global batch: one row per rank of the (4, 1) mesh
# the smallest unet the JAX sharded step compiles in ~20 s at O0 (one
# level, no middle attention, a plain init conv); 2 frames at 8 px
UNET = dict(dim=8, dim_mults=(1,), num_resnet_blocks=1, attn_heads=1, attn_dim_head=8,
            video_embed_dim=D, attend_at_middle=False, init_cross_embed=False)
S = 8  # frame size
DEC = dict(frame_sizes=(S,), frame_numbers=(2,), timesteps=10, learned_variance=False)
EMA = dict(beta=0.99, update_after_step=-5, update_every=1)  # blends at step 1
LR = 1e-3
ADAM_EPS = 1e-3  # as tests/test_torch_port_train.py: Adam's step smooth in g
VIVIT = dict(frame_size=16, patch_size=8, num_frames=25, dim=24, depth=1, heads=2, dim_head=8)
TEXT = dict(vocab_size=1000, width=32, heads=2, layers=1, embed_dim=24)


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _redrawn(init_shapes, seed, scale=0.15):
    leaves, tree = jax.tree_util.tree_flatten(init_shapes)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(rng.standard_normal(l.shape) * scale, l.dtype) for l in leaves])


def _jax_draws(jdec, keys, shape):
    """Every draw unet 1's JAX decoder.loss makes from each key (its key
    splits: decoder.py:533-534, :600-613), as the port's ``draws``."""
    def draws(rng):
        k_t, _, _, k_loss = jax.random.split(rng, 4)
        k_noise, k_vmask, _, _ = jax.random.split(k_loss, 4)
        return {"times": jax.random.randint(k_t, (shape[0],), 0, jdec.config.timesteps,
                                            dtype=jnp.int32),
                "noise": jax.random.normal(k_noise, shape, jnp.float32),
                "video_keep": jax.random.bernoulli(
                    k_vmask, 1.0 - jdec.config.video_cond_drop_prob, (shape[0],))}

    fn = _compiled(draws, keys[0])
    return [{k: torch.from_numpy(np.array(v)) for k, v in fn(key).items()} for key in keys]


def _export(jstate):
    opt = []
    for st in jstate.opt_states:
        adam = [s for s in st if isinstance(s, optax.ScaleByAdamState)][0]
        opt.append({"mu": _np_tree(adam.mu), "nu": _np_tree(adam.nu), "count": int(adam.count)})
    return {"params": _np_tree(jstate.params), "opt_states": opt,
            "ema": [None if e is None else {"params": _np_tree(e.params), "step": int(e.step)}
                    for e in jstate.ema],
            "steps": [int(s) for s in np.asarray(jstate.steps)]}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _decoder_inputs():
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET),), **DEC))
    params = _redrawn(jax.eval_shape(jdec.init_params, jax.random.PRNGKey(0)), 1)
    jtrainer = JaxTrainer(jdec, JaxTrainerConfig(lr=LR, eps=ADAM_EPS, ema=JaxEMAConfig(**EMA)))
    jstate = jtrainer.init_state(jax.random.PRNGKey(0), params=params)
    rng = np.random.default_rng(2)
    video = rng.random((2, B, 2, S, S, 3)).astype(np.float32)
    embed = rng.standard_normal((2, B, D)).astype(np.float32)
    keys = [jax.random.PRNGKey(10 + j) for j in range(2)]
    return jdec, params, jtrainer, jstate, video, embed, keys


def _sp_unet_inputs():
    """attention_impl sp at 8 frames x 16 px: a 512-token joint bottleneck
    over the (2, 2) mesh's model axis; weights redrawn from a seed."""
    unet = dict(dim=16, dim_mults=(1, 2), video_embed_dim=32, num_resnet_blocks=1,
                attn_heads=2, attn_dim_head=8)
    dec = dict(frame_sizes=(16,), frame_numbers=(8,), timesteps=20, learned_variance=False)
    model = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**unet),), **dec), device=CPU)
    g = torch.Generator().manual_seed(3)
    params = {k: torch.randn(p.shape, generator=g) * 0.1
              for k, p in model.unets[0].state_dict().items()}
    rng = np.random.default_rng(4)
    return {"unet": unet, "dec": dec, "params": params,
            "video": rng.random((B, 8, 16, 16, 3)).astype(np.float32),
            "embed": rng.standard_normal((B, 32)).astype(np.float32),
            "draws": {"times": torch.from_numpy(rng.integers(0, 20, B)),
                      "noise": torch.from_numpy(rng.standard_normal(
                          (B, 8, 16, 16, 3)).astype(np.float32)),
                      "video_keep": torch.tensor([True, False, True, True])}}


def _clip_inputs():
    jv = JaxViViT(JaxViViTCfg(**VIVIT))
    rng = np.random.default_rng(5)
    videos = rng.standard_normal((B, 25, 16, 16, 3)).astype(np.float32)
    tokens = rng.integers(1, TEXT["vocab_size"], (B, 77)).astype(np.int32)
    vp = _redrawn(jax.eval_shape(jv.init, jax.random.PRNGKey(0), videos), 6, 0.1)
    jt = JaxText(JaxTextCfg(**TEXT))
    tp = _redrawn(jax.eval_shape(jt.init, jax.random.PRNGKey(1), tokens), 7, 0.05)
    cfg = dict(lr=1e-3, init_temperature=4.0, lr_scheduler="constant")
    jtr = JaxClipTrainer(JaxViViTCfg(**VIVIT), JaxTextCfg(**TEXT), JaxClipCfg(**cfg))
    temp = jnp.asarray(4.0, jnp.float32)
    trainable = {"vivit": vp, "temp": temp}
    # a carried state (count 1, moments drawn): Adam's first update from
    # zero moments is +-lr wherever a gradient is near f32 noise
    mu = _redrawn(trainable, 12, 1e-3)
    nu = jax.tree_util.tree_map(lambda a: a * a + 1e-8, _redrawn(trainable, 13, 1e-3))
    opt = jtr.optimizer.init(trainable)
    opt = (opt[0]._replace(count=jnp.ones((), jnp.int32), mu=mu, nu=nu),) + tuple(opt[1:])
    state = ClipTrainState(vivit_params=vp, temperature=temp, opt_state=opt,
                           step=jnp.ones((), jnp.int32))
    x = rng.standard_normal((B, 24)).astype(np.float32)
    y = rng.standard_normal((B, 24)).astype(np.float32)
    port = {"x": x, "y": y, "temp": 3.0, "vivit": VIVIT, "text": TEXT, "cfg": cfg,
            "text_params": _np_tree(tp), "videos": videos, "tokens": tokens,
            "state": {"vivit_params": _np_tree(vp), "temperature": np.float32(4.0),
                      "opt_state": {"mu": _np_tree(mu), "nu": _np_tree(nu), "count": 1},
                      "step": 1}}
    return jtr, state, tp, port


def _mesh41():
    return jax_mesh(data=4, model=1, devices=jax.devices()[:4])


def _jax_dp_step(dec_in):
    """JAX make_sharded_train_step on a (4, 1) mesh: the file's longest
    compile, started first."""
    jdec, params, jtrainer, jstate, video, embed, keys = dec_in
    mesh41 = _mesh41()
    st = jax_shard_state(jstate, mesh41)
    vid, emb = jax_shard_batch(mesh41, (jnp.asarray(video[0]), jnp.asarray(embed[0])))
    step = jax_sharded_step(jtrainer, mesh41, 1, donate_state=False)
    new, loss = step.lower(st, keys[0], vid, emb).compile(compiler_options=_O0)(
        st, keys[0], vid, emb)
    return float(loss), _export(new)


def _jax_jobs(pool, clip_in, sp):
    """The other JAX references as futures of ``pool`` (XLA compiles
    outside the interpreter lock, so they overlap with the inputs'
    making)."""
    mesh41 = _mesh41()
    mesh14 = jax_mesh(data=1, model=4, devices=jax.devices()[:4])
    jtr, cstate, tp, port = clip_in

    def sp_mqa():
        args = [jnp.asarray(sp[k]) for k in ("q", "k", "v", "nk", "nv")]

        def sp_loss(q, k, v, nk, nv):
            o = jax_sp_mqa(q, k, v, mesh14, sm_scale=sp["scale"], null_kv=(nk, nv))
            return jnp.sum(o ** 2), o

        (_, o), grads = _compiled(jax.value_and_grad(sp_loss, argnums=(0, 1, 2, 3, 4),
                                                     has_aux=True), *args)(*args)
        return np.asarray(o), [np.asarray(g) for g in grads]

    def clip_loss_():
        cargs = [jnp.asarray(port["x"]), jnp.asarray(port["y"]), jnp.float32(port["temp"])]
        closs, cgrads = _compiled(jax.value_and_grad(
            lambda x, y, t: jax_contrastive.sharded_clip_loss(x, y, t, mesh41),
            argnums=(0, 1, 2)), *cargs)(*cargs)
        return float(closs), [np.asarray(g) for g in cgrads]

    def clip_step():
        vids, toks = jax_shard_batch(mesh41, (jnp.asarray(port["videos"]),
                                              jnp.asarray(port["tokens"])))
        cnew, metrics = jtr.make_sharded_train_step(mesh41)(cstate, tp, vids, toks)
        return ({k: float(v) for k, v in metrics.items()},
                params_from_jax(_np_tree(cnew.vivit_params)), float(cnew.temperature))

    jobs = {"sp": sp_mqa, "clip_loss": clip_loss_, "clip_step": clip_step}
    return {k: pool.submit(fn) for k, fn in jobs.items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The ranks' results (``ranks[r]``), the JAX side and the inputs. The
    ranks start first (they import and join their group while the inputs
    are made, then wait for the file), and the JAX sharded step's compile
    starts as soon as its state exists."""
    tmp = tmp_path_factory.mktemp("parallel")
    env = dict(os.environ, WORLD_SIZE="4", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               OMP_NUM_THREADS="1")
    env.pop("LOCAL_RANK", None)
    second_port = str(_free_port())
    logs = [open(tmp / f"log{r}.txt", "w") for r in range(4)]
    procs = [subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_parallel_ranks.py"),
                               str(tmp / "inputs.pt"), str(tmp), second_port],
                              env=dict(env, RANK=str(r)), cwd=ROOT, stdout=log,
                              stderr=subprocess.STDOUT) for r, log in enumerate(logs)]
    pool = ThreadPoolExecutor(4)
    try:
        inputs, jax_out = _inputs_and_jax(pool, tmp)
        for p in procs:
            p.wait(timeout=120)
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
    """Writes the ranks' inputs to ``tmp``: ``inputs.pt`` as soon as the
    decoder's exist, then ``clip.pt`` (the ranks reach CLIP last); returns
    them with the JAX side's results."""
    dec_in = _decoder_inputs()
    jdec, params, jtrainer, jstate, video, embed, keys = dec_in
    dp = pool.submit(_jax_dp_step, dec_in)
    rng = np.random.default_rng(8)
    sp = {"q": rng.standard_normal((2, 64, 4, 16)).astype(np.float32),
          "k": rng.standard_normal((2, 64, 16)).astype(np.float32),
          "v": rng.standard_normal((2, 64, 16)).astype(np.float32),
          "nk": rng.standard_normal((2, 1, 16)).astype(np.float32),
          "nv": rng.standard_normal((2, 1, 16)).astype(np.float32),
          "x_odd": rng.standard_normal((2, 7, 16)).astype(np.float32), "scale": 16**-0.5}
    draws = _jax_draws(jdec, keys, (B, 2, S, S, 3))
    student = params_from_jax(_np_tree(_redrawn(params, 9, 0.15)["unet_0"]))
    # the state the ranks start from, as JAX placed it on a (2, 2) mesh with
    # ZeRO-1 and tensor-parallel columns (np.asarray gathers each leaf)
    placed = jax_shard_state(jstate, jax_mesh(data=2, model=2, devices=jax.devices()[4:]),
                             zero1=True, tp=True, tp_min_width=8)
    inputs = {
        "unet": UNET, "dec": DEC, "export": _export(placed), "video": video, "embed": embed,
        "draws": draws, "sp": sp, "sp_unet": _sp_unet_inputs(),
        "trainer": dict(lr=LR, eps=ADAM_EPS, ema=EMAConfig(**EMA)),
        "distill": {"teacher": _np_tree(params["unet_0"]), "student": student,
                    "video": video[0], "embed": embed[0],
                    "draws": {"segments": torch.tensor([0, 3, 1, 2]),
                              "noise": torch.from_numpy(
                                  rng.standard_normal((B, 2, S, S, 3)).astype(np.float32))}},
    }
    _save(inputs, tmp / "inputs.pt")
    clip_in = _clip_inputs()
    jobs = dict(_jax_jobs(pool, clip_in, sp), dp=dp)
    inputs["clip"] = clip_in[3]
    _save(inputs["clip"], tmp / "clip.pt")
    return inputs, {k: f.result() for k, f in jobs.items()}


def _save(obj, path):
    """torch.save by an atomic rename: a waiting rank never reads a part."""
    torch.save(obj, path.with_suffix(".part"))
    os.replace(path.with_suffix(".part"), path)


def _rel(a, b):
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def _moments(opt_sd, names):
    """{name: (exp_avg, exp_avg_sq)} of a single-device-format AdamW state
    over one unet, its parameters in ``names`` order."""
    return {n: (st["exp_avg"], st["exp_avg_sq"]) for n, st in
            zip(names, (opt_sd["state"][i] for i in range(len(names))))}


def _opt_order():
    """The port unet's parameter names in its optimiser's order (the
    trainer's groups: >= 2-dim leaves first, each in module order)."""
    unet = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),), **DEC),
                        device=CPU).unets[0]
    named = list(unet.named_parameters())
    return [k for k, p in named if p.ndim >= 2] + [k for k, p in named if p.ndim < 2]


# ---------------------------------------------------------------- data axis
def test_dp_zero1_step_matches_the_jax_sharded_step(run):
    """One step over the (4, 1) mesh against JAX make_sharded_train_step on
    a (4, 1) mesh with ZeRO-1 (shard_state), the JAX draws: loss rtol 1e-5;
    params and EMA within 2e-3 lr; mu 1e-3 and nu 2e-3 of each tensor's
    largest value (test_train_step_matches_jax's holds; with a floor of
    1e-6 of the unet's largest moment for the leaves whose gradient is zero
    by construction). The 4 ranks' parameters are bit for bit equal, and each rank's moments are at most a
    quarter of the whole plus the leaves ZeRO-1 leaves replicated."""
    loss, new = run["jax"]["dp"]
    ranks = run["ranks"]
    np.testing.assert_allclose(ranks[0]["dp_loss"][0], loss, rtol=1e-5)
    got = ranks[0]["dp_step1"]
    want = params_from_jax(new["params"]["unet_0"])
    for k, w in want.items():
        assert float((got["params"][k] - w).abs().max()) / LR <= 2e-3, k
        assert float((got["ema"][k] - params_from_jax(new["ema"][0]["params"])[k]).abs().max()
                     ) / LR <= 2e-3, k
    names = _opt_order()
    mom = _moments(got["opt"], names)
    for j, (tree, rtol) in enumerate(((new["opt_states"][0]["mu"], 1e-3),
                                      (new["opt_states"][0]["nu"], 2e-3))):
        tree = params_from_jax(tree)
        # a conv bias ahead of a GroupNorm has a zero gradient by
        # construction: its moments are f32 rounding (~1e-10 of the largest
        # mu), which four shards sum in another order on each side; the
        # floor is 1e-6 of the unet's largest moment
        floor = 1e-6 * max(float(w.abs().max()) for w in tree.values())
        for k, w in tree.items():
            np.testing.assert_allclose(mom[k][j].numpy(), w.numpy(), rtol=rtol,
                                       atol=max(rtol * float(w.abs().max()), floor), err_msg=k)
    for r in ranks[1:]:
        for k, v in r["dp_step1"]["params"].items():
            assert torch.equal(v, got["params"][k]), k
        assert r["dp_loss"] == ranks[0]["dp_loss"]
    specs = zero1_sharding_tree(want, Mesh(4, 1, 0, CPU, None))
    assert specs == state_shardings(want, Mesh(4, 1, 0, CPU, None))["opt_states"]
    total = sum(2 * 4 * w.numel() for w in want.values())
    replicated = sum(2 * 4 * w.numel() for k, w in want.items() if not specs[k])
    assert replicated < total / 8
    for r in ranks:
        assert r["dp_moment_bytes"] <= total / 4 + replicated
        assert r["dp_moment_bytes"] < total / 2


def test_steps_scan_nonfinite_skip_and_four_ranks_equal_one_process(run):
    """steps_scan for K = 2 equals two steps bit for bit; one rank's NaN row
    skips the update on every rank (params, update count) while the step
    count advances; and 4 ranks take the update one process takes at the
    same global batch and draws, within 1e-5 of each tensor's largest value
    (the order of the gradient sum differs)."""
    ranks = run["ranks"]
    r0 = ranks[0]
    np.testing.assert_allclose(r0["scan_losses"], r0["dp_loss"], rtol=0, atol=0)
    for k, v in r0["scan_params"].items():
        assert torch.equal(v, r0["dp_step2"][k]), k
    for r in ranks:
        assert np.isnan(r["nan_loss"]) and r["nan_kept"] and r["nan_counts"] == (2, 3)
    for k, v in r0["one_process"].items():
        assert _rel(r0["dp_step2"][k], v) <= 1e-5, k
    assert r0["update_count"] == 2


def test_tp_step_equals_dp_step(run):
    """(2, 2) mesh, tensor-parallel columns from 8 wide merged with ZeRO-1
    (JAX test_tp_sharded_step_matches_dp): the step's loss and params equal
    the (4, 1) data-parallel step's."""
    ranks = run["ranks"]
    for r in ranks:
        np.testing.assert_allclose(r["tp_loss"], ranks[0]["dp_loss"][0], rtol=1e-6)
        for k, v in r["tp_step1"].items():
            assert _rel(v, ranks[0]["dp_step1"]["params"][k]) <= 1e-5, k
    specs = ranks[0]["tp_specs"]
    assert any(s and s[-1] == "model" for s in specs) and any("data" in s for s in specs)


# ---------------------------------------------------------------- model axis
def test_sequence_parallel_mqa_matches_jax(run):
    """Model axis 4: the forward at the flash forward's f32 bound (2e-5), the
    gradients of q, k, v and the null kv at rtol 2e-3 + 1e-5 of the largest
    (the null kv's summed over the axis once, not 4 times), the same on
    every rank."""
    o, grads = run["jax"]["sp"]
    for r in run["ranks"]:
        np.testing.assert_allclose(r["sp_out"].numpy(), o, atol=2e-5)
        for name, want in zip(("q", "k", "v", "nk", "nv"), grads):
            np.testing.assert_allclose(r["sp_grads"][name].numpy(), want, rtol=2e-3,
                                       atol=1e-5 * np.abs(want).max(), err_msg=name)


def test_unet_sp_attention_trains_as_xla_and_falls_back(run):
    """attention_impl sp on the (2, 2) mesh: the loss and every gradient of
    the xla unet on the same params and draws (rtol 2e-4, JAX's loss hold;
    gradients 1e-4 of each tensor's largest), SP engaged at the 512-token
    bottleneck; and sp at 7 tokens over a model axis of 2 takes the auto
    rule (xla on the CPU) without calling the SP path."""
    for r in run["ranks"]:
        (l_sp, g_sp), (l_x, g_x) = r["sp_unet"]["sp"], r["sp_unet"]["xla"]
        np.testing.assert_allclose(l_sp, l_x, rtol=2e-4)
        for k, g in g_x.items():
            assert _rel(g_sp[k], g) <= 1e-4, k
        assert r["sp_calls"] and all(s[1] == 512 for s in r["sp_calls"])
        assert r["fallback"] == (0, True)


def test_flash_backward_routes_by_the_global_batch():
    """Under a data axis of 2, a rank's batch-1 bf16 flash backward takes
    the batch-2 route (JAX traces the global batch): each row's dq, dk, dv
    equal that row of the batch-2 backward bit for bit, and the saved lse
    is the rounding route's own."""
    rng = np.random.default_rng(11)
    q, k, v, g = (torch.from_numpy(rng.standard_normal(s).astype(np.float32)).bfloat16()
                  for s in ((2, 48, 16), (2, 33, 16), (2, 33, 16), (2, 48, 16)))
    out, lse = port_flash.fwd_residuals(q, k, v, sm_scale=0.25)
    whole = port_flash.flash_mqa_bwd(q, k, v, out, lse, g, sm_scale=0.25)
    mesh = Mesh(2, 1, 0, CPU, None)
    with active_mesh(mesh):
        assert global_batch(1) == 2
        for i in range(2):
            row = [t[i:i + 1] for t in (q, k, v)]
            o1, l1 = port_flash.fwd_residuals(*row, sm_scale=0.25, batch=global_batch(1))
            assert port_flash.bwd_rounds(row[0], global_batch(1))
            assert torch.equal(o1, out[i:i + 1]) and torch.equal(l1, lse[i:i + 1])
            got = port_flash.flash_mqa_bwd(*row, o1, l1, g[i:i + 1], sm_scale=0.25,
                                           batch=global_batch(1))
            for a, w in zip(got, whole):
                assert torch.equal(a, w[i:i + 1])
    assert not port_flash.bwd_rounds(q[:1])  # one device, batch 1: the f32 route


# ---------------------------------------------------------------- CLIP
def test_sharded_clip_loss_matches_jax_and_the_gathered_loss(run):
    """The global-batch loss on every rank equals JAX sharded_clip_loss and
    clip_loss of the gathered batch (rtol 1e-5); each rank's gradient in its
    rows is that row block of the single-device gradient, and the
    temperature's parts sum to its gradient, at the same tolerance: 1x, not
    4x."""
    c = run["inputs"]["clip"]
    x, y = (torch.from_numpy(c[k]).requires_grad_(True) for k in ("x", "y"))
    temp = torch.tensor(c["temp"], requires_grad=True)
    loss = clip_loss(x, y, temp)
    loss.backward()
    jl, (jgx, jgy, jgt) = run["jax"]["clip_loss"]
    t_parts = 0.0
    for i, r in enumerate(run["ranks"]):
        np.testing.assert_allclose(r["clip_loss"], float(loss.detach()), rtol=1e-5)
        np.testing.assert_allclose(r["clip_loss"], float(jl), rtol=1e-5)
        gx, gy, gt = r["clip_grads"]
        np.testing.assert_allclose(gx.numpy(), x.grad[i:i + 1].numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gy.numpy(), y.grad[i:i + 1].numpy(), rtol=1e-5, atol=1e-7)
        np.testing.assert_allclose(gx.numpy(), jgx[i:i + 1], rtol=1e-5, atol=1e-7)
        t_parts += float(gt)
    np.testing.assert_allclose(t_parts, float(temp.grad), rtol=1e-5)


def test_sharded_clip_step_matches_jax(run):
    """ClipTrainer.make_sharded_train_step against JAX's on the (4, 1) mesh
    from the same state: metrics and temperature 1e-5 relative; params atol
    2e-6 + rtol 1e-4 (test_clip_train_steps_match_jax's holds); the ranks
    agree bit for bit."""
    metrics, params, temp = run["jax"]["clip_step"]
    ranks = run["ranks"]
    got = ranks[0]["clip_step"]
    for k in ("loss", "temperature", "top1", "top10"):
        np.testing.assert_allclose(got["metrics"][k], metrics[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(got["temperature"], temp, rtol=1e-5)
    for k, p in got["params"].items():
        np.testing.assert_allclose(p.numpy(), params[k].numpy(), rtol=1e-4, atol=2e-6,
                                   err_msg=k)
    for r in ranks[1:]:
        assert all(torch.equal(v, got["params"][k]) for k, v in r["clip_step"]["params"].items())


# ---------------------------------------------------------------- distill
def test_dp_distill_step_matches_the_single_device_step(run):
    """The data-parallel distill step (batch rows over data, the teacher
    replicated) against one process's step at the global batch and draws:
    loss rtol 2e-4 (JAX test_distill_step_sharded_matches_single), the
    student within 2e-4."""
    single_loss, single = run["ranks"][0]["distill_single"]
    for r in run["ranks"]:
        loss, student = r["distill_dp"]
        np.testing.assert_allclose(loss, single_loss, rtol=2e-4)
        for k, v in student.items():
            np.testing.assert_allclose(v.numpy(), single[k].numpy(), atol=2e-4, err_msg=k)


# ---------------------------------------------------------------- data, checkpoints
def test_loader_shards_disjoint_cover_the_epoch_and_match_jax(run):
    """Both loaders, each rank's shard of a shuffled 32-index epoch at 2
    rows a batch: disjoint, together every index, each equal to the JAX
    BatchLoader's shard (tests/test_multihost.py's loader)."""
    seen = set()
    for i, r in enumerate(run["ranks"]):
        assert r["loader_thread"] == r["loader_workers"]
        jax_batches = [np.asarray(b["x"]).tolist() for b in JaxBatchLoader(
            _JaxIndices(), 2, shuffle=True, seed=7, shard_index=i, num_shards=4)]
        assert r["loader_thread"] == jax_batches
        flat = {x for b in r["loader_thread"] for x in b}
        assert not flat & seen
        seen |= flat
    assert seen == set(range(32))


class _JaxIndices:
    def __len__(self):
        return 32

    def batch_items(self, idx):
        return {"x": np.asarray(idx)}


def _same(a, b, path="state"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif torch.is_tensor(a):
        assert torch.equal(a, b), path
    else:
        assert a == b, path


def test_zero1_checkpoint_restores_at_one_and_two_ranks(run):
    """Rank 0 saves the (4, 1) trainer's state (moments gathered: the
    single-device format); restored at 2 ranks (sharded again) and at 1,
    each gives back the same state; load_latest reads it."""
    r0 = run["ranks"][0]
    saved = load_latest(str(run["dir"] / "ckpt"))
    _same(saved["opt_states"], r0["saved"]["opt_states"])
    for restored in (r0["restored_1"], r0["restored_2"], run["ranks"][1]["restored_2"]):
        _same(restored["params"], saved["params"])
        _same(restored["opt_states"], saved["opt_states"])
        _same(restored["ema"], saved["ema"])
        assert restored["steps"] == saved["steps"] == [3]


# ---------------------------------------------------------------- serving, entry point
def test_data_parallel_serving_matches_one_process(run):
    """A group of 4 smoke-stack requests split over 4 ranks (rank 0 the
    engine's callable, the others in serve_worker until stopped) gives every
    row the single-process group's video, bit for bit on the CPU; one
    cascade stage split by make_sharded_sample_stage gives, on every rank,
    the one-process stage's rows within 1e-5 (f32: the unet at batch 1
    against 4 sums its convolutions in another order); the serving buckets
    round up to the data axis."""
    for r in run["ranks"]:
        assert r["stage_dp"].shape == (4, 2, S, S, 3)
        np.testing.assert_allclose(r["stage_dp"].numpy(), r["stage_single"].numpy(), atol=1e-5)
    r0 = run["ranks"][0]
    assert r0["dp_videos"].shape == r0["single_videos"].shape == (4, 2, 32, 32, 3)
    np.testing.assert_array_equal(r0["dp_videos"], r0["single_videos"])
    assert [r["served"] for r in run["ranks"][1:]] == [1, 1, 1]
    assert data_parallel_buckets((1, 2, 4), 4) == (4,)
    assert data_parallel_buckets((1, 2, 3, 8), 2) == (2, 4, 8)


def test_decoder_entry_point_under_four_ranks(run):
    """python -m dalle2_video_tpu_torch.train smoke=true mesh.data=-1 under
    4 gloo ranks: a batch of 4 (one row a rank), one checkpoint and one
    metrics file, written by rank 0 alone; resume=true picks it up."""
    entry = run["dir"] / "entry"
    state = load_latest(str(entry / "decoder_default"))
    assert state["steps"] == [2, 2] and state["ema"][0]["step"] == 2
    assert {len(st["state"]) > 0 for st in state["opt_states"]} == {True}
    lines = (entry / "decoder_default.metrics.jsonl").read_text().splitlines()
    assert len(lines) == 4 and all("nan" not in line for line in lines)
    assert sorted(p.name for p in entry.iterdir()) == [
        "decoder_default", "decoder_default.config.json", "decoder_default.heartbeat",
        "decoder_default.metrics.jsonl"]


def test_mesh_shape_rules_and_draws_without_a_group():
    """data -1 is world / model; a mesh that differs from the launched
    world raises with both numbers; without a process group the mesh is one
    rank's; batch_draw under a data axis of 2 takes its rows of the global
    batch's draw."""
    assert resolve_mesh_shape({"data": -1, "model": 2}, 4) == (2, 2)
    with pytest.raises(ValueError, match="4x1 = 4 devices, but 2 ranks"):
        resolve_mesh_shape({"data": 4}, 2)
    with pytest.raises(ValueError, match="model=3"):
        resolve_mesh_shape({"model": 3}, 4)
    mesh = create_mesh()
    assert (mesh.data, mesh.model, mesh.world_group) == (1, 1, None)
    assert torch.equal(shard_batch(mesh, torch.arange(4)), torch.arange(4))
    full = torch.randn((4, 3), generator=torch.Generator().manual_seed(0))
    for i in range(2):
        with active_mesh(Mesh(2, 1, i, CPU, None)):
            got = batch_draw(lambda s: torch.randn(s, generator=torch.Generator().manual_seed(0)),
                             (2, 3))
        assert torch.equal(got, full[2 * i:2 * i + 2])
