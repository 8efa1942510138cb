"""The CLIP stage against the JAX package, on the CPU: the contrastive loss
and retrieval metrics, the ViViT forward, the CLIP trainer's steps under
each schedule (params, temperature, Adam moments, metrics), the learning
rate at every boundary, the frozen text tower, the OpenAI text-tower
loader, and the stage's entry points (``train.train_clip``,
``train.eval_clip``) on a store written inside the test, with the key
derivation that ties eval's text tower to train's.

Tiny towers (ViViT 16 px, patch 8, 25 frames, dim 24, depth 1; a 1-layer
text tower of width 32). JAX weights are initialised by jitted inits and
carried across with ``weights.load_from_jax`` / ``load_clip_train_state_
from_jax``; everything is f32 and dropout-free (no draw to replay). The
JAX programs compile at XLA's lowest optimisation level.
"""

from __future__ import annotations

import collections
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.models.clip_text import CLIPTextConfig as JaxTextCfg
from dalle2_video_tpu.models.clip_text import CLIPTextEncoder as JaxText
from dalle2_video_tpu.models.clip_text import load_openai_clip_text_params as jax_openai
from dalle2_video_tpu.models.vivit import ViViT as JaxViViT
from dalle2_video_tpu.models.vivit import ViViTConfig as JaxViViTCfg
from dalle2_video_tpu.train.clip_trainer import ClipTrainer as JaxClipTrainer
from dalle2_video_tpu.train.clip_trainer import ClipTrainerConfig as JaxClipCfg
from dalle2_video_tpu.train.clip_trainer import ClipTrainState
from dalle2_video_tpu.utils import contrastive as jax_contrastive
from dalle2_video_tpu_torch.data import shards
from dalle2_video_tpu_torch.models.clip_text import (
    CLIPTextConfig,
    CLIPTextEncoder,
    load_openai_clip_text_params,
)
from dalle2_video_tpu_torch.models.vivit import ViViT, ViViTConfig
from dalle2_video_tpu_torch.train import eval_clip, train_clip
from dalle2_video_tpu_torch.train.clip_trainer import (
    ClipTrainer,
    ClipTrainerConfig,
    build_text_encoder,
    clip_stage_generators,
    lr_at,
)
from dalle2_video_tpu_torch.utils import contrastive
from dalle2_video_tpu_torch.utils.keys import init_from
from dalle2_video_tpu_torch.weights import (
    load_clip_train_state_from_jax,
    load_from_jax,
    params_from_jax,
)

torch.set_num_threads(1)
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}

VIVIT = dict(frame_size=16, patch_size=8, num_frames=25, dim=24, depth=1, heads=2, dim_head=8)
TEXT = dict(vocab_size=1000, width=32, heads=2, layers=1, embed_dim=24)
B = 4


def _compiled(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _batch(seed, b=B, frames=25, size=16):
    rng = np.random.default_rng(seed)
    videos = rng.standard_normal((b, frames, size, size, 3)).astype(np.float32)
    tokens = rng.integers(1, TEXT["vocab_size"], (b, 77)).astype(np.int32)
    return videos, tokens


@functools.lru_cache(maxsize=None)
def _jax_vivit(vivit_kw=tuple(sorted(VIVIT.items()))):
    """(ViViT module, its params), the JAX init jitted."""
    jv = JaxViViT(JaxViViTCfg(**dict(vivit_kw)))
    k = jax.random.PRNGKey(0)
    videos, _ = _batch(0, b=1)
    return jv, _compiled(jv.init, k, videos)(k, videos)


def _jax_text():
    jt = JaxText(JaxTextCfg(**TEXT))
    k = jax.random.PRNGKey(1)
    _, tokens = _batch(0, b=1)
    return _compiled(jt.init, k, tokens)(k, tokens)


def _close(got, want, rtol, atol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = np.abs(got - want)
    assert np.all(err <= atol + rtol * np.abs(want)), (what, float(err.max()))


# --------------------------------------------------------------- contrastive
@pytest.mark.parametrize("ties", [False, True], ids=["distinct", "ties"])
def test_clip_loss_and_retrieval_metrics_match_jax(ties):
    """f32, 1e-6: the symmetric InfoNCE at a learned temperature, and top-k
    with ties counted against the pair (duplicated rows tie every pair
    they touch) and top-k for k >= batch equal to 1."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 2, 5)).astype(np.float32)
    y = rng.standard_normal((6, 10)).astype(np.float32)
    if ties:
        x[1], y[1] = x[0], y[0]
        y[3] = y[2]
    temp = np.float32(2.5)
    logits, loss = jax_contrastive.clip_loss(x, y, temp, return_logits=True)
    got_logits, got_loss = contrastive.clip_loss(_t(x), _t(y), torch.tensor(temp),
                                                 return_logits=True)
    _close(got_logits, logits, 1e-6, 1e-6, "logits")
    _close(got_loss, loss, 1e-6, 1e-6, "loss")
    topk = (1, 2, 6, 10)
    want = jax_contrastive.retrieval_metrics(x, y, topk)
    got = contrastive.retrieval_metrics(_t(x), _t(y), topk)
    for k in topk:
        assert float(got[f"top{k}"]) == pytest.approx(float(want[f"top{k}"]), abs=1e-6), k
    assert float(got["top6"]) == float(got["top10"]) == 1.0
    if ties:  # rows 0 and 1 tie: each ranks the other's caption level with its own
        sim = contrastive.l2_normalize(_t(x).reshape(6, -1)) @ contrastive.l2_normalize(_t(y)).T
        assert sim[0, 1] == sim[0, 0] and float(got["top1"]) <= 4 / 6
    with pytest.raises(ValueError, match="needs a mesh"):
        contrastive.sharded_clip_loss(_t(x), _t(y), torch.tensor(temp), None)


# --------------------------------------------------------------- ViViT
_SINGLE_HEAD = dict(VIVIT, dim=8, heads=1, dim_head=8, depth=2)


@pytest.mark.parametrize("kw", [VIVIT, _SINGLE_HEAD], ids=["heads2", "single-head-no-out-proj"])
def test_vivit_forward_matches_jax(kw):
    """f32, relative 1e-5 of the output's scale: the patch layout, the
    position slice, patch 0 per frame, the folded temporal-conv head (its
    kernel transposed), eps 1e-6 LayerNorms and exact GELU."""
    jv, vp = _jax_vivit(tuple(sorted(kw.items())))
    videos, _ = _batch(2)
    want = np.asarray(_compiled(jv.apply, vp, videos)(vp, videos))
    m = load_from_jax(ViViT(ViViTConfig(**kw)), _np_tree(vp)).eval()
    with torch.no_grad():
        got = m(torch.from_numpy(videos)).numpy()
    assert got.shape == (B, kw["dim"])
    _close(got, want, 0, 1e-5 * np.abs(want).max(), "vivit")
    assert not hasattr(m.space_transformer.attn0, "to_out") or kw["heads"] > 1


def test_vivit_config_and_dropout_refusals():
    """The head's fold needs num_frames % scale_dim_conv**2 == 0; configured
    dropout refuses to run in training without a generator, in the module
    and in ClipTrainer.train_step (as ClipTrainer._vivit_apply_kwargs), and
    runs with one."""
    with pytest.raises(ValueError, match="folds time"):
        ViViTConfig(**dict(VIVIT, num_frames=24))
    with pytest.raises(ValueError, match="patch_size"):
        ViViTConfig(**dict(VIVIT, patch_size=5))
    cfg = ViViTConfig(**dict(VIVIT, dropout=0.1))
    videos, tokens = _batch(3)
    m = ViViT(cfg).train()
    with pytest.raises(ValueError, match="generator"):
        m(torch.from_numpy(videos))
    g = torch.Generator().manual_seed(0)
    a = m(torch.from_numpy(videos), g)
    b = m(torch.from_numpy(videos), g)
    assert not torch.equal(a, b)  # the stream advances: dropout applied
    with torch.no_grad():
        m.eval()
        assert torch.equal(m(torch.from_numpy(videos)), m(torch.from_numpy(videos)))
    tr = ClipTrainer(cfg, CLIPTextConfig(**TEXT), device="cpu")
    with pytest.raises(ValueError, match="generator"):
        tr.train_step(torch.from_numpy(videos), torch.from_numpy(tokens))
    assert tr.step == 0
    tr.train_step(torch.from_numpy(videos), torch.from_numpy(tokens), tr.dropout_generator)
    assert tr.step == 1


# --------------------------------------------------------------- schedules
_SCHEDULES = [
    # total 10: boundaries 4, 6, 8, 9
    dict(lr_scheduler="multistep", total_steps=10),
    # total 4: 0.8 and 0.9 both land on step 3 and collapse into one factor
    dict(lr_scheduler="multistep", total_steps=4),
    dict(lr_scheduler="multistep", total_steps=10, lr_multistep_milestones=(0.0, 0.5)),
    dict(lr_scheduler="cosine", total_steps=7),
    dict(lr_scheduler="constant", total_steps=5),
]


@pytest.mark.parametrize("kw", _SCHEDULES, ids=lambda kw: f"{kw['lr_scheduler']}-{kw}")
def test_lr_at_every_boundary_matches_optax(kw):
    """The lr of the update after ``count`` updates, at every count through
    each boundary and past the end, against the JAX trainer's schedule
    (f32, 1e-6 relative); the factor applies from count >= boundary."""
    want = JaxClipTrainer(JaxViViTCfg(**VIVIT), JaxTextCfg(**TEXT), JaxClipCfg(**kw)).schedule
    cfg = ClipTrainerConfig(**kw)
    for count in range(cfg.total_steps + 3):
        assert lr_at(cfg, count) == pytest.approx(float(want(count)), rel=1e-6), count
    if kw == _SCHEDULES[0]:
        assert [lr_at(cfg, c) / cfg.lr for c in (3, 4, 5, 6, 7, 8, 9)] == [
            1, 0.5, 0.5, 0.25, 0.25, 0.125, 0.0625]


# --------------------------------------------------------------- train steps
def _jax_state(trainer, vp):
    temp = jnp.asarray(trainer.cfg.init_temperature, jnp.float32)
    trainable = {"vivit": vp, "temp": temp}
    opt = _compiled(trainer.optimizer.init, trainable)(trainable)
    return ClipTrainState(vivit_params=vp, temperature=temp, opt_state=opt,
                          step=jnp.zeros((), jnp.int32))


def _adam(state):
    """The JAX chain's scale_by_adam state: mu, nu, count."""
    adam = state.opt_state[0]
    return _np_tree(adam.mu), _np_tree(adam.nu), int(adam.count)


_TRAIN_CASES = [
    # boundaries at 1, 2, 3 (0.8 and 0.9 collapse): every step crosses one
    dict(lr_scheduler="multistep", total_steps=4, weight_decay=0.1),
    dict(lr_scheduler="cosine", total_steps=4),
]


@pytest.mark.parametrize("kw", _TRAIN_CASES, ids=["multistep-wd", "cosine"])
def test_clip_train_steps_match_jax(kw):
    """K = 4 ClipTrainer.train_steps from a carried JAX state (after one
    JAX step, so the moments are non-zero): the ViViT params, the
    temperature, the Adam moments and the metrics of every step, and
    eval_step after; the frozen text tower is bit-for-bit unchanged, has no
    grad and is in no optimiser group. Tolerances: metrics and temperature
    1e-5 relative; params atol 2e-6 + rtol 1e-4; moments rtol 1e-4 plus 1e-5
    of the tensor's largest value (the f32 gradients differ in their last
    bits, most where they cancel to near zero)."""
    _, vp = _jax_vivit()
    tp = _jax_text()
    jtr = JaxClipTrainer(JaxViViTCfg(**VIVIT), JaxTextCfg(**TEXT),
                         JaxClipCfg(lr=1e-3, init_temperature=4.0, **kw))
    state = _jax_state(jtr, vp)
    batches = [_batch(10 + i) for i in range(5)]
    step = _compiled(jtr.train_step, state, tp, *batches[0])
    state, _ = step(state, tp, *batches[0])

    tr = ClipTrainer(ViViTConfig(**VIVIT), CLIPTextConfig(**TEXT),
                     ClipTrainerConfig(lr=1e-3, init_temperature=4.0, **kw), device="cpu")
    load_from_jax(tr.text_encoder, _np_tree(tp))
    mu, nu, count = _adam(state)
    load_clip_train_state_from_jax(tr, {
        "vivit_params": _np_tree(state.vivit_params), "temperature": state.temperature,
        "opt_state": {"mu": mu, "nu": nu, "count": count}, "step": state.step})
    assert tr.step == 1
    text_before = {k: v.clone() for k, v in tr.text_encoder.state_dict().items()}
    for videos, tokens in batches[1:]:
        state, want = step(state, tp, videos, tokens)
        got = tr.train_step(torch.from_numpy(videos), torch.from_numpy(tokens))
        for k in ("loss", "temperature", "top1", "top10"):
            _close(got[k], want[k], 1e-5, 1e-6, k)
    assert tr.step == int(state.step) == 5
    _close(tr.temperature.detach(), state.temperature, 1e-5, 1e-6, "temperature")
    ours = {k: p.detach() for k, p in tr.vivit.named_parameters()}
    want_p = params_from_jax(_np_tree(state.vivit_params))
    for k, p in ours.items():
        _close(p, want_p[k], 1e-4, 2e-6, k)
    mu, nu, count = _adam(state)
    mu_v, nu_v = params_from_jax(mu["vivit"]), params_from_jax(nu["vivit"])
    for k, p in tr.vivit.named_parameters():
        st = tr.optimizer.state[p]
        assert int(st["step"]) == count
        _close(st["exp_avg"], mu_v[k], 1e-4, 1e-5 * np.abs(mu_v[k].numpy()).max(), f"mu {k}")
        _close(st["exp_avg_sq"], nu_v[k], 1e-4, 1e-5 * np.abs(nu_v[k].numpy()).max(),
               f"nu {k}")
    st = tr.optimizer.state[tr.temperature]
    _close(st["exp_avg"], mu["temp"], 1e-4, 1e-9, "mu temp")
    _close(st["exp_avg_sq"], nu["temp"], 1e-4, 1e-12, "nu temp")

    if kw["lr_scheduler"] == "cosine":  # eval_step once (its own compile)
        videos, tokens = batches[0]
        want = _compiled(jtr.eval_step, state, tp, videos, tokens)(state, tp, videos, tokens)
        got = tr.eval_step(torch.from_numpy(videos), torch.from_numpy(tokens))
        for k in ("loss", "top1", "top10"):
            _close(got[k], want[k], 1e-5, 1e-6, f"eval {k}")

    after = tr.text_encoder.state_dict()
    assert all(torch.equal(after[k], v) for k, v in text_before.items())
    assert not any(p.requires_grad for p in tr.text_encoder.parameters())
    in_opt = {id(p) for g in tr.optimizer.param_groups for p in g["params"]}
    assert not in_opt & {id(p) for p in tr.text_encoder.parameters()}
    assert [g["weight_decay"] for g in tr.optimizer.param_groups] == [
        kw.get("weight_decay", 0.0), 0.0]


def test_clip_state_bridge_copies_so_the_port_step_may_run_first():
    """The CLIP bridge copies what it loads: no tensor of the port's state
    shares memory with the JAX state's arrays. The port's Adam updates its
    moments in place; where the temperature's moments aliased the JAX
    buffers, a port step that ran before the JAX step had read its inputs
    (JAX dispatches asynchronously) moved the JAX step's moments too: JAX
    then gave 3.99800158 for 3.99814439. Here the port steps first every
    time, then JAX; the cosine case's temperatures and moments hold as in
    test_clip_train_steps_match_jax (1e-5 relative; mu, nu 1e-4), and the
    JAX state's arrays are unchanged by the port's step."""
    kw = dict(lr_scheduler="cosine", total_steps=4)
    _, vp = _jax_vivit()
    tp = _jax_text()
    jtr = JaxClipTrainer(JaxViViTCfg(**VIVIT), JaxTextCfg(**TEXT),
                         JaxClipCfg(lr=1e-3, init_temperature=4.0, **kw))
    state = _jax_state(jtr, vp)
    batches = [_batch(10 + i) for i in range(3)]
    step = _compiled(jtr.train_step, state, tp, *batches[0])
    state, _ = step(state, tp, *batches[0])
    tr = ClipTrainer(ViViTConfig(**VIVIT), CLIPTextConfig(**TEXT),
                     ClipTrainerConfig(lr=1e-3, init_temperature=4.0, **kw), device="cpu")
    load_from_jax(tr.text_encoder, _np_tree(tp))
    mu, nu, count = _adam(state)
    load_clip_train_state_from_jax(tr, {
        "vivit_params": _np_tree(state.vivit_params), "temperature": state.temperature,
        "opt_state": {"mu": mu, "nu": nu, "count": count}, "step": state.step})
    given = [a for tree in (mu, nu) for a in jax.tree_util.tree_leaves(tree)]
    before = [a.copy() for a in given]
    ours = [t for st in tr.optimizer.state.values() for t in st.values()]
    assert not any(np.shares_memory(t.numpy(), a) for t in ours for a in given)
    for videos, tokens in batches[1:]:
        got = tr.train_step(torch.from_numpy(videos), torch.from_numpy(tokens))
        state, want = step(state, tp, videos, tokens)
        _close(got["temperature"], want["temperature"], 1e-5, 1e-6, "temperature")
        st = tr.optimizer.state[tr.temperature]
        jmu, jnu, _ = _adam(state)
        _close(st["exp_avg"], jmu["temp"], 1e-4, 1e-9, "mu temp")
        _close(st["exp_avg_sq"], jnu["temp"], 1e-4, 1e-12, "nu temp")
    assert all(np.array_equal(a, b) for a, b in zip(given, before))


# --------------------------------------------------------------- OpenAI loader
class _OpenAITower(torch.nn.Module):
    """Parameters under OpenAI CLIP's text-tower state-dict names; scripted
    and saved, it is the TorchScript archive clip.load reads."""

    def __init__(self, sd):
        super().__init__()
        for name, value in sd.items():
            *path, leaf = name.split(".")
            mod = self
            for part in path:
                if not hasattr(mod, part):
                    mod.add_module(part, torch.nn.Module())
                mod = getattr(mod, part)
            mod.register_parameter(leaf, torch.nn.Parameter(value))

    def forward(self, x):
        return x + self.positional_embedding


@pytest.mark.parametrize("form", ["plain", "state_dict", "jit"])
def test_openai_clip_text_loader_matches_jax(tmp_path, form):
    """The port's loader against the JAX one on an OpenAI-layout state dict
    built here (random, no download), saved plain, under "state_dict" or
    as a TorchScript archive: the two towers' embeddings and encodings
    agree (f32, 1e-5), and the loaded module is strict (every weight
    placed, none left)."""
    vocab, ctx, d, heads, layers, emb = 50, 8, 16, 2, 2, 12
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g) * 0.2  # noqa: E731
    sd = collections.OrderedDict()
    sd["token_embedding.weight"] = r(vocab, d)
    sd["positional_embedding"] = r(ctx, d)
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        sd[f"{p}.attn.in_proj_weight"], sd[f"{p}.attn.in_proj_bias"] = r(3 * d, d), r(3 * d)
        sd[f"{p}.attn.out_proj.weight"], sd[f"{p}.attn.out_proj.bias"] = r(d, d), r(d)
        sd[f"{p}.mlp.c_fc.weight"], sd[f"{p}.mlp.c_fc.bias"] = r(4 * d, d), r(4 * d)
        sd[f"{p}.mlp.c_proj.weight"], sd[f"{p}.mlp.c_proj.bias"] = r(d, 4 * d), r(d)
        for ln in ("ln_1", "ln_2"):
            sd[f"{p}.{ln}.weight"], sd[f"{p}.{ln}.bias"] = 1 + r(d), r(d)
    sd["ln_final.weight"], sd["ln_final.bias"] = 1 + r(d), r(d)
    sd["text_projection"] = r(d, emb)
    path = str(tmp_path / "clip.pt")
    if form == "jit":
        torch.jit.save(torch.jit.script(_OpenAITower(sd)), path)
    else:
        torch.save({"state_dict": sd} if form == "state_dict" else sd, path)

    kw = dict(vocab_size=vocab, context_length=ctx, width=d, heads=heads, layers=layers,
              embed_dim=emb)
    tokens = np.random.default_rng(0).integers(1, vocab, (3, ctx)).astype(np.int32)
    jm = JaxText(JaxTextCfg(**kw))
    params = jax_openai(path, JaxTextCfg(**kw))
    fwd = functools.partial(jm.apply, return_encodings=True)
    want_e, want_x = _compiled(fwd, params, tokens)(params, tokens)
    m = CLIPTextEncoder(CLIPTextConfig(**kw))
    m.load_state_dict(load_openai_clip_text_params(path, CLIPTextConfig(**kw)), strict=True)
    with torch.no_grad():
        got_e, got_x = m(torch.from_numpy(tokens), return_encodings=True)
    _close(got_e, want_e, 1e-5, 1e-5, "embed")
    _close(got_x, want_x, 1e-5, 1e-5, "encodings")
    # build_text_encoder loads it over the generator's init
    enc = build_text_encoder(CLIPTextConfig(**kw), torch.Generator().manual_seed(3), path)
    assert all(torch.equal(enc.state_dict()[k], v) for k, v in m.state_dict().items())


# --------------------------------------------------------------- entry points
N_CLIPS = 7  # split 5 / 2: 2 train batches and 1 val batch at 2; eval leaves a tail of 1


@pytest.fixture
def tiny_text_tower(monkeypatch):
    """The entry points' text tower at TEXT's widths (CLIP's 12 x 512 tower
    costs seconds a build on one thread); both read it from text_config."""
    for mod in (train_clip, eval_clip):
        monkeypatch.setattr(mod, "text_config", lambda cfg: CLIPTextConfig(**TEXT))


def write_clip_store(root, n=N_CLIPS, seed=0):
    """A .vshard store of n (3, 25, 16, 16) clips and (n, 77) tokens; returns
    the config overrides of a tiny CLIP stage reading them."""
    rng = np.random.default_rng(seed)
    with shards.ShardWriter(f"{root}/videos.vshard", (3, 25, 16, 16), np.float32) as w:
        for _ in range(n):
            w.append(rng.standard_normal((3, 25, 16, 16), dtype=np.float32))
    np.save(f"{root}/tokens.npy",
            rng.integers(1, TEXT["vocab_size"], (n, 77)).astype(np.int32))
    return [f"run_dir={root}/runs", "device=cpu", "loader=thread", "dim=24",
            f"videos.preprocessed={root}/videos.vshard", f"texts.tokenized={root}/tokens.npy",
            f"videos.embed={root}/embeds/videos.npy", f"texts.embed={root}/embeds/texts.npy",
            *(f"video_encoder.{k}={v}" for k, v in VIVIT.items()),
            "clip.batch_size=2", "clip.epochs=2"]


def test_train_then_eval_clip_on_a_store(tmp_path, caplog, tiny_text_tower):
    """train_clip trains 2 epochs (2 steps each, val every epoch, a
    checkpoint each epoch, best by val loss) and resumes to a third;
    eval_clip loads the newest checkpoint, embeds all 7 clips (the tail
    one too), each row equal to the towers' output on its clip, writes
    both .npy files and logs the retrieval."""
    import logging

    args = write_clip_store(tmp_path)
    s = train_clip.main(args)
    tr = s["trainer"]
    assert tr.step == 4 and set(s["train"]) == {"loss", "temperature", "top1", "top10"}
    assert np.isfinite(s["val"]["loss"])
    mgr = train_clip.RollingCheckpointManager(str(tmp_path / "runs/clip_default"))
    assert mgr.all_steps() == [2, 4] and mgr.best_step() in (2, 4)
    s2 = train_clip.main(args + ["resume=true", "clip.epochs=3"])
    assert s2["trainer"].step == 6  # restarted at epoch 2 from step 4

    with caplog.at_level(logging.INFO, logger="dalle2_video_tpu_torch.eval_clip"):
        e = eval_clip.main(args)
    assert "retrieval over 7 pairs" in caplog.text
    ve, te = np.load(tmp_path / "embeds/videos.npy"), np.load(tmp_path / "embeds/texts.npy")
    assert ve.shape == te.shape == (N_CLIPS, 24) and ve.dtype == np.float32
    etr = e["trainer"]
    assert etr.step == 6  # the newest checkpoint by default
    ds = train_clip.CelebVTextDataset(texts_path=str(tmp_path / "tokens.npy"),
                                      videos_path=str(tmp_path / "videos.vshard"))
    items = ds.batch_items(np.arange(N_CLIPS))
    want_v = etr.embed_video(torch.from_numpy(items["videos"])).numpy()
    want_t = etr.embed_text(torch.from_numpy(items["texts"])).numpy()
    np.testing.assert_allclose(ve, want_v, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(te, want_t, rtol=1e-5, atol=1e-6)
    assert e["top1"] == eval_clip.retrieval(ve, te)[1]
    best = eval_clip.main(args + ["eval_ckpt=best"])["trainer"]
    assert best.step == mgr.best_step()


def test_eval_text_tower_is_train_text_tower(tmp_path, tiny_text_tower):
    """Key-derivation repair: the text tower eval_clip builds equals
    train_clip's bit for bit (both from clip_stage_generators(seed)); a
    tower derived any other way -- the unsplit seed, the ViViT's stream,
    another seed -- differs."""
    args = write_clip_store(tmp_path, n=5)
    trained = train_clip.main(args + ["clip.epochs=1"])["trainer"].text_encoder.state_dict()
    evaluated = eval_clip.main(args)["trainer"].text_encoder.state_dict()
    assert all(torch.equal(evaluated[k], v) for k, v in trained.items())
    cfg = CLIPTextConfig(**TEXT)
    seed = 1234
    g_vivit, g_text, _ = clip_stage_generators(seed)
    rebuilt = build_text_encoder(cfg, g_text).state_dict()
    assert all(torch.equal(rebuilt[k], v) for k, v in trained.items())
    with torch.random.fork_rng(devices=[]):
        torch.manual_seed(seed)
        root = CLIPTextEncoder(cfg).state_dict()
    others = [root, build_text_encoder(cfg, g_vivit).state_dict(),
              build_text_encoder(cfg, clip_stage_generators(seed + 1)[1]).state_dict()]
    for other in others:
        assert not torch.equal(other["token_embedding"], trained["token_embedding"])
    with init_from(torch.Generator().manual_seed(0)):
        a = torch.randn(3)
    with init_from(torch.Generator().manual_seed(0)):
        assert torch.equal(torch.randn(3), a)


@pytest.mark.parametrize("override,error", [
    ("mesh.data=2", NotImplementedError),
    ("mesh.model=2", NotImplementedError),
    ("torch_vivit_ckpt=/nonexistent.pt", FileNotFoundError),
])
def test_clip_entry_points_refuse_unported_options(tmp_path, override, error):
    args = write_clip_store(tmp_path, n=3)
    for main in (train_clip.main, eval_clip.main):
        with pytest.raises(error):
            main(args + [override])


def test_smoke_run_and_cuda_default(tmp_path):
    """smoke=true trains the synthetic corpus (16 clips, split 12 / 4, batch
    4, 2 epochs) on the tiny towers; with no device given the trainer asks
    for CUDA and raises without it."""
    s = train_clip.main(["smoke=true", "device=cpu", f"run_dir={tmp_path}"])
    assert s["trainer"].step == 6 and np.isfinite(s["val"]["loss"])
    assert s["trainer"].text_encoder.cfg == train_clip.SMOKE_TEXT
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ClipTrainer(ViViTConfig(**VIVIT), CLIPTextConfig(**TEXT))
