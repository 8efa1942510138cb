"""Text-encoding and per-frame conditioning against the JAX package: row 5's
plain version over long contexts and its bf16 hold past 16 keys, UNet3D's
text tokens and per-frame video tokens, the decoder's samplers and loss
with text encodings (negatives, chunking, the text keep draw), the prior's
encoding tokens, DALLE2Video's temporal_emb mode and its refusals, a train
step with grad_accum 2, the strict bridge between global and per-frame
trees, and long video with text.

Recipe of tests/test_torch_port_requests.py: JAX parameters redrawn from a
seeded normal and carried across with ``weights.load_from_jax``; inputs from
numpy seeds; the JAX programs compiled at XLA's lowest optimisation level;
every JAX draw recomputed from its key tree and injected into the port.

Tolerances: the f32 unets 2e-6 absolute and the f32 samples 2e-5 (at these
widths the two agree to ~2e-7, and the text moves the outputs by 1e-4 and
more: each test checks that it does); the prior network 2e-4 (the modules
file's); row 5's f32 plain version 2e-5 (the kernels file's); bf16 row 5
at most 0.5% of the values differing, none by more than one bf16 step of
the output's scale; the bf16 unet one bf16 step of the output's scale;
losses 5e-5 relative, gradients 1e-5 of the largest entry (the train
file's); prior embeds 5e-4 (the slice file's); a train step's parameters
2e-3 of the learning rate.
"""

from __future__ import annotations

import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dalle2_video_tpu.engine.dalle2video import DALLE2Video as JaxD2V
from dalle2_video_tpu.engine.decoder import (
    VideoDecoder as JaxDecoder,
    VideoDecoderConfig as JaxDecoderConfig,
    ddim_time_pairs,
)
from dalle2_video_tpu.models.prior import DiffusionPrior as JaxPrior
from dalle2_video_tpu.models.prior import DiffusionPriorConfig as JaxPriorConfig
from dalle2_video_tpu.models.prior import PriorNetworkConfig as JaxPriorNetCfg
from dalle2_video_tpu.models.unet3d import UNet3D as JaxUNet
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.ops.pallas import cross_attention as jax_xattn
from dalle2_video_tpu.train import DecoderTrainer as JaxTrainer
from dalle2_video_tpu.train import DecoderTrainerConfig as JaxTrainerConfig
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.engine.dalle2video import DALLE2Video
from dalle2_video_tpu_torch.engine.decoder import VideoDecoder, VideoDecoderConfig
from dalle2_video_tpu_torch.engine.longvideo import generate_long_video
from dalle2_video_tpu_torch.models.prior import (
    DiffusionPrior,
    DiffusionPriorConfig,
    PriorNetworkConfig,
)
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.ops import cross_attention as port_xattn
from dalle2_video_tpu_torch.probes import xattn_rows
from dalle2_video_tpu_torch.train import DecoderTrainer, DecoderTrainerConfig
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import load_from_jax, load_train_state_from_jax, params_from_jax

torch.set_num_threads(1)
CPU = torch.device("cpu")

D = 16  # video embed and prior dim
E = 12  # text encoding width
L = 6  # the unets' max_text_len
# one stage: its two middle blocks are the conditioned sites (they take
# mid_c, the time, video and text tokens); no middle self-attention, to
# keep the JAX programs small
UNET = dict(dim=8, dim_mults=(1,), num_resnet_blocks=0, attn_heads=2, attn_dim_head=8,
            resnet_groups=4, init_cross_embed=False, init_conv_ksize=3, video_embed_dim=D,
            cond_on_text_encodings=True, text_embed_dim=E, max_text_len=L,
            attend_at_middle=False)
# one stage of 2 frames at 8 px, DDIM 2 steps, v-prediction (a random unet
# keeps most values inside the clip)
STAGE = dict(frame_sizes=(8,), frame_numbers=(2,), timesteps=10, sample_timesteps=(2,),
             learned_variance=False, predict_v=True)
PRIOR_NET = dict(dim=D, depth=1, heads=2, dim_head=8, cond_on_text_encodings=True,
                 text_encoding_dim=E)
N_CAND = 2
COND_SCALE = 3.0
ATOL = 2e-5
LR = 1e-3

_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


def redraw(tree, seed, std):
    """The tree's leaves drawn from a seeded normal, as numpy f32 arrays."""
    leaves, td = jax.tree_util.tree_flatten(tree)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        td, [(rng.standard_normal(l.shape) * std).astype(np.float32) for l in leaves])


def t_(a):
    return torch.from_numpy(np.array(a))


def _encodings(b, n, seed, zero_tokens=((0, -1),)):
    """(b, n, E) encodings with the (row, token) pairs ``zero_tokens`` all
    zero (padding, masked by both packages)."""
    enc = np.random.default_rng(seed).standard_normal((b, n, E)).astype(np.float32)
    for r, tok in zero_tokens:
        enc[r, tok] = 0.0
    return enc


def _decoders(per_frame: bool):
    """A JAX text-conditioned decoder with redrawn parameters (global or
    per-frame embeds) and the port's on the same weights."""
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**UNET),), **STAGE))
    params = redraw(jax.eval_shape(lambda k: jdec.init_params(k, per_frame_embeds=per_frame),
                                   jax.random.PRNGKey(0)), 1, 0.15)
    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),), **STAGE), device=CPU,
                       per_frame_embeds=per_frame)
    load_from_jax(dec.unets[0], params["unet_0"])
    return jdec, params, dec


_cache = {}


def _cached(name, fn):
    if name not in _cache:
        _cache[name] = fn()
    return _cache[name]


def _prior():
    def make():
        cfg = dict(network=PRIOR_NET, sample_timesteps=2)
        jprior = JaxPrior(JaxPriorConfig(**{**cfg, "network": JaxPriorNetCfg(**PRIOR_NET)}))
        params = redraw(jax.eval_shape(jprior.init_params, jax.random.PRNGKey(1)), 2, 0.3)
        prior = DiffusionPrior(DiffusionPriorConfig(**{**cfg,
                                                      "network": PriorNetworkConfig(**PRIOR_NET)}),
                               device=CPU)
        load_from_jax(prior.network, params)
        return jprior, params, prior
    return _cached("prior", make)


def _stage_draws(rng, shape, n_steps):
    """A DDIM stage's x_T from its stage key (sample_stage -> the loop; eta
    0 draws no step noise)."""
    _, k_loop = jkeys.split(rng)
    k_init, _ = jkeys.split(k_loop)
    return jkeys.normal(k_init, shape)


def _decoder_draws(rng, b):
    """decoder.sample's per-stage x_T (one stage)."""
    (k,) = jkeys.split(rng, 1)
    n = len(ddim_time_pairs(STAGE["timesteps"], STAGE["sample_timesteps"][0]))
    return [_stage_draws(k, (b, STAGE["frame_numbers"][0], 8, 8, 3), n)]


def replay(fn, rng, *static):
    return jax.tree_util.tree_map(t_, _jit(lambda r: fn(r, *static), rng))


def _hold(got, want, atol=ATOL):
    assert got.shape == want.shape
    assert np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0
    np.testing.assert_allclose(got, want, atol=atol)
    assert int(((want > 0.0) & (want < 1.0)).sum()) > 0.5 * want.size  # off the clip


def _hold_bf16_share(got, want, share):
    differ = got != want
    assert differ.mean() <= share, f"{differ.mean():.2%} of the bf16 values differ"
    gap = float(np.abs(got - want).max())
    assert gap <= 2.0**-7 * np.abs(want).max(), f"largest gap {gap:.3e}"


# ------------------------------------------------------------------- row 5
@pytest.mark.parametrize("m", [17, 93, 263])  # past the short route; frame tokens; text
def test_row5_plain_over_long_contexts_matches_the_jax_kernel(m):
    """fused_cross_attention_reference (what the wrapper runs for a CPU
    tensor, and the card's kernel is held to) against the JAX kernel in
    interpret mode at m keys, 300 queries (not a multiple of block_n): f32
    within 2e-5; bf16 at most 0.5% of the outputs differ, none by more than
    2^-7 of the largest |output| (p rounds to bf16 after f32 sums in
    another order)."""
    rng = np.random.default_rng(m)
    b, n, h, d = 1, 300, 2, 64
    q, k, v = (rng.standard_normal((b, s, h, d)).astype(np.float32) for s in (n, m, m))
    dtypes = ((jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16))
    # both dtypes in one program
    wants = _jit(lambda q, k, v: [jax_xattn.cross_attention(
        q.astype(jdt), k.astype(jdt), v.astype(jdt), sm_scale=d**-0.5, block_n=128,
        interpret=True).astype(jnp.float32) for jdt, _ in dtypes],
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for (_, tdt), want in zip(dtypes, wants):
        got = port_xattn.cross_attention(*(t_(a).to(tdt) for a in (q, k, v)),
                                         sm_scale=d**-0.5).float().numpy()
        if tdt == torch.float32:
            np.testing.assert_allclose(got, np.asarray(want), atol=2e-5)
        else:
            _hold_bf16_share(got, np.asarray(want), 5e-3)


@pytest.mark.parametrize("m", [93, 349])
def test_row5_bf16_hold_over_long_contexts(m):
    """The card's bf16 row-5 check (xattn_rows.hold_bf16) past 16 keys, on
    the CPU: the JAX kernel's function in another f32 order (the logits in
    16-channel steps as the tensor cores take them, p v key by key) passes
    it; an online softmax that rounds p against a running max and sum (16
    keys a tile, as a flash kernel would) fails it, and so does p left
    unrounded."""
    g = torch.Generator().manual_seed(m)
    q, k, v = (torch.randn(2, s, 8, 64, generator=g).to(torch.bfloat16) for s in (128, m, m))
    sc = 64**-0.5
    ref = port_xattn.fused_cross_attention_reference(q, k, v, sc)
    s = sum(torch.einsum("bnhd,bmhd->bhnm", q[..., i:i + 16].float(), k[..., i:i + 16].float())
            for i in range(0, 64, 16)) * sc
    e = torch.exp(s - s.amax(-1, keepdim=True))
    p = (e / e.sum(-1, keepdim=True)).to(torch.bfloat16).float().transpose(1, 2)
    vf = v.float()
    other = sum(p[..., j, None] * vf[:, j:j + 1] for j in range(m)).to(torch.bfloat16)
    res = xattn_rows.hold_bf16(other, ref, q, k, v, sc)
    assert res["worst_share"] <= 1.0 and res["steps"] <= 1.0
    run_max = torch.full(s.shape[:-1], -torch.inf)
    run_sum = torch.zeros(s.shape[:-1])
    acc = torch.zeros(2, 8, 128, 64)
    for j in range(0, m, 16):
        st = s[..., j:j + 16]
        new_max = torch.maximum(run_max, st.amax(-1))
        alpha = torch.exp(run_max - new_max)
        pt = torch.exp(st - new_max[..., None]).to(torch.bfloat16).float()
        run_sum = run_sum * alpha + pt.sum(-1)
        acc = acc * alpha[..., None] + pt @ vf[:, j:j + 16].transpose(1, 2)
        run_max = new_max
    online = (acc / run_sum[..., None]).transpose(1, 2).to(torch.bfloat16)
    unrounded = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(s, -1), vf).to(torch.bfloat16)
    for wrong in (online, unrounded):
        with pytest.raises(AssertionError):
            xattn_rows.hold_bf16(wrong, ref, q, k, v, sc)


# ------------------------------------------------------------------ UNet3D
def _interpret_flash():
    """The JAX flash cross-attention with its Pallas kernel in interpret
    mode (as the CPU runs it)."""
    orig = jax_xattn.fused_cross_attention
    return mock.patch.object(jax_xattn, "fused_cross_attention",
                             lambda q, k, v, sm_scale, block_n=1024, interpret=False: orig(
                                 q, k, v, sm_scale=sm_scale, block_n=block_n, interpret=True))


def _unet_of(per_frame: bool, flash: bool = False):
    """(JAX module, its params, the port's unet on the same weights): the
    cached decoders' unet 1, or for ``flash`` a unet of the same config on
    the flash cross-attention route (the global decoder's weights)."""
    jdec, params, dec = (_cached("per_frame", lambda: _decoders(True)) if per_frame
                         else _cached("global", lambda: _decoders(False)))
    if not flash:
        return jdec.unets[0], params["unet_0"], dec.unets[0]
    cfg = dataclasses.replace(dec.unet_configs[0], cross_attention_impl="flash")
    jcfg = JaxUCfg(**dataclasses.asdict(cfg))
    return (JaxUNet(jcfg), params["unet_0"],
            load_from_jax(UNet3D(cfg), params["unet_0"]).to(torch.bfloat16))


def _unet_run(jm, params, tm, dtype, x, t, embed, enc, vkeep, tkeep):
    """The JAX unet (jitted in ``dtype``, compiled once for the module and
    shapes) and the port's on the same inputs."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    args = [jax.tree_util.tree_map(lambda a: a.astype(jdt), params),
            *(jnp.asarray(a) for a in (x, t, embed, enc, vkeep, tkeep))]
    fn = _cached((id(jm), dtype, enc.shape, embed.shape), lambda: jax.jit(
        lambda p, x, t, e, c, vk, tk: jm.apply(
            p, x.astype(jdt), t, video_embed=e.astype(jdt), text_encodings=c.astype(jdt),
            video_keep_mask=vk, text_keep_mask=tk).astype(jnp.float32)).lower(*args).compile(
        compiler_options=_O0))
    want = fn(*args)
    with torch.no_grad():
        got = tm(t_(x).to(tdt), t_(t).long(), video_embed=t_(embed).to(tdt),
                 text_encodings=t_(enc).to(tdt), video_keep_mask=t_(vkeep),
                 text_keep_mask=t_(tkeep)).float().numpy()
    return got, np.asarray(want)


def _unet_inputs(seed, embed_shape):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, 2, 8, 8, 3)).astype(np.float32), np.array([3, 7], np.int32),
            rng.standard_normal(embed_shape).astype(np.float32))


@pytest.mark.parametrize("case", ["f32", "bf16 flash"])
def test_unet_text_conditioning_matches_jax(case):
    """UNet3D with 4 tokens of text encodings (zero-padded to max_text_len
    6; an all-zero token) against the jitted JAX module (9 tokens, cut to
    6: the per-frame test); a row whose text the keep mask drops and a row
    whose video embed it drops. f32 within 2e-6, and the text moves the
    output by far more. bf16 on the flash route (the JAX kernel in
    interpret mode): the two frameworks round their bf16 programs apart all
    through the network (10-14% of the output values differ here), each
    value by at most one bf16 step of the output's scale, which the test
    holds."""
    n = 4
    flash = case == "bf16 flash"
    jm, params, tm = _unet_of(False, flash)
    x, t, embed = _unet_inputs(11, (2, D))
    enc = _encodings(2, n, 12, zero_tokens=((0, 1), (1, -1)))
    vkeep, tkeep = np.array([True, False]), np.array([False, True])
    with _interpret_flash():
        got, want = _unet_run(jm, params, tm, "bfloat16" if flash else "float32", x, t, embed,
                              enc, vkeep, tkeep)
    if flash:
        _hold_bf16_share(got, want, 0.25)
        return
    np.testing.assert_allclose(got, want, atol=2e-6)
    with torch.no_grad():
        other = tm(t_(x), t_(t).long(), video_embed=t_(embed),
                   text_encodings=t_(_encodings(2, n, 99)), video_keep_mask=t_(vkeep),
                   text_keep_mask=t_(tkeep))
    assert np.abs(other.numpy() - got).max() > 2e-5  # not vacuous: 10x the tolerance


def test_per_frame_video_embeds_match_jax():
    """A unet built for per-frame embeds (the JAX init_params(per_frame_embeds=
    True) tree): one token a frame plus the frame's sinusoidal position, the
    mean over frames added to the time embedding, the learned null token
    where the video keep mask drops a row; text encodings of 9 tokens, cut
    to max_text_len 6; f32 within 2e-6. Reversing the
    frames changes the kept row's output (the order is part of the
    conditioning) on both sides alike, and not the dropped row's. Either
    unet refuses the other kind of embed."""
    jm, params, tm = _unet_of(True)
    x, t, embed = _unet_inputs(13, (2, 3, D))
    enc = _encodings(2, 9, 14)
    vkeep, tkeep = np.array([True, False]), np.array([True, True])
    got, want = _unet_run(jm, params, tm, "float32", x, t, embed, enc, vkeep, tkeep)
    np.testing.assert_allclose(got, want, atol=2e-6)
    rgot, rwant = _unet_run(jm, params, tm, "float32", x, t, embed[:, ::-1].copy(), enc, vkeep,
                            tkeep)
    np.testing.assert_allclose(rgot, rwant, atol=2e-6)
    assert np.abs(rgot[0] - got[0]).max() > 2e-5
    np.testing.assert_array_equal(rgot[1], got[1])
    with pytest.raises(ValueError, match="per_frame_embeds=False"):
        tm(t_(x), t_(t).long(), video_embed=t_(embed[:, 0]), text_encodings=t_(enc))
    with pytest.raises(ValueError, match="per_frame_embeds=True"):
        _unet_of(False)[2](t_(x), t_(t).long(), video_embed=t_(embed), text_encodings=t_(enc))


# ------------------------------------------------------------- the decoder
def test_decoder_sample_with_text_and_negative_text_matches_jax():
    """decoder.sample (DDIM, CFG 3) with 9 tokens of text encodings (cut to
    max_text_len 6; an all-zero token) and negative text encodings
    broadcast from (1, n, E) as the text stream's CFG baseline,
    chunked by max_batch_size=2 over 3 rows: each row keeps its key, so it
    equals the JAX package's unchunked run with per-row keys. Without the
    negative the baseline is the learned null (another video); without
    encodings a text-conditioned decoder refuses, and a decoder without
    text refuses them."""
    jdec, params, dec = _cached("global", lambda: _decoders(False))
    b = 3
    rng_np = np.random.default_rng(15)
    embed = rng_np.standard_normal((b, D)).astype(np.float32)
    enc = _encodings(b, 9, 16, zero_tokens=((1, 3),))
    neg = _encodings(1, 9, 17, zero_tokens=())
    rng = jkeys.batch_keys([4, 5, 6])
    inits = replay(_decoder_draws, rng, b)
    want = np.asarray(_jit(lambda p, k, e, c, n: jdec.sample(
        p, k, video_embed=e, text_encodings=c, cond_scale=COND_SCALE,
        negative_text_encodings=n), params, rng, *(jnp.asarray(a) for a in (embed, enc, neg))))
    kw = dict(video_embed=t_(embed), text_encodings=t_(enc), cond_scale=COND_SCALE,
              init_noises=inits)
    got = dec.sample(RowKeys([4, 5, 6]), max_batch_size=2, negative_text_encodings=t_(neg),
                     **kw).numpy()
    _hold(got, want)
    plain = dec.sample(RowKeys([4, 5, 6]), **kw).numpy()
    assert np.abs(plain - got).max() > 2e-4
    with pytest.raises(ValueError, match="text encodings must be passed"):
        dec.sample(RowKeys([4, 5, 6]), video_embed=t_(embed))
    no_text = VideoDecoder(VideoDecoderConfig(
        unets=(UNet3DConfig(**dict(UNET, cond_on_text_encodings=False)),), **STAGE), device=CPU)
    with pytest.raises(ValueError, match="not conditioned on text"):
        no_text.sample(RowKeys([4, 5, 6]), video_embed=t_(embed), text_encodings=t_(enc))


def _loss_draws(jdec, rng, shape):
    """Every draw decoder.loss makes from ``rng`` (decoder.py:533,
    :600-613) for a base-unet stage, as the port's ``draws`` (one compiled
    program for all keys)."""
    cfg = jdec.config

    def draws(rng):
        k_t, _, _, k_loss = jax.random.split(rng, 4)
        k_noise, k_vmask, k_tmask, _ = jax.random.split(k_loss, 4)
        return {"times": jax.random.randint(k_t, (shape[0],), 0, cfg.timesteps, dtype=jnp.int32),
                "noise": jax.random.normal(k_noise, shape, jnp.float32),
                "video_keep": jax.random.bernoulli(k_vmask, 1.0 - cfg.video_cond_drop_prob,
                                                   (shape[0],)),
                "text_keep": jax.random.bernoulli(k_tmask, 1.0 - cfg.text_cond_drop_prob,
                                                  (shape[0],))}

    fn = _cached(("draws", shape), lambda: jax.jit(draws))
    return {k: t_(v) for k, v in fn(rng).items()}


def _loss_inputs(b, seed):
    rng = np.random.default_rng(seed)
    return (rng.random((b, 2, 8, 8, 3)).astype(np.float32),
            rng.standard_normal((b, 3, D)).astype(np.float32),
            _encodings(b, 5, seed + 1, zero_tokens=((0, 2),)))


def _loss_fn(jdec, params):
    """The JAX decoder.loss and its gradients, compiled once (per-frame
    embeds and text encodings)."""
    def make():
        fn = jax.value_and_grad(lambda p, k, v, e, c: jdec.loss(
            {**params, "unet_0": p}, k, v, video_embed=e, text_encodings=c, unet_number=1))
        args = (params["unet_0"], jax.random.PRNGKey(0),
                *(jnp.asarray(a) for a in _loss_inputs(2, 20)))
        return jax.jit(fn).lower(*args).compile(compiler_options=_O0)
    return _cached("loss_fn", make)


def _pack(tree):
    """A parameter tree's leaves as {"matrix": the >= 2-dim ones flattened
    into one (1, N) matrix, "vector": the rest in one vector}."""
    leaves = [np.asarray(a) for a in jax.tree_util.tree_leaves(tree)]
    return {"matrix": np.concatenate([a.ravel() for a in leaves if a.ndim >= 2])[None],
            "vector": np.concatenate([a.ravel() for a in leaves if a.ndim < 2])}


def _unpack(packed, like):
    """_pack's inverse, shaped as the tree ``like``."""
    leaves, td = jax.tree_util.tree_flatten(like)
    flat = {k: np.asarray(v).ravel() for k, v in packed.items()}
    at = {"matrix": 0, "vector": 0}
    out = []
    for a in leaves:
        k = "matrix" if a.ndim >= 2 else "vector"
        out.append(flat[k][at[k]:at[k] + a.size].reshape(a.shape))
        at[k] += a.size
    return jax.tree_util.tree_unflatten(td, out)


def _find_key(jdec, shape, want, start=0):
    for seed in range(start, start + 100):
        rng = jax.random.PRNGKey(seed)
        d = _loss_draws(jdec, rng, shape)
        if want(d):
            return rng, d
    raise AssertionError("no key gives the wanted draws")


def _hold_grads(grads, unet):
    """Every port gradient against the JAX one: 1e-5 of the largest entry
    (2e-3 relative). A parameter no site uses (norm_cond: a one-stage unet
    attends only at its middle blocks, which take mid_c) has no port
    gradient and a zero JAX one."""
    want = params_from_jax(grads)
    own = dict(unet.named_parameters())
    assert set(want) == set(own)
    gmax = max(float(w.abs().max()) for w in want.values())
    for name, w in want.items():
        g = own[name].grad
        if g is None:
            assert name.startswith("norm_cond.") and float(w.abs().max()) == 0.0, name
            continue
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2e-3, atol=1e-5 * gmax,
                                   err_msg=name)
    return own


def test_loss_grads_and_a_train_step_with_grad_accum_2_match_jax():
    """decoder.loss with per-frame embeds and text encodings, then one
    DecoderTrainer step with grad_accum 2 on 4 rows (the videos, embeds and
    encodings split into microbatches of 2), against the JAX package.

    The loss: jax.value_and_grad of the JAX decoder.loss at the first
    microbatch's key, every draw (times, noise, the video and text keep
    masks) replayed, the key found so that one row's text is kept and the
    other's dropped: loss 5e-5 relative, gradients as _hold_grads; the
    gradient reaches text_to_cond, null_text_embed and the per-frame
    token's Dense.

    The step: the JAX trainer's train_step taken piece by piece as its
    grad_accum branch computes it (trainer.py:178-217): each microbatch's
    value_and_grad at its key of jax.random.split(rng, 2), the mean of the
    gradients and of the losses, then the trainer's own optax chain (clip
    0.5, Adam, decoupled weight decay, lr) and EMA update from a fresh
    TrainState (jitted apart: the whole JAX step takes ~20 s to compile
    here). The port starts from that TrainState through the bridge (zero
    Adam moments, the EMA shadow). Loss 1e-5 relative; the new parameters
    and the EMA shadow within 2e-3 of the learning rate (eps 1e-3 keeps
    Adam's first step smooth in the gradient)."""
    from dalle2_video_tpu.train.ema import ema_init as jax_ema_init
    from dalle2_video_tpu.train.ema import ema_update as jax_ema_update

    jdec, params, _ = _cached("per_frame", lambda: _decoders(True))
    video, embed, enc = _loss_inputs(4, 21)
    micro = lambda a, j: a[2 * j:2 * j + 2]  # noqa: E731
    loss_fn = _loss_fn(jdec, params)
    draws, keys = [], []
    for j, want in enumerate(([True, False], None)):
        key, d = _find_key(jdec, (2, 2, 8, 8, 3), lambda d: want is None or (
            d["text_keep"].tolist() == want and bool(d["video_keep"].all())), start=100 * j)
        keys.append(key)
        draws.append(d)
    losses, grads = zip(*(loss_fn(params["unet_0"], k, *(jnp.asarray(micro(a, j))
                                                        for a in (video, embed, enc)))
                          for j, k in enumerate(keys)))

    dec = VideoDecoder(VideoDecoderConfig(unets=(UNet3DConfig(**UNET),), **STAGE), device=CPU,
                       per_frame_embeds=True)
    load_from_jax(dec.unets[0], params["unet_0"])
    got = dec.loss(t_(micro(video, 0)), video_embed=t_(micro(embed, 0)),
                   text_encodings=t_(micro(enc, 0)), draws=draws[0])
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(losses[0]), rtol=5e-5)
    own = _hold_grads(grads[0], dec.unets[0])
    for name in ("text_to_cond.weight", "null_text_embed", "video_frame_to_token.weight"):
        assert float(own[name].grad.abs().max()) > 0, name
    dec.unets[0].zero_grad(set_to_none=True)

    jtrainer = JaxTrainer(jdec, JaxTrainerConfig(lr=LR, eps=1e-3, grad_accum=2))

    def jax_step(g0, g1, p):
        g = jax.tree_util.tree_map(lambda a, b: (a + b) / 2, g0, g1)
        tx = jtrainer.optimizers[0]
        updates, _ = tx.update(g, tx.init(p), p)
        new_p = optax.apply_updates(p, updates)
        return new_p, jax_ema_update(jax_ema_init(p), new_p, jtrainer.cfg.ema).params

    # the chain and the EMA act leaf by leaf, the weight-decay mask by the
    # leaf's rank and the clip on the global norm: on the leaves regrouped
    # into two (the >= 2-dim ones as one matrix, the rest as one vector)
    # they compute the same numbers in a program that compiles in a second
    new_params, new_ema = (_unpack(a, params["unet_0"]) for a in _jit(
        jax_step, *(_pack(g) for g in grads), _pack(params["unet_0"])))
    zeros = jax.tree_util.tree_map(np.zeros_like, params)
    state = {"params": params,
             "opt_states": [{"mu": zeros["unet_0"], "nu": zeros["unet_0"], "count": 0}],
             "ema": [{"params": params["unet_0"], "step": 0}], "steps": [0]}
    trainer = DecoderTrainer(dec, DecoderTrainerConfig(lr=LR, eps=1e-3, grad_accum=2))
    load_train_state_from_jax(trainer, state)
    got = trainer.train_step(t_(video), video_embed=t_(embed), text_encodings=t_(enc),
                             draws=draws)
    np.testing.assert_allclose(float(got), float(sum(losses)) / 2, rtol=1e-5)
    assert trainer.steps == [1] and trainer.update_count(0) == 1 and trainer.ema[0].step == 1
    own = trainer.params(0)
    for name, w in params_from_jax(new_params).items():
        assert float((own[name].detach() - w).abs().max()) <= 2e-3 * LR, name
    for name, w in params_from_jax(new_ema).items():
        assert float((trainer.ema[0].params[name] - w).abs().max()) <= 2e-3 * LR, name


def test_bridge_is_strict_between_global_and_per_frame_trees():
    """A per-frame JAX tree does not load into a global unet, nor a global
    tree into a per-frame unet: each misses the other's video-token
    parameters (video_to_tokens / null_video_embed against
    video_frame_to_token / null_video_frame_token); each loads into its own
    kind, the text parameters with it."""
    _, global_params, global_dec = _cached("global", lambda: _decoders(False))
    _, frame_params, frame_dec = _cached("per_frame", lambda: _decoders(True))
    for tree, unet in ((frame_params, global_dec.unets[0]), (global_params, frame_dec.unets[0])):
        with pytest.raises(ValueError, match="missing") as err:
            load_from_jax(unet, tree["unet_0"])
        assert "video" in str(err.value)
    for tree, unet in ((global_params, global_dec.unets[0]), (frame_params, frame_dec.unets[0])):
        load_from_jax(unet, tree["unet_0"])
    own = dict(frame_dec.unets[0].named_parameters())
    assert {"text_to_cond.weight", "null_text_embed", "null_video_frame_token"} <= set(own)
    assert own["null_text_embed"].shape == (1, L, UNET["dim"])


# --------------------------------------------------------------- the prior
def test_prior_network_and_loss_with_encodings_match_jax():
    """The prior network with encoding tokens against the JAX network at 80
    tokens (projected, cut to max_text_len 77, not padded: 81 tokens in all;
    an all-zero token and a dropped row take null_text_encodings), f32
    within 2e-4; and prior.loss at 5 tokens (5 + 4 in all) with its draws
    (times, noise, keep) replayed, 5e-5 relative."""
    jprior, params, prior = _prior()
    rng = np.random.default_rng(30)
    b = 3
    x, te = (rng.standard_normal((b, D)).astype(np.float32) for _ in range(2))
    enc = _encodings(b, 80, 31, zero_tokens=((0, 0), (2, 76)))
    t = np.array([0, 4, 9], np.int32)
    keep = np.array([True, False, True])
    key = jax.random.PRNGKey(5)

    def jax_side(p, x, t, te, c, k, key):
        # the network at 80 tokens, the loss at 5, and the loss's draws
        # (prior.py:392-401), in one program
        out = jprior.network.apply(p, x, t, text_embed=te, text_encodings=c, text_keep_mask=k)
        k_t, k_n, k_drop, _ = jax.random.split(key, 4)
        draws = {"times": jprior.schedule.sample_random_times(k_t, b),
                 "noise": jax.random.normal(k_n, (b, D)),
                 "text_keep": jax.random.bernoulli(k_drop, 1.0 - 0.1, (b,))}
        return out, jprior.loss(p, key, x, te, text_encodings=c[:, :5]), draws

    want, jloss, draws = jax.tree_util.tree_map(t_, _jit(
        jax_side, params, *(jnp.asarray(a) for a in (x, t, te, enc, keep)), key))
    with torch.no_grad():
        got = prior.network(t_(x), t_(t).long(), text_embed=t_(te), text_encodings=t_(enc),
                            text_keep_mask=t_(keep))
        ploss = prior.loss(t_(x), t_(te), t_(enc[:, :5]), draws=draws)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-4)
    np.testing.assert_allclose(float(ploss), float(jloss), rtol=5e-5)


def _prior_noise(k_prior, rows, batched):
    """The prior's best-of-N x_T from its key: per-row keys fold candidate j
    in (prior.py:576-584), a single key draws the whole (rows * N, d)."""
    if batched:
        k_prior = jax.vmap(lambda k: jnp.stack([jax.random.fold_in(k, j)
                                                for j in range(N_CAND)]))(k_prior)
        k_prior = k_prior.reshape((rows * N_CAND,) + k_prior.shape[2:])
    k_init, _ = jkeys.split(k_prior)
    return jkeys.normal(k_init, (rows * N_CAND, D))


# ------------------------------------------------------------- the wrapper
def test_generate_temporal_emb_matches_jax():
    """DALLE2Video.generate in temporal_emb mode: a (b, d, t) text embed
    through the prior as b * t rows (transposed, flattened; the encodings
    repeated per row with repeat_interleave), best-of-2 with CFG, reshaped
    to (b, t, d) per-frame embeds for the decoder, which also takes the
    encodings. One key for the request, as JAX's temporal_emb requires;
    every draw (the prior's x_T over 8 candidates, the decoder's x_T)
    replayed."""
    jdec, dparams, dec = _cached("per_frame", lambda: _decoders(True))
    jprior, pparams, prior = _prior()
    b, t = 2, STAGE["frame_numbers"][0]
    rng_np = np.random.default_rng(50)
    te = rng_np.standard_normal((b, D, t)).astype(np.float32)
    enc = _encodings(b, 5, 51)
    rng = jax.random.PRNGKey(52)
    k_prior, k_dec = jax.random.split(rng)
    prior_z, inits = replay(lambda k, b: (_prior_noise(k[0], b * t, False),
                                          _decoder_draws(k[1], b)),
                            jnp.stack([k_prior, k_dec]), b)
    want = np.asarray(_jit(lambda pp, dp, k, e, c: JaxD2V(
        jprior, jdec, temporal_emb=True, prior_num_samples=N_CAND).generate(
        pp, dp, k, e, text_encodings=c, cond_scale=COND_SCALE, prior_cond_scale=2.0),
        pparams, dparams, rng, jnp.asarray(te), jnp.asarray(enc)))
    wrapper = DALLE2Video(prior, dec, temporal_emb=True, prior_num_samples=N_CAND)
    got = wrapper.generate(RowKeys([52]), t_(te), t_(enc), cond_scale=COND_SCALE,
                           prior_cond_scale=2.0, prior_init_noise=prior_z,
                           decoder_init_noises=inits).numpy()
    _hold(got, want)


def test_wrapper_refusals_match_jax():
    """temporal_emb refuses per-row keys, negative prompts and generate_long
    with the JAX package's messages; a negative prompt with a prior that
    takes text encodings fails in JAX (its negative prior pass has none) and
    is refused in the port before the prior runs."""
    jdec, dparams, dec = _cached("per_frame", lambda: _decoders(True))
    jprior, pparams, prior = _prior()
    te = np.zeros((2, D, 2), np.float32)
    enc = _encodings(2, 3, 60)
    neg = np.zeros((1, D), np.float32)
    jw = JaxD2V(jprior, jdec, temporal_emb=True)
    pw = DALLE2Video(prior, dec, temporal_emb=True)
    cases = [(dict(rng=jkeys.batch_keys([1, 2])), dict(keys=RowKeys([1, 2]))),
             (dict(negative_text_embed=jnp.asarray(neg)), dict(negative_text_embed=t_(neg)))]
    for jkw, pkw in cases:
        with pytest.raises(ValueError) as jerr:
            jw.generate(pparams, dparams, jkw.pop("rng", jax.random.PRNGKey(0)),
                        jnp.asarray(te), text_encodings=jnp.asarray(enc), **jkw)
        with pytest.raises(ValueError) as perr:
            pw.generate(pkw.pop("keys", RowKeys([1])), t_(te), t_(enc), **pkw)
        assert str(perr.value) == str(jerr.value)
    with pytest.raises(ValueError) as jerr:
        jw.generate_long(pparams, dparams, jax.random.PRNGKey(0), jnp.asarray(te), n_frames=3)
    with pytest.raises(ValueError) as perr:
        pw.generate_long(RowKeys([1]), t_(te), n_frames=3)
    assert str(perr.value) == str(jerr.value)
    # a negative prompt with a text-encoding prior (global embeds)
    jdec_g, dparams_g, dec_g = _cached("global", lambda: _decoders(False))
    te2 = np.zeros((2, D), np.float32)
    with pytest.raises(AssertionError, match="no text_encodings"):
        jax.eval_shape(lambda pp, dp, k, e, c, n: JaxD2V(jprior, jdec_g).generate(
            pp, dp, k, e, text_encodings=c, cond_scale=COND_SCALE, negative_text_embed=n),
            pparams, dparams_g, jkeys.batch_keys([1, 2]), jnp.asarray(te2), jnp.asarray(enc),
            jnp.asarray(neg))
    with mock.patch.object(prior, "sample", side_effect=AssertionError("sampled")):
        with pytest.raises(ValueError, match="negative prompting needs a prior without"):
            DALLE2Video(prior, dec_g).generate(RowKeys([1, 2]), t_(te2), t_(enc),
                                               cond_scale=COND_SCALE, negative_text_embed=t_(neg))


def test_long_video_passes_text_to_every_window():
    """generate_long_video with text encodings and negative text encodings:
    every window's decoder.sample takes both, and the first window is the
    plain cascade sample from the first of the window keys."""
    _, _, dec = _cached("global", lambda: _decoders(False))
    rng_np = np.random.default_rng(70)
    embed = rng_np.standard_normal((2, D)).astype(np.float32)
    enc, neg = t_(_encodings(2, 4, 71)), t_(_encodings(1, 4, 72, zero_tokens=()))
    seen = []
    orig = dec.sample

    def sample(keys, **kw):
        seen.append((kw["text_encodings"], kw["negative_text_encodings"]))
        return orig(keys, **kw)

    with mock.patch.object(dec, "sample", side_effect=sample):
        video = generate_long_video(dec, RowKeys([1, 2]), n_frames=3, overlap=1,
                                    video_embed=t_(embed), text_encodings=enc,
                                    negative_text_encodings=neg, cond_scale=COND_SCALE)
    assert video.shape == (2, 3, 8, 8, 3) and len(seen) == 2
    assert all(a is enc and n is neg for a, n in seen)
    first = dec.sample(RowKeys([1, 2]).split(2)[0], video_embed=t_(embed), text_encodings=enc,
                       negative_text_encodings=neg, cond_scale=COND_SCALE)
    np.testing.assert_array_equal(video[:, :2].numpy(), first.numpy())
