"""The port's modules against the JAX package on shared weights.

JAX parameters (initialised, then every leaf redrawn from a seeded normal so
that zero-initialised convs and biases are exercised too) are carried
across with ``weights.load_from_jax``; the same numpy inputs go through
both forwards. The JAX side runs its plain (xla) paths: its Pallas paths do
not interpret inside the modules on the CPU.

Tolerance 2e-4 absolute on outputs of magnitude ~1-10, as
tests/test_torch_import_unet.py uses for the unet: float32 on both sides,
with convolutions and matmuls summed in different orders through ~20
layers.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dalle2_video_tpu.models.clip_text import (
    CLIPTextConfig as JaxCLIPConfig,
    CLIPTextEncoder as JaxCLIP,
)
from dalle2_video_tpu.models.prior import (
    DiffusionPriorNetwork as JaxPriorNet,
    PriorNetworkConfig as JaxPriorCfg,
)
from dalle2_video_tpu.models.unet3d import UNet3D as JaxUNet, UNet3DConfig as JaxUCfg
from dalle2_video_tpu_torch.models.clip_text import CLIPTextConfig, CLIPTextEncoder
from dalle2_video_tpu_torch.models.prior import DiffusionPriorNetwork, PriorNetworkConfig
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.weights import load_from_jax, params_from_jax

torch.set_num_threads(1)
ATOL = 2e-4


# the JAX references are jitted and compiled at XLA's lowest optimisation
# level: less compile time, the same f32 arithmetic
_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _o0(fn, *args, **kwargs):
    return jax.jit(fn).lower(*args, **kwargs).compile(compiler_options=_O0)(*args, **kwargs)


def redraw(params, seed, std=0.2):
    """Every leaf (arrays or shape structs) redrawn from N(0, std^2)."""
    leaves, tree = jax.tree_util.tree_flatten(params)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [(rng.standard_normal(l.shape) * std).astype(np.float32) for l in leaves])


UNET = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=2,
            attn_dim_head=8, channels=3)
CASES = {
    # base unet: video-embed tokens + add-to-time, CFG keep mask (row 1 null)
    "base": dict(cond_on_video_embeds=True, video_embed_dim=16),
    # SR unet: lowres conditioning video + Imagen noise-level conditioning
    "sr": dict(lowres_cond=True, lowres_noise_cond=True),
    # stage attention and a 3-stage ladder
    "stage_attn": dict(cond_on_video_embeds=True, video_embed_dim=8,
                       dim_mults=(1, 2, 2), self_attn=(False, True, True)),
    # memory-efficient layout, upsample combiner, scaled skips
    "memory_efficient": dict(cond_on_video_embeds=True, video_embed_dim=8,
                             memory_efficient=True, combine_upsample_fmaps=True,
                             scale_skip_connection=True),
    # cross-embed downsample (even kernels, stride 2), plain stem, self-cond,
    # cosine-sim attention, identity video tokens (embed dim == cond dim)
    "cross_embed": dict(cond_on_video_embeds=True, video_embed_dim=8,
                        cross_embed_downsample=True, init_cross_embed=False,
                        self_cond=True, cosine_sim_cross_attn=True,
                        cosine_sim_self_attn=True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_unet3d_forward_matches_jax(case):
    kw = dict(UNET, **CASES[case])
    rng = np.random.default_rng(0)
    b, t, s = 2, 2, 16
    x = rng.standard_normal((b, t, s, s, 3)).astype(np.float32)
    time = np.array([3, 500], np.int32)
    jargs, targs = {}, {}
    if kw.get("cond_on_video_embeds"):
        ve = rng.standard_normal((b, kw["video_embed_dim"])).astype(np.float32)
        keep = np.array([True, False])
        jargs.update(video_embed=jnp.asarray(ve), video_keep_mask=jnp.asarray(keep))
        targs.update(video_embed=torch.from_numpy(ve), video_keep_mask=torch.from_numpy(keep))
    if kw.get("self_cond"):
        sc = rng.standard_normal((b, t, s, s, 3)).astype(np.float32)
        jargs.update(self_cond=jnp.asarray(sc))
        targs.update(self_cond=torch.from_numpy(sc))
    if kw.get("lowres_cond"):
        lr = rng.random((b, t, s, s, 3)).astype(np.float32)
        jargs.update(lowres_cond_video=jnp.asarray(lr),
                     lowres_noise_level=jnp.asarray([200, 200], jnp.int32))
        targs.update(lowres_cond_video=torch.from_numpy(lr),
                     lowres_noise_level=torch.tensor([200, 200]))
    ju = JaxUNet(JaxUCfg(**kw))
    # shapes only: init is traced abstractly, then every leaf is redrawn
    shapes = jax.eval_shape(ju.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(time), **jargs)
    params = redraw(shapes, 1)
    want = np.asarray(_o0(ju.apply, params, jnp.asarray(x), jnp.asarray(time), **jargs))
    tu = load_from_jax(UNet3D(UNet3DConfig(**kw)), params)
    with torch.no_grad():
        got = tu(torch.from_numpy(x), torch.from_numpy(time).long(), **targs).numpy()
    assert got.shape == want.shape == (b, t, s, s, 3)
    np.testing.assert_allclose(got, want, atol=ATOL * max(1.0, np.abs(want).max() / 10))


def test_unet3d_kernel_impls_match_plain_on_cpu():
    """impl knobs flash / pallas / flash on a CPU tensor route to the plain
    versions: same numbers as the xla model on the same weights."""
    kw = dict(UNET, cond_on_video_embeds=True, video_embed_dim=16)
    plain = UNet3D(UNet3DConfig(**kw))
    fast = UNet3D(UNet3DConfig(**kw, attention_impl="flash", groupnorm_impl="pallas",
                               cross_attention_impl="flash"))
    fast.load_state_dict(plain.state_dict())
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 2, 16, 16, 3)).astype(np.float32))
    ve = torch.from_numpy(rng.standard_normal((1, 16)).astype(np.float32))
    t = torch.tensor([10])
    with torch.no_grad():
        torch.testing.assert_close(fast(x, t, video_embed=ve), plain(x, t, video_embed=ve),
                                   atol=1e-5, rtol=0)


@pytest.mark.parametrize("module", ["attention", "cross_attention"])
def test_bf16_plain_attention_matches_jax_in_bf16(module):
    """The plain (xla) Attention and CrossAttention in bf16 against the JAX
    modules in bf16 on shared weights: both compute the products and the
    softmax in the activation dtype, so the outputs agree but for rare
    one-rounding flips -- at most 1% of the values differ, none by more
    than 2^-7 of the output's scale. A port that upcast q, k, v to f32
    differs in ~60-75% of the values, by up to 2% of the scale. The JAX side
    runs op by op: under jit, XLA's fusions keep some bf16 intermediates in
    f32 and ~10% of the values flip by one rounding."""
    from dalle2_video_tpu.models.layers import Attention as JaxAttn, CrossAttention as JaxXAttn
    from dalle2_video_tpu_torch.models import layers

    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 300, 64)).astype(np.float32)
    ctx = rng.standard_normal((2, 6, 32)).astype(np.float32)
    if module == "attention":
        jm, tm, args = JaxAttn(64, heads=4, dim_head=16), layers.Attention(64, 4, 16), (x,)
    else:
        jm = JaxXAttn(64, context_dim=32, heads=4, dim_head=16)
        tm, args = layers.CrossAttention(64, 32, heads=4, dim_head=16), (x, ctx)
    params = redraw(jax.eval_shape(jm.init, jax.random.PRNGKey(0), *map(jnp.asarray, args)),
                    3, std=0.5)
    bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    want = np.asarray(jm.apply(bf16, *(jnp.asarray(a, jnp.bfloat16) for a in args))
                      .astype(jnp.float32))
    tm = load_from_jax(tm, params).to(torch.bfloat16)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a).bfloat16() for a in args)).float().numpy()
    assert np.mean(got != want) <= 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=2**-7 * np.abs(want).max())


def test_prior_network_matches_jax():
    """depth-2 causal transformer with rotary, rel-pos bias, SwiGLU and the
    CFG null text embed (row 1 dropped)."""
    kw = dict(dim=32, depth=2, heads=2, dim_head=16)
    rng = np.random.default_rng(4)
    b = 2
    x = rng.standard_normal((b, 32)).astype(np.float32)
    te = rng.standard_normal((b, 32)).astype(np.float32)
    time = np.array([7, 900], np.int32)
    keep = np.array([True, False])
    jn = JaxPriorNet(JaxPriorCfg(**kw))
    params = redraw(jax.eval_shape(jn.init, jax.random.PRNGKey(1), jnp.asarray(x),
                                   jnp.asarray(time), text_embed=jnp.asarray(te)), 2)
    want = np.asarray(_o0(jn.apply, params, jnp.asarray(x), jnp.asarray(time),
                          text_embed=jnp.asarray(te), text_keep_mask=jnp.asarray(keep)))
    tn = load_from_jax(DiffusionPriorNetwork(PriorNetworkConfig(**kw)), params)
    with torch.no_grad():
        got = tn(torch.from_numpy(x), torch.from_numpy(time).long(),
                 text_embed=torch.from_numpy(te), text_keep_mask=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL)


def test_clip_text_tower_matches_jax():
    from dalle2_video_tpu_torch.data.tokenizer import tokenize

    cfg = dict(width=32, heads=2, layers=2, embed_dim=16)
    tokens = tokenize(["a person smiling", "someone talks"])
    jt = JaxCLIP(JaxCLIPConfig(**cfg))
    params = redraw(jax.eval_shape(jt.init, jax.random.PRNGKey(2), jnp.asarray(tokens)),
                    3, std=0.1)
    want_e, want_x = _o0(lambda p, t: jt.apply(p, t, return_encodings=True),
                         params, jnp.asarray(tokens))
    tt = load_from_jax(CLIPTextEncoder(CLIPTextConfig(**cfg)), params)
    with torch.no_grad():
        got_e, got_x = tt(torch.from_numpy(tokens), return_encodings=True)
    np.testing.assert_allclose(got_e.numpy(), np.asarray(want_e), atol=ATOL)
    np.testing.assert_allclose(got_x.numpy(), np.asarray(want_x), atol=ATOL)


def test_port_tokenizer_matches_jax_tokenizer():
    from dalle2_video_tpu.data.tokenizer import tokenize as jax_tokenize
    from dalle2_video_tpu_torch.data.tokenizer import tokenize

    texts = ["A person  SMILING &amp; talking", "x" * 200, ""]
    np.testing.assert_array_equal(tokenize(texts), jax_tokenize(texts))


def test_bridge_layouts_and_strictness():
    tree = {"params": {
        "dense": {"kernel": np.arange(6, dtype=np.float32).reshape(2, 3)},
        "conv": {"kernel": np.zeros((3, 3, 4, 5), np.float32),
                 "bias": np.zeros(5, np.float32)},
        "norm": {"scale": np.ones(4, np.float32)},
        "null_kv": np.ones((2, 8), np.float32),
    }}
    sd = params_from_jax(tree)
    assert sd["dense.weight"].shape == (3, 2)  # Dense (in, out) -> (out, in)
    assert sd["dense.weight"][2, 1] == 5.0
    assert sd["conv.weight"].shape == (5, 4, 3, 3)  # HWIO -> OIHW
    assert set(sd) == {"dense.weight", "conv.weight", "conv.bias", "norm.weight", "null_kv"}
    unet = UNet3D(UNet3DConfig(**UNET))
    with pytest.raises(ValueError, match="missing"):
        load_from_jax(unet, {"params": {"init_conv": {}}})
