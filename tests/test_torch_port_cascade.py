"""The cascade_sr slice against the JAX package, on the CPU: the remat
policies, the three temporal-SR layers, the ``temporal_conv`` architecture,
the temporal ladder and a two-stage temporal+spatial SR cascade sample.

JAX parameters are drawn from a seeded normal over the modules' shapes
(``jax.eval_shape``) and carried across with ``weights.load_from_jax``;
inputs come from numpy. Everything is float32. Tolerances: 2e-5 on one
module's output of O(1) (same math, other summation orders); 2e-4 on a
unet's output (as tests/test_torch_port_modules.py, ~20 layers); gradients
1e-5 of the largest entry; 2e-3 on sampled videos in [0, 1] (as
tests/test_torch_port_slice.py: the first DDIM step multiplies the
forwards' f32 disagreement by ~1/sqrt(abar)).

The JAX side is jitted and compiled at XLA's lowest optimisation level
(``_jit``): a unet compiles in a few seconds that way, against ~20 s of
op-by-op compiles when run eagerly.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn
from torch.utils._python_dispatch import TorchDispatchMode

from dalle2_video_tpu.engine.conditioner import (
    LowresConditionerConfig as JaxLowresCfg,
    lowres_condition as jax_lowres_condition,
)
from dalle2_video_tpu.engine.decoder import (
    VideoDecoder as JaxDecoder,
    VideoDecoderConfig as JaxDecoderConfig,
)
from dalle2_video_tpu.models import layers as jlayers
from dalle2_video_tpu.models.unet3d import UNet3DConfig as JaxUCfg
from dalle2_video_tpu.models.unet3d import _remat_policy
from dalle2_video_tpu.models.unet_temporal import UnetTemporalConv as JaxTemporalConv
from dalle2_video_tpu.utils import keys as jkeys
from dalle2_video_tpu_torch.engine.conditioner import LowresConditionerConfig, lowres_condition
from dalle2_video_tpu_torch.engine.decoder import (
    VideoDecoder,
    VideoDecoderConfig,
    build_unet,
    cascade_sr_overrides,
)
from dalle2_video_tpu_torch.models import layers
from dalle2_video_tpu_torch.models.remat import POLICIES, checkpoint_block
from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.models.unet_temporal import UnetTemporalConv
from dalle2_video_tpu_torch.utils.config import load_config
from dalle2_video_tpu_torch.utils.keys import RowKeys
from dalle2_video_tpu_torch.weights import load_from_jax, params_from_jax

torch.set_num_threads(1)
UNET = dict(dim=8, dim_mults=(1, 2), num_resnet_blocks=1, attn_heads=2, attn_dim_head=8)


def draw(module, seed, *args, std=0.2, **kwargs):
    """The module's parameter tree with every leaf from N(0, std^2)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args, **kwargs)
    leaves, tree = jax.tree_util.tree_flatten(shapes)
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_unflatten(
        tree, [jnp.asarray(rng.standard_normal(l.shape) * std, jnp.float32) for l in leaves])


def _np(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


_O0 = {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True}


def _jit(fn, *args):
    """fn(*args), jitted and compiled at O0."""
    return jax.jit(fn).lower(*args).compile(compiler_options=_O0)(*args)


# ------------------------------------------------------------ remat policies
class _Count(TorchDispatchMode):
    """Counts aten ops by name."""

    def __init__(self):
        super().__init__()
        self.n = {}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        self.n[name] = self.n.get(name, 0) + 1
        return func(*args, **(kwargs or {}))


# what the backward of one conditioned ResnetBlock3D (res_conv included)
# replays of its forward's convolutions, matmuls and attention-output tag:
# jax's dots_saveable saves conv_general_dilated with dot_general, so
# "dots" replays no conv
REPLAYS = {
    "nothing": dict(conv=True, mm=True, bmm=True, attn=True),
    "dots": dict(conv=False, mm=False, bmm=False, attn=True),
    "dots_no_batch": dict(conv=True, mm=False, bmm=True, attn=True),
    "conv": dict(conv=False, mm=True, bmm=True, attn=True),
    "conv_attn": dict(conv=False, mm=True, bmm=True, attn=False),
    "conv_dots": dict(conv=False, mm=False, bmm=False, attn=True),
}


@pytest.fixture(scope="module")
def block():
    """A conditioned ResnetBlock3D (8 -> 16 channels, so it has its 1x1
    res_conv), its JAX parameters and inputs, and the JAX block's gradients
    under nn.remat with the cascade's policy "conv". JAX's policies change
    what it saves, not its arithmetic, so every port policy is held to
    these; the replay counts show that the port's policies differ."""
    x, t, c = _np(1, 2, 2, 4, 4, 8), _np(2, 2, 32), _np(3, 2, 3, 8)
    g_out = _np(4, 2, 2, 4, 4, 16)
    kw = dict(cond_dim=8, time_cond_dim=32, groups=4)
    params = draw(jlayers.ResnetBlock3D(16, **kw), 5, x, t, c)
    port = load_from_jax(layers.ResnetBlock3D(8, 16, **kw), params)
    jblk = jnn.remat(jlayers.ResnetBlock3D, policy=_remat_policy("conv"))(16, **kw)
    f = lambda p, x: jnp.sum(jblk.apply(p, x, t, c) * g_out)
    jp, jx = _jit(jax.grad(f, argnums=(0, 1)), params, jnp.asarray(x))
    want = {"x": torch.tensor(np.asarray(jx)), **params_from_jax(jp)}
    return dict(port=port, x=x, t=t, c=c, g_out=g_out, want=want)


def _port_block_grads(blk, b, policy):
    x = torch.from_numpy(b["x"]).requires_grad_()
    params = dict(blk.named_parameters())
    fn = lambda *a: torch.func.functional_call(blk, params, a)
    args = (x, torch.from_numpy(b["t"]), torch.from_numpy(b["c"]))
    out = fn(*args) if policy is None else checkpoint_block(fn, args, policy)
    blk.zero_grad(set_to_none=True)
    count = _Count()
    with count:
        (out * torch.from_numpy(b["g_out"])).sum().backward()
    return {"x": x.grad, **{k: p.grad for k, p in blk.named_parameters()}}, count.n


@pytest.mark.parametrize("policy", sorted(POLICIES))
def test_remat_policy_gradients_and_replays(block, policy):
    """Each policy: the block's gradients against the JAX block's (1e-5 of
    the largest entry), and what the backward replays of the forward's
    convs and matmuls, counted at the dispatcher against the same backward
    without remat."""
    b = block
    want = b["want"]
    got, ops = _port_block_grads(b["port"], b, policy)
    _, plain_ops = _port_block_grads(b["port"], b, None)
    assert set(got) == set(want)
    gmax = max(float(w.abs().max()) for w in want.values())
    for k, w in want.items():
        torch.testing.assert_close(got[k], w, atol=1e-5 * gmax, rtol=0, msg=k)
    replayed = {k: ops.get(k, 0) - plain_ops.get(k, 0)
                for k in ("convolution", "mm", "addmm", "bmm", "attn_out")}
    want_replay = REPLAYS[policy]
    # the two Block3D convs; the res_conv's backward reads only the block's
    # input and weight, leaves here, which the checkpoint keeps as they are
    assert replayed["convolution"] == (2 if want_replay["conv"] else 0), replayed
    assert (replayed["mm"] + replayed["addmm"] > 0) == want_replay["mm"], replayed
    assert (replayed["bmm"] > 0) == want_replay["bmm"], replayed
    assert replayed["attn_out"] == int(want_replay["attn"]), replayed


@pytest.mark.parametrize("policy", ["nothing", "conv", "dots"])
def test_remat_frames_are_freed_by_the_backward(block, policy):
    """A checkpointed block's recomputation state -- the saved op outputs
    and what the replay recomputed -- lives only until its backward has
    run: afterwards as many tensors are alive as after the same backward
    without remat."""
    import gc

    def live():
        gc.collect()
        return sum(1 for o in gc.get_objects() if type(o) in (torch.Tensor, torch.nn.Parameter))

    _port_block_grads(block["port"], block, None)
    plain = live()
    _port_block_grads(block["port"], block, policy)
    assert live() == plain


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        UNet3D(UNet3DConfig(**UNET, remat_policy="everything"))


def test_sr_unet_policies_give_the_unremat_gradients():
    """The memory-efficient SR unet, checkpointed under each policy, gives
    the gradients of the same unet without remat, bit for bit: the
    policies change what is saved and recomputed, never the arithmetic."""
    cfg = dict(UNET, memory_efficient=True, lowres_cond=True, video_embed_dim=8)
    torch.manual_seed(0)
    ref = UNet3D(UNet3DConfig(**cfg))
    torch.nn.init.normal_(ref.to_out.Conv_0.weight)
    x, lowres = torch.from_numpy(_np(6, 2, 2, 8, 8, 3)), torch.from_numpy(_np(7, 2, 2, 8, 8, 3))
    time = torch.tensor([3, 500])

    def grads(unet):
        out = unet(x, time, lowres_cond_video=lowres, enable_checkpoint=True)
        (out**2).mean().backward()
        return {k: p.grad for k, p in unet.named_parameters()}

    want = grads(ref)
    for policy in POLICIES:
        unet = UNet3D(UNet3DConfig(**cfg, checkpoint_during_training=True, remat_policy=policy))
        unet.load_state_dict(ref.state_dict())
        got = grads(unet)
        for k in want:
            assert torch.equal(got[k], want[k]), (policy, k)


# ------------------------------------------------- the temporal-SR layers
LAYERS = {
    "temporal_attention": (lambda: jlayers.TemporalAttention(8, heads=2, dim_head=8),
                           lambda: layers.TemporalAttention(8, heads=2, dim_head=8)),
    "linear_attention": (lambda: jlayers.LinearAttention(8, heads=2, dim_head=8),
                         lambda: layers.LinearAttention(8, heads=2, dim_head=8)),
    "nearest_upsample": (lambda: jlayers.NearestUpsample3D(4),
                         lambda: layers.NearestUpsample3D(8, 4)),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_temporal_sr_layer_matches_jax(name):
    jmod, pmod = LAYERS[name]
    x = _np(8, 2, 3, 4, 6, 8)
    params = draw(jmod(), 9, x)
    want = np.asarray(_jit(jmod().apply, params, jnp.asarray(x)))
    got = load_from_jax(pmod(), params)(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), want, atol=2e-5)


def test_temporal_conv_unet_with_the_temporal_sr_options_matches_jax():
    """arch temporal_conv (the frame-wise UNet3D and its zero-init temporal
    conv, redrawn here), its UNet3D with linear attention at the stages
    (sparse_attn), temporal attention after every attention site and
    nearest upsampling: one forward, 2e-4."""
    kw = dict(UNET, arch="temporal_conv", temporal_attention=True, sparse_attn=True,
              pixel_shuffle_upsample=False, cond_on_video_embeds=True, video_embed_dim=8)
    x, ve = _np(10, 2, 3, 8, 8, 3), _np(11, 2, 8)
    time = np.array([3, 500], np.int32)
    jmod = JaxTemporalConv(JaxUCfg(**kw))
    params = draw(jmod, 12, x, time, video_embed=ve)
    want = np.asarray(_jit(lambda p, x, t, v: jmod.apply(p, x, t, video_embed=v),
                           params, jnp.asarray(x), jnp.asarray(time), jnp.asarray(ve)))
    port = build_unet(UNet3DConfig(**kw))
    assert isinstance(port, UnetTemporalConv) and isinstance(port.unet2d, UNet3D)
    names = dict(port.named_modules())
    assert isinstance(names["unet2d.down0_attn"], layers.LinearAttention)
    assert isinstance(names["unet2d.mid_temporal_attn"], layers.TemporalAttention)
    assert isinstance(names["unet2d.up0_upsample"], layers.NearestUpsample3D)
    assert port.temporal_conv.conv.weight.shape == (3, 3, 3)  # (out, in, k) from (k, in, out)
    load_from_jax(port, params)
    with torch.no_grad():
        got = port(torch.from_numpy(x), torch.from_numpy(time).long(),
                   video_embed=torch.from_numpy(ve)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4)
    assert np.abs(want).max() > 0.1  # not vacuous: the redrawn output conv


# ------------------------------------------------------- the cascade
def test_temporal_ladder_matches_jax():
    """lowres_condition of the cascade's ladder, 16 -> 64 frames (and its
    64 -> 16 downsample), and the tiny tests' 2 -> 4, nearest in time and
    space, blur on: 1e-6 on [0, 1]."""
    for frames, size in (((16, 64), (8, 16)), ((2, 4), (8, 16))):
        video = np.random.default_rng(13).random((1, frames[1], size[1], size[1], 3)).astype(np.float32)
        kw = dict(target_frame_size=size[1], downsample_frame_size=size[0],
                  target_frame_number=frames[1], downsample_frame_number=frames[0])
        want, _ = _jit(lambda k, v: jax_lowres_condition(k, v, JaxLowresCfg(blur_prob=1.0), **kw),
                       jax.random.PRNGKey(1), jnp.asarray(video))
        got, _ = lowres_condition(torch.from_numpy(video), LowresConditionerConfig(blur_prob=1.0),
                                  blur=True, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_cascade_recipe_overrides_name_the_bench_recipe():
    cfg = load_config("configs/cascade_sr.yaml", cascade_sr_overrides())
    assert cfg["sample_timesteps"] == [64, 64] and cfg["flash_attention_sampling"] is True
    assert cfg["sample_compute_dtype"] == "bfloat16"
    assert cfg["unet2"] == dict(dim=32, dim_mults=[1, 2, 4, 8], num_resnet_blocks=2,
                                attn_heads=16, attn_dim_head=32, memory_efficient=True,
                                checkpoint_during_training=True, remat_policy="conv",
                                attention_impl="auto")
    assert cfg["frame_numbers"] == [16, 64] and cfg["frame_sizes"] == [64, 128]


def test_two_stage_cascade_sample_matches_jax():
    """The cascade at tiny widths: stage 1 (2 frames, 8 px) then the
    memory-efficient temporal+spatial SR stage (4 frames, 16 px, remat conv,
    attention auto), DDIM 2 + 2 with CFG 3.0. The port runs the recipe's
    knobs (flash attention when sampling: its plain version on the CPU);
    both sides in f32 -- JAX with its xla attention, the same math as its
    flash kernel, which does not run on the CPU. x_T of each stage is the
    JAX run's, from its key tree."""
    unet1 = dict(UNET, dim_mults=(1,), video_embed_dim=8)
    unet2 = dict(UNET, video_embed_dim=8, memory_efficient=True, checkpoint_during_training=True,
                 remat_policy="conv", attention_impl="auto")
    dec = dict(frame_sizes=(8, 16), frame_numbers=(2, 4), timesteps=1000,
               sample_timesteps=(2, 2), learned_variance=False)
    jdec = JaxDecoder(JaxDecoderConfig(unets=(JaxUCfg(**unet1), JaxUCfg(**unet2)), **dec))
    params = draw(type("P", (), {"init": lambda self, k: jdec.init_params(k)})(), 14, std=0.15)
    port = VideoDecoder(VideoDecoderConfig(
        unets=(UNet3DConfig(**unet1), UNet3DConfig(**unet2)), **dec,
        flash_attention_sampling=True), device="cpu")
    for i, unet in enumerate(port.unets):
        load_from_jax(unet, params[f"unet_{i}"])
    b = 2
    embed = _np(15, b, 8)
    prev_j = prev_p = None
    for i, key in enumerate((jax.random.PRNGKey(20), jax.random.PRNGKey(21))):
        frames, size = dec["frame_numbers"][i], dec["frame_sizes"][i]
        _, k_loop = jkeys.split(key)
        k_init, _ = jkeys.split(k_loop)
        x_t = np.array(jkeys.normal(k_init, (b, frames, size, size, 3)))
        want = _jit(lambda p, k, e, pv, i=i: jdec.sample_stage(
            i, p, k, batch_size=b, prev_video=pv, video_embed=e, cond_scale=3.0),
            params, key, jnp.asarray(embed), prev_j)
        got = port.sample_stage(i, RowKeys([0, 1]), batch_size=b, prev_video=prev_p,
                                video_embed=torch.from_numpy(embed), cond_scale=3.0,
                                init_noise=torch.from_numpy(x_t))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3, err_msg=f"stage {i}")
        prev_j, prev_p = want, torch.from_numpy(np.asarray(want))
    assert got.shape == (b, 4, 16, 16, 3)
    inside = (np.asarray(want) > 0.0) & (np.asarray(want) < 1.0)
    assert int(inside.sum()) > 100  # not vacuous: values strictly inside the clip
