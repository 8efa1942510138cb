"""UNet3D, the video denoiser (port of dalle2_video_tpu/models/unet3d.py).

``UNet3DConfig`` has the JAX config's fields, and the module tree keeps its
names (``init_conv``, ``time_cond``, ``down{i}_block{j}``, ``mid_attn``,
``up{i}_upsample``, ``final_resnet_block``, ``to_out`` ...), so one config
builds the same model in both packages and ``weights.params_from_jax`` maps
one onto the other. Input/output layout (B, T, H, W, C).

Training: ``forward(..., enable_checkpoint=True)`` with
``checkpoint_during_training`` rematerialises every ResnetBlock3D under its
``remat_policy`` (``models/remat.py``), the counterpart of the JAX
``nn.remat(ResnetBlock3D, policy=...)``: "nothing" saves nothing inside a
block and runs its whole forward again in the backward, kernels included;
"conv" keeps every conv output, so the recomputation runs only what lies
between the convs; and so on. The output conv starts at zero.

``sparse_attn`` (LinearAttention at stages without self-attention),
``temporal_attention`` (TemporalAttention after each attention site) and
``pixel_shuffle_upsample=False`` (NearestUpsample3D) are the JAX options;
``engine/decoder.build_unet`` also builds the ``temporal_conv``
architecture (``models/unet_temporal.py``).

Conditioning (JAX unet3d.py:296-374): the time tokens; the video embed,
added to the time embedding and as ``num_video_tokens`` tokens, or, for a
unet built with ``per_frame_embeds=True`` (the JAX
``init_params(per_frame_embeds=True)``: flax creates the parameters of the
input it is initialised on, the port at construction), a (b, k, d) embed,
one token a frame plus a sinusoidal position over the frame index, its
mean added to the time embedding; and the text encodings
(``cond_on_text_encodings``): ``text_to_cond``, cut or zero-padded to
``max_text_len``, tokens whose encoding is all zero (or whose row the text
keep mask drops) swapped for ``null_text_embed``, attended to only at the
middle blocks (``mid_c``). Each unet refuses the other kind of video embed.

The opt-in conv paths are the JAX knobs: ``groupnorm_impl: fused`` (the
fused Block3D kernels at qualifying sites, the plain conv and GroupNorm
elsewhere) and ``spatial_conv_impl: pallas_small`` (the conv kernel at the
small 3x3 Block3D sites); see ``layers.fused_site`` and
``layers.pallas_small_site``.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple, Union

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle2_video_tpu_torch.models.layers import (
    CrossEmbedLayer3D,
    Dense,
    Downsample3D,
    JointSpaceTimeAttention,
    LayerNorm,
    LinearAttention,
    NearestUpsample3D,
    PixelShuffleUpsample3D,
    ResnetBlock3D,
    SpatialConv,
    TemporalAttention,
    TimeConditioning,
    UpsampleCombiner,
    sinusoidal_pos_emb,
)
from dalle2_video_tpu_torch.models.remat import checkpoint_block, saved_ops
from dalle2_video_tpu_torch.ops.as_jax import gelu_as_jax


def _cast_tuple(v, length: int) -> Tuple:
    if isinstance(v, (tuple, list)):
        if len(v) != length:
            raise ValueError(f"expected {length} entries, got {v}")
        return tuple(v)
    return (v,) * length


@dataclasses.dataclass(frozen=True)
class UNet3DConfig:
    """Same fields and defaults as dalle2_video_tpu.models.UNet3DConfig."""

    dim: int = 64
    video_embed_dim: Optional[int] = None
    text_embed_dim: Optional[int] = None
    cond_dim: Optional[int] = None
    num_video_tokens: int = 4
    num_time_tokens: int = 2
    out_dim: Optional[int] = None
    dim_mults: Tuple[int, ...] = (1, 2, 4, 8)
    channels: int = 3
    channels_out: Optional[int] = None
    self_attn: Union[bool, Tuple[bool, ...]] = False
    attn_dim_head: int = 32
    attn_heads: int = 16
    lowres_cond: bool = False
    lowres_noise_cond: bool = False
    self_cond: bool = False
    sparse_attn: bool = False
    cosine_sim_cross_attn: bool = False
    cosine_sim_self_attn: bool = False
    attend_at_middle: bool = True
    cond_on_text_encodings: bool = False
    max_text_len: int = 256
    cond_on_video_embeds: bool = False
    add_video_embeds_to_time: bool = True
    init_dim: Optional[int] = None
    init_conv_ksize: int = 7
    resnet_groups: Union[int, Tuple[int, ...]] = 8
    num_resnet_blocks: Union[int, Tuple[int, ...]] = 2
    init_cross_embed: bool = True
    init_cross_embed_kernel_sizes: Tuple[int, ...] = (3, 7, 15)
    cross_embed_downsample: bool = False
    cross_embed_downsample_kernel_sizes: Tuple[int, ...] = (2, 4)
    memory_efficient: bool = False
    scale_skip_connection: bool = False
    pixel_shuffle_upsample: bool = True
    final_conv_ksize: int = 1
    combine_upsample_fmaps: bool = False
    checkpoint_during_training: bool = False
    remat_policy: str = "nothing"
    joint_time_attention: bool = True
    # "xla" | "flash" | "auto" (flash on CUDA from 4096 joint tokens) |
    # "sp" (the token axis split over the active mesh's model axis:
    # parallel/sp_attention.py; the auto rule where no such mesh is active
    # or the tokens do not divide over it)
    attention_impl: str = "xla"
    # "xla" | "pallas" (the fused GroupNorm-FiLM-SiLU CUDA kernel) |
    # "fused" (conv + bias + GroupNorm + FiLM + SiLU kernels)
    groupnorm_impl: str = "xla"
    # "xla" | "pallas_small" (the 3x3 conv kernel at small-spatial sites)
    spatial_conv_impl: str = "xla"
    # "xla" | "flash" (the tiny-context cross-attention CUDA kernel)
    cross_attention_impl: str = "xla"
    temporal_attention: bool = False
    arch: str = "unet3d"

    def cast_for_cascade(self, *, lowres_cond: bool, lowres_noise_cond: bool,
                         channels: int, channels_out: int,
                         cond_on_video_embeds: bool,
                         cond_on_text_encodings: bool) -> "UNet3DConfig":
        return dataclasses.replace(
            self, lowres_cond=lowres_cond, lowres_noise_cond=lowres_noise_cond,
            channels=channels, channels_out=channels_out,
            cond_on_video_embeds=cond_on_video_embeds,
            cond_on_text_encodings=cond_on_text_encodings,
        )

    @property
    def num_stages(self) -> int:
        return len(self.dim_mults)

    @property
    def resolved_cond_dim(self) -> int:
        return self.cond_dim if self.cond_dim is not None else self.dim

    @property
    def time_cond_dim(self) -> int:
        return self.dim * 4

    @property
    def resolved_init_dim(self) -> int:
        return self.init_dim if self.init_dim is not None else self.dim

    @property
    def resolved_channels_out(self) -> int:
        return self.channels_out if self.channels_out is not None else self.channels

    @property
    def stage_dims(self) -> Tuple[Tuple[int, int], ...]:
        dims = [self.resolved_init_dim, *(self.dim * m for m in self.dim_mults)]
        return tuple(zip(dims[:-1], dims[1:]))


def _check_ported(cfg: UNet3DConfig) -> None:
    if cfg.arch not in ("unet3d", "temporal_conv"):
        raise ValueError(f"unknown arch {cfg.arch!r}")
    saved_ops(cfg.remat_policy)  # unknown policy names raise, as in JAX
    if cfg.cond_on_video_embeds and cfg.video_embed_dim is None:
        raise ValueError("cond_on_video_embeds needs video_embed_dim")
    if cfg.cond_on_text_encodings and cfg.text_embed_dim is None:
        raise ValueError("cond_on_text_encodings needs text_embed_dim")


class UNet3D(nn.Module):
    """See module docstring. ``per_frame_embeds`` builds the per-frame
    video-embed parameters in place of the global ones."""

    def __init__(self, cfg: UNet3DConfig, per_frame_embeds: bool = False):
        super().__init__()
        _check_ported(cfg)
        self.cfg = cfg
        self.per_frame_embeds = per_frame_embeds
        cond_dim = cfg.resolved_cond_dim
        tcd = cfg.time_cond_dim
        init_dim = cfg.resolved_init_dim
        in_out = cfg.stage_dims
        n_st = len(in_out)
        self_attn = _cast_tuple(cfg.self_attn, n_st)
        groups_per = _cast_tuple(cfg.resnet_groups, n_st)
        nblocks_per = _cast_tuple(cfg.num_resnet_blocks, n_st)
        self._nblocks = nblocks_per

        def resnet(d_in, d_out, groups, cond=None):
            return ResnetBlock3D(
                d_in, d_out, cond_dim=cond, time_cond_dim=tcd, groups=groups,
                cosine_sim_cross_attn=cfg.cosine_sim_cross_attn,
                norm_impl=cfg.groupnorm_impl, attn_impl=cfg.cross_attention_impl,
                conv_impl=cfg.spatial_conv_impl,
            )

        def stage_attn(d):
            return JointSpaceTimeAttention(
                d, heads=cfg.attn_heads, dim_head=cfg.attn_dim_head,
                cosine_sim=cfg.cosine_sim_self_attn,
                joint_time=cfg.joint_time_attention, impl=cfg.attention_impl,
            )

        def add_stage_attn(name, d, sa):
            # self-attention, else linear attention (sparse_attn), then the
            # temporal attention; the JAX module names
            if sa:
                self.add_module(f"{name}_attn", stage_attn(d))
            elif cfg.sparse_attn:
                self.add_module(f"{name}_attn", LinearAttention(
                    d, heads=cfg.attn_heads, dim_head=cfg.attn_dim_head))
            if cfg.temporal_attention:
                self.add_module(f"{name}_temporal_attn", TemporalAttention(
                    d, heads=cfg.attn_heads, dim_head=cfg.attn_dim_head,
                    cosine_sim=cfg.cosine_sim_self_attn))

        def downsample(d_in, d_out):
            if cfg.cross_embed_downsample:
                return CrossEmbedLayer3D(
                    d_in, d_out, cfg.cross_embed_downsample_kernel_sizes, stride=2)
            return Downsample3D(d_in, d_out)

        in_ch = cfg.channels * (1 + int(cfg.self_cond) + int(cfg.lowres_cond))
        if cfg.init_cross_embed:
            self.init_conv = CrossEmbedLayer3D(
                in_ch, init_dim, cfg.init_cross_embed_kernel_sizes)
        else:
            self.init_conv = SpatialConv(in_ch, init_dim, cfg.init_conv_ksize)
        self.time_cond = TimeConditioning(cfg.dim, cond_dim, tcd, cfg.num_time_tokens)
        if cfg.lowres_noise_cond:
            self.lowres_dense1 = Dense(cfg.dim, tcd)
            self.lowres_dense2 = Dense(tcd, tcd)
        if cfg.cond_on_video_embeds:
            ve = cfg.video_embed_dim
            if cfg.add_video_embeds_to_time:
                self.to_video_hiddens = Dense(ve, tcd)
                self.null_video_hiddens = nn.Parameter(torch.randn(1, tcd))
            if per_frame_embeds:
                self.video_frame_to_token = Dense(ve, cond_dim)
                self.null_video_frame_token = nn.Parameter(torch.randn(1, 1, cond_dim))
            else:
                if ve != cond_dim:
                    self.video_to_tokens = Dense(ve, cond_dim * cfg.num_video_tokens)
                self.null_video_embed = nn.Parameter(
                    torch.randn(1, cfg.num_video_tokens, cond_dim))
        if cfg.cond_on_text_encodings:
            self.text_to_cond = Dense(cfg.text_embed_dim, cond_dim)
            self.null_text_embed = nn.Parameter(torch.randn(1, cfg.max_text_len, cond_dim))
        self.norm_cond = LayerNorm(cond_dim)
        self.norm_mid_cond = LayerNorm(cond_dim)

        x_ch = init_dim
        if cfg.memory_efficient:
            self.init_resnet_block = resnet(init_dim, init_dim, groups_per[0])
        skips: List[int] = []
        for ind, ((d_in, d_out), groups, nb, sa) in enumerate(
                zip(in_out, groups_per, nblocks_per, self_attn)):
            is_first, is_last = ind == 0, ind >= n_st - 1
            layer_cond = cond_dim if not is_first else None
            d_layer = d_out if cfg.memory_efficient else d_in
            if cfg.memory_efficient:
                self.add_module(f"down{ind}_pre", downsample(x_ch, d_out))
                x_ch = d_out
            self.add_module(f"down{ind}_init_block", resnet(x_ch, d_layer, groups))
            x_ch = d_layer
            for j in range(nb):
                self.add_module(f"down{ind}_block{j}",
                                resnet(d_layer, d_layer, groups, layer_cond))
                skips.append(d_layer)
            add_stage_attn(f"down{ind}", d_layer, sa)
            skips.append(d_layer)
            if not is_last and not cfg.memory_efficient:
                self.add_module(f"down{ind}_post", downsample(d_layer, d_out))
            else:
                self.add_module(f"down{ind}_post", SpatialConv(d_layer, d_out, 1))
            x_ch = d_out

        mid = in_out[-1][1]
        self.mid_block1 = resnet(mid, mid, groups_per[-1], cond_dim)
        if cfg.attend_at_middle:
            add_stage_attn("mid", mid, True)
        self.mid_block2 = resnet(mid, mid, groups_per[-1], cond_dim)

        up_dims = []
        for ind, ((d_in, d_out), groups, nb, sa) in enumerate(zip(
                reversed(in_out), reversed(groups_per), reversed(nblocks_per),
                reversed(self_attn))):
            is_last = ind >= n_st - 1
            layer_cond = cond_dim if not is_last else None
            self.add_module(f"up{ind}_init_block",
                            resnet(x_ch + skips.pop(), d_out, groups, layer_cond))
            x_ch = d_out
            for j in range(nb):
                self.add_module(f"up{ind}_block{j}",
                                resnet(x_ch + skips.pop(), d_out, groups, layer_cond))
            add_stage_attn(f"up{ind}", d_out, sa)
            up_dims.append(d_out)
            if not is_last or cfg.memory_efficient:
                upsample = (PixelShuffleUpsample3D if cfg.pixel_shuffle_upsample
                            else NearestUpsample3D)
                self.add_module(f"up{ind}_upsample", upsample(d_out, d_in))
                x_ch = d_in

        self.upsample_combiner = UpsampleCombiner(
            cfg.dim, up_dims, enabled=cfg.combine_upsample_fmaps)
        if self.upsample_combiner.enabled:
            x_ch += len(up_dims) * cfg.dim
        self.final_resnet_block = resnet(x_ch + init_dim, cfg.dim, groups_per[0])
        out_in = cfg.dim + (cfg.channels if cfg.lowres_cond else 0)
        self.to_out = SpatialConv(out_in, cfg.resolved_channels_out, cfg.final_conv_ksize,
                                  zero_init=True)

    def forward(
        self,
        x: torch.Tensor,
        time: torch.Tensor,
        *,
        video_embed: Optional[torch.Tensor] = None,
        lowres_cond_video: Optional[torch.Tensor] = None,
        lowres_noise_level: Optional[torch.Tensor] = None,
        text_encodings: Optional[torch.Tensor] = None,
        video_keep_mask: Optional[torch.Tensor] = None,
        text_keep_mask: Optional[torch.Tensor] = None,
        self_cond: Optional[torch.Tensor] = None,
        enable_checkpoint: bool = False,
    ) -> torch.Tensor:
        cfg = self.cfg
        b = x.shape[0]
        n_st = cfg.num_stages
        remat = (cfg.checkpoint_during_training and enable_checkpoint
                 and torch.is_grad_enabled())

        def block(name, *args):
            mod = getattr(self, name)
            if not remat:
                return mod(*args)
            # the recompute runs in the backward, after any functional_call
            # around this forward has restored the module's own parameters:
            # hand it the tensors this forward used (e.g. the trainer's bf16
            # casts of the f32 masters)
            params = dict(mod.named_parameters())
            return checkpoint_block(lambda *a: torch.func.functional_call(mod, params, a),
                                    args, cfg.remat_policy)

        def attend(name, x):
            # the stage's attention (self or linear), then its temporal one
            for n in (f"{name}_attn", f"{name}_temporal_attn"):
                if hasattr(self, n):
                    x = getattr(self, n)(x)
            return x

        if video_keep_mask is None:
            video_keep_mask = torch.ones(b, dtype=torch.bool, device=x.device)
        if text_keep_mask is None:
            text_keep_mask = torch.ones(b, dtype=torch.bool, device=x.device)

        if cfg.self_cond:
            x = torch.cat([x, self_cond if self_cond is not None else torch.zeros_like(x)], -1)
        if cfg.lowres_cond:
            if lowres_cond_video is None:
                raise ValueError("lowres conditioning video required")
            x = torch.cat([x, lowres_cond_video.to(x.dtype)], dim=-1)

        x = self.init_conv(x)
        r = x
        time_tokens, t = self.time_cond(time)

        if cfg.lowres_noise_cond:
            if lowres_noise_level is None:
                raise ValueError("lowres_noise_level required")
            ln = sinusoidal_pos_emb(lowres_noise_level, cfg.dim)
            t = t + self.lowres_dense2(gelu_as_jax(self.lowres_dense1(ln)))

        c = time_tokens
        if cfg.cond_on_video_embeds:
            if video_embed is None:
                raise ValueError("video_embed required")
            per_frame = video_embed.ndim == 3
            if per_frame != self.per_frame_embeds:
                raise ValueError(
                    f"a {'(b, k, d)' if per_frame else '(b, d)'} video embed needs a unet built "
                    f"with per_frame_embeds={per_frame} (JAX init_params(per_frame_embeds=...))")
            keep = video_keep_mask[:, None]
            if cfg.add_video_embeds_to_time:
                ve = video_embed.float().mean(1).to(video_embed.dtype) if per_frame else video_embed
                vh = gelu_as_jax(self.to_video_hiddens(ve))
                t = t + torch.where(keep, vh, self.null_video_hiddens.to(vh.dtype))
            if per_frame:
                # one token a frame embed, plus a sinusoidal position over the
                # frame index: the frames' order is part of the conditioning
                vt = self.video_frame_to_token(video_embed)
                pos = sinusoidal_pos_emb(
                    torch.arange(video_embed.shape[1], device=x.device), cfg.resolved_cond_dim)
                vt = torch.where(keep[:, :, None], vt + pos[None].to(vt.dtype),
                                 self.null_video_frame_token)
            else:
                if hasattr(self, "video_to_tokens"):
                    vt = self.video_to_tokens(video_embed).reshape(
                        b, cfg.num_video_tokens, cfg.resolved_cond_dim)
                else:
                    vt = video_embed[:, None, :].expand(
                        b, cfg.num_video_tokens, cfg.resolved_cond_dim)
                vt = torch.where(keep[:, :, None], vt, self.null_video_embed.to(vt.dtype))
            c = torch.cat([c, vt.to(c.dtype)], dim=1)
        mid_c = c
        if cfg.cond_on_text_encodings:
            if text_encodings is None:
                raise ValueError("cond_on_text_encodings=True but no text_encodings passed")
            if text_encodings.shape[-1] != cfg.text_embed_dim:
                raise ValueError(f"text encodings of width {text_encodings.shape[-1]}, "
                                 f"not text_embed_dim {cfg.text_embed_dim}")
            n_max = cfg.max_text_len
            # a token whose encoding is all zero is padding
            text_mask = (text_encodings != 0).any(-1)[:, :n_max]
            tt = self.text_to_cond(text_encodings)[:, :n_max]
            pad = n_max - tt.shape[1]
            if pad > 0:
                tt = F.pad(tt, (0, 0, 0, pad))
                text_mask = F.pad(text_mask, (0, pad))
            keep_t = text_mask & text_keep_mask[:, None]
            tt = torch.where(keep_t[:, :, None], tt, self.null_text_embed)
            mid_c = torch.cat([c, tt], dim=1)
        mid_c = self.norm_mid_cond(mid_c)
        c = self.norm_cond(c)

        # conditioning streams in the activation dtype (bf16 sampling)
        t, c, mid_c = t.to(x.dtype), c.to(x.dtype), mid_c.to(x.dtype)
        skip_scale = (2**-0.5) if cfg.scale_skip_connection else 1.0

        if cfg.memory_efficient:
            x = block("init_resnet_block", x, t)
        hiddens = []
        for ind in range(n_st):
            if cfg.memory_efficient:
                x = getattr(self, f"down{ind}_pre")(x)
            x = block(f"down{ind}_init_block", x, t)
            for j in range(self._nblocks[ind]):
                x = block(f"down{ind}_block{j}", x, t, c)
                hiddens.append(x)
            x = attend(f"down{ind}", x)
            hiddens.append(x)
            x = getattr(self, f"down{ind}_post")(x)

        x = block("mid_block1", x, t, mid_c)
        if cfg.attend_at_middle:
            x = attend("mid", x)
        x = block("mid_block2", x, t, mid_c)

        up_hiddens = []
        for ind in range(n_st):
            st = n_st - 1 - ind
            x = torch.cat([x, hiddens.pop() * skip_scale], dim=-1)
            x = block(f"up{ind}_init_block", x, t, c)
            for j in range(self._nblocks[st]):
                x = torch.cat([x, hiddens.pop() * skip_scale], dim=-1)
                x = block(f"up{ind}_block{j}", x, t, c)
            x = attend(f"up{ind}", x)
            up_hiddens.append(x)
            if hasattr(self, f"up{ind}_upsample"):
                x = getattr(self, f"up{ind}_upsample")(x)

        x = self.upsample_combiner(x, up_hiddens)
        x = torch.cat([x, r], dim=-1)
        x = block("final_resnet_block", x, t)
        if cfg.lowres_cond:
            x = torch.cat([x, lowres_cond_video.to(x.dtype)], dim=-1)
        return self.to_out(x)
