"""Import the reference's torch checkpoints into the port's modules (port of
dalle2_video_tpu/models/torch_import.py).

The reference (SeanNobel/DALLE2-video) saves raw ``state_dict()`` blobs:
``video_encoder_{last,best}.pt`` (its ViViT), ``decoder_{last,best}.pt``
(its ``VideoDecoder``: ``unets.{i}.*`` and non-parameter buffers) and the
``VideoDecoderTrainer.save`` bundle (``model``, ``steps``, ``optim{i}``,
``sched{i}``, ``ema``). This module loads them into the port's ``ViViT``,
``UNet3D`` / ``VideoDecoder`` and ``DecoderTrainer``, strictly: every
reference key is consumed (or named as a skipped buffer) and every port
parameter is filled, with the reference key's shape checked.

Each importer is a walk: ``vivit_walk``, ``unet3d_walk`` and
``decoder_walk`` list, for each reference key, its shape, the port
parameter it fills (None for a key the reference registers and this
module's config does not use) and the conversion (``Entry``). The shapes
come from the port module, so a caller can draw a reference-layout state
dict at any width without the reference. The conversions are the JAX
importer's composed with ``weights.py``'s bridge (the port's names are the
flax paths, ``kernel`` / ``scale`` as ``weight``):

  * Linear weight (out, in), biases, LayerNorm and GroupNorm weight / bias,
    lucidrains' scale-only LayerNorm ``g``, ``null_kv``, the nulls, the
    position embedding: copied (JAX's transposes and the bridge's cancel);
  * Conv3d (1, k, k) weight (out, in, 1, k, k) -> Conv2d (out, in, k, k)
    (space-only convs over the folded (B*T) batch);
  * Downsample3D (pixel-unshuffle + 1x1 Conv3d, weight (o, 4c, 1, 1, 1)) ->
    the identical 2x2 stride-2 conv, weight[o, c, s1, s2] = W[o, c*4 +
    s1*2 + s2]: a reshape;
  * PixelShuffleUpsample3D's 1x1 conv (4*dim_out, in, 1, 1, 1) -> the
    (in, 4*dim_out) matrix ``conv`` (torch PixelShuffle's channel order is
    the port's subpixel order);
  * the ViViT's three channel-order permutations (the reference folds
    channels first, the port channels last): both temporal convs' input
    channels (reference d_idx * s + s_idx, port s_idx * d + d_idx), and the
    head's flatten (reference (b, d, t) d-major, port (b, t, d) t-major):
    the output LayerNorm's weight / bias and the projection's input
    columns.

Refused as in the JAX importer: ``sparse_attn`` and
``combine_upsample_fmaps`` unets (the reference crashes on video with
them, so no checkpoint exists). A per-frame-embed or temporal-attention
unet has port parameters no reference key fills, and is refused as
unfilled.

The trainer bundle transfers the parameters, the EMA shadows (and their
update counts) and the per-unet steps exactly. The Adam moments are not
mapped: dalle2-pytorch addresses them by position within its weight-decay
groups, an order that cannot be reproduced without running it. The
optimisers warm-restart with fresh state, the JAX importer's documented
divergence. State dicts load with ``torch.load(weights_only=True)``; the
bundle holds more than tensors and is unpickled (``weights_only=False``)
as the JAX loader does: load only a bundle you trust.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn as nn

from dalle2_video_tpu_torch.models.unet3d import UNet3D, UNet3DConfig
from dalle2_video_tpu_torch.models.vivit import ViViT, ViViTConfig

__all__ = [
    "Entry",
    "vivit_walk",
    "unet3d_walk",
    "decoder_walk",
    "vivit_params_from_torch",
    "load_vivit_torch_ckpt",
    "unet3d_params_from_torch",
    "decoder_params_from_torch",
    "load_decoder_torch_ckpt",
    "trainer_state_from_torch",
    "load_trainer_torch_ckpt",
    "DECODER_NONPARAM_PREFIXES",
]

# prefixes of VideoDecoder.state_dict() entries the port derives from its
# config instead of loading (schedules, VAEs, low-res conditioners, CLIP)
DECODER_NONPARAM_PREFIXES = ("noise_schedulers.", "vaes.", "lowres_conds.", "clip.", "_dummy")

Shape = Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Entry:
    """One reference key: its shape, the port parameter it fills (None:
    consumed, not loaded) and how (``copy``, ``conv3d_space``,
    ``downsample``, ``pixel_shuffle``, ``permute``: ``index`` along
    ``axis``)."""

    ref_key: str
    ref_shape: Shape
    port_key: Optional[str]
    how: str = "copy"
    axis: int = 0
    index: Optional[Tuple[int, ...]] = None

    def convert(self, t: torch.Tensor) -> torch.Tensor:
        """The reference tensor in the port parameter's layout (f32)."""
        t = t.detach().to(torch.float32)
        if self.how == "conv3d_space":
            t = t[:, :, 0]
        elif self.how == "downsample":
            t = t[:, :, 0, 0, 0].reshape(t.shape[0], t.shape[1] // 4, 2, 2)
        elif self.how == "pixel_shuffle":
            t = t[:, :, 0, 0, 0].T
        elif self.how == "permute":
            t = t.index_select(self.axis, torch.tensor(self.index, device=t.device))
        elif self.how != "copy":
            raise ValueError(f"unknown conversion {self.how!r}")
        return t.contiguous().clone()


def _ref_shape(how: str, port: Shape) -> Shape:
    if how == "conv3d_space":
        o, i, kh, kw = port
        return (o, i, 1, kh, kw)
    if how == "downsample":
        o, c, _, _ = port
        return (o, 4 * c, 1, 1, 1)
    if how == "pixel_shuffle":
        i, o4 = port
        return (o4, i, 1, 1, 1)
    return tuple(port)


class _Walk:
    """Builds a walk against a port module's parameter shapes."""

    def __init__(self, module: nn.Module):
        self.own: Dict[str, Shape] = {k: tuple(v.shape) for k, v in module.state_dict().items()}
        self.entries: List[Entry] = []

    def has(self, port_key: str) -> bool:
        return port_key in self.own

    def add(self, ref: str, port: str, how: str = "copy", axis: int = 0,
            index: Optional[np.ndarray] = None) -> None:
        if port not in self.own:
            raise ValueError(f"the port module has no parameter {port} for reference key {ref}")
        self.entries.append(Entry(ref, _ref_shape(how, self.own[port]), port, how, axis,
                                  None if index is None else tuple(int(i) for i in index)))

    def drop(self, ref: str, shape: Shape) -> None:
        self.entries.append(Entry(ref, tuple(shape), None))

    def linear(self, ref: str, port: str) -> None:
        self.add(f"{ref}.weight", f"{port}.weight")
        if self.has(f"{port}.bias"):
            self.add(f"{ref}.bias", f"{port}.bias")

    def norm(self, ref: str, port: str) -> None:
        self.add(f"{ref}.weight", f"{port}.weight")
        self.add(f"{ref}.bias", f"{port}.bias")

    def done(self) -> List[Entry]:
        filled = {e.port_key for e in self.entries if e.port_key is not None}
        unfilled = sorted(set(self.own) - filled)
        if unfilled:
            raise ValueError(f"{len(unfilled)} port parameters no reference key fills "
                             f"(first 10: {unfilled[:10]}): the module's config has no "
                             f"reference counterpart")
        return self.entries


# ---------------------------------------------------------------------- #
# ViViT (stage 1)
# ---------------------------------------------------------------------- #
def _fold_perm(dim: int, s: int) -> np.ndarray:
    """perm[port channel] = reference channel: the port's channel s_idx *
    dim + d_idx is the reference's d_idx * s + s_idx."""
    s_idx, d_idx = np.meshgrid(np.arange(s), np.arange(dim), indexing="ij")
    return (d_idx * s + s_idx).reshape(-1)


def vivit_walk(vivit: ViViT) -> List[Entry]:
    """The reference ViViT's keys (video_encoder.py's module tree) onto
    ``vivit``'s parameters."""
    cfg = vivit.cfg
    w = _Walk(vivit)
    w.linear("to_patch_embedding.1", "patch_embed")
    w.add("pos_embedding", "pos_embedding")
    for tower in ("space_transformer", "temporal_transformer"):
        for i in range(cfg.depth):
            attn, ff = f"{tower}.layers.{i}.0", f"{tower}.layers.{i}.1"
            w.norm(f"{attn}.norm", f"{tower}.attn_norm{i}")
            w.add(f"{attn}.fn.to_qkv.weight", f"{tower}.attn{i}.to_qkv.weight")
            if w.has(f"{tower}.attn{i}.to_out.weight"):  # project_out (Identity otherwise)
                w.linear(f"{attn}.fn.to_out.0", f"{tower}.attn{i}.to_out")
            w.norm(f"{ff}.norm", f"{tower}.ff_norm{i}")
            w.linear(f"{ff}.fn.net.0", f"{tower}.ff{i}.Dense_0")
            w.linear(f"{ff}.fn.net.3", f"{tower}.ff{i}.Dense_1")
    d, s = cfg.dim, cfg.scale_dim_conv
    for ref, port in (("temporal_conv.2", "temporal_conv1"), ("temporal_conv.4", "temporal_conv2")):
        w.add(f"{ref}.weight", f"{port}.weight", "permute", axis=1, index=_fold_perm(d, s))
        w.add(f"{ref}.bias", f"{port}.bias")
    t_out = cfg.num_frames // (s * s)
    d_idx, t_idx = np.meshgrid(np.arange(d), np.arange(t_out), indexing="ij")
    head = (d_idx * t_out + t_idx).T.reshape(-1)  # port (t-major) <- reference (d-major)
    for leaf in ("weight", "bias"):
        w.add(f"to_out.1.{leaf}", f"out_norm.{leaf}", "permute", axis=0, index=head)
    w.add("to_out.2.weight", "to_out.weight", "permute", axis=1, index=head)
    w.add("to_out.2.bias", "to_out.bias")
    return w.done()


# ---------------------------------------------------------------------- #
# Unet3D and the decoder (stage 3)
# ---------------------------------------------------------------------- #
def _cast(v, n: int) -> Tuple:
    return tuple(v) if isinstance(v, (tuple, list)) else (v,) * n


def unet3d_walk(unet: UNet3D) -> List[Entry]:
    """The reference Unet3D's keys (dalle2_video.py:247-648) onto
    ``unet``'s parameters, in the JAX importer's order."""
    cfg = unet.cfg
    if cfg.sparse_attn:
        raise NotImplementedError(
            "sparse_attn import: the reference's LinearAttention is 2D-conv based and crashes "
            "on video, so no checkpoint exists to import")
    if cfg.combine_upsample_fmaps:
        raise NotImplementedError(
            "combine_upsample_fmaps import: the reference feeds 5D video through 2D "
            "UpsampleCombiner blocks and crashes, so no checkpoint exists to import")
    w = _Walk(unet)

    def conv(ref: str, port: str) -> None:  # a (1, k, k) Conv3d onto a SpatialConv
        w.add(f"{ref}.weight", f"{port}.Conv_0.weight", "conv3d_space")
        w.add(f"{ref}.bias", f"{port}.Conv_0.bias")

    def scale_norm(ref: str, port: str) -> None:
        w.add(f"{ref}.g", f"{port}.LayerNorm_0.weight")

    def attention(ref: str, port: str) -> None:
        scale_norm(f"{ref}.norm", f"{port}.norm")
        w.add(f"{ref}.null_kv", f"{port}.null_kv")
        for leaf in ("to_q", "to_kv"):
            w.add(f"{ref}.{leaf}.weight", f"{port}.{leaf}.weight")
        w.add(f"{ref}.to_out.0.weight", f"{port}.to_out.weight")
        scale_norm(f"{ref}.to_out.1", f"{port}.out_norm")

    def resnet(ref: str, port: str) -> None:
        for blk in ("block1", "block2"):
            conv(f"{ref}.{blk}.project", f"{port}.{blk}.project")
            w.norm(f"{ref}.{blk}.norm", f"{port}.{blk}.norm")
        if w.has(f"{port}.time_mlp.weight"):
            w.linear(f"{ref}.time_mlp.1", f"{port}.time_mlp")
        if w.has(f"{port}.cross_attn.to_q.weight"):
            attention(f"{ref}.cross_attn", f"{port}.cross_attn")
        if w.has(f"{port}.res_conv.Conv_0.weight"):
            conv(f"{ref}.res_conv", f"{port}.res_conv")

    def cross_embed(ref: str, port: str, n: int) -> None:
        for i in range(n):
            conv(f"{ref}.convs.{i}", f"{port}.conv{i}")

    def downsample(ref: str, port: str) -> None:
        if cfg.cross_embed_downsample:
            cross_embed(ref, port, len(cfg.cross_embed_downsample_kernel_sizes))
        else:  # pixel-unshuffle + 1x1 Conv3d, its parameters at index 1
            w.add(f"{ref}.1.weight", f"{port}.conv.Conv_0.weight", "downsample")
            w.add(f"{ref}.1.bias", f"{port}.conv.Conv_0.bias")

    def upsample(ref: str, port: str) -> None:
        if cfg.pixel_shuffle_upsample:
            w.add(f"{ref}.conv.weight", f"{port}.conv", "pixel_shuffle")
            w.add(f"{ref}.conv.bias", f"{port}.conv_bias")
        else:  # Upsample + (1, 3, 3) Conv3d at index 1
            conv(f"{ref}.1", f"{port}.conv")

    if cfg.init_cross_embed:
        cross_embed("init_conv", "init_conv", len(cfg.init_cross_embed_kernel_sizes))
    else:
        conv("init_conv", "init_conv")
    w.linear("to_time_hiddens.1", "time_cond.to_hiddens")
    w.linear("to_time_tokens.0", "time_cond.to_tokens")
    w.linear("to_time_cond.0", "time_cond.to_cond")
    # the reference registers the nulls whatever its config: the port keeps
    # the ones its config reads
    cond, tcd = cfg.resolved_cond_dim, cfg.time_cond_dim
    for name, shape in (("null_video_embed", (1, cfg.num_video_tokens, cond)),
                        ("null_video_hiddens", (1, tcd)),
                        ("null_text_embed", (1, cfg.max_text_len, cond))):
        if w.has(name):
            w.add(name, name)
        else:
            w.drop(name, shape)
    if w.has("to_video_hiddens.weight"):
        w.linear("to_video_hiddens.0", "to_video_hiddens")
    if w.has("video_to_tokens.weight"):
        w.linear("video_to_tokens.0", "video_to_tokens")
    if cfg.cond_on_text_encodings:
        w.linear("text_to_cond", "text_to_cond")
    if cfg.lowres_noise_cond:
        w.linear("to_lowres_noise_cond.1", "lowres_dense1")
        w.linear("to_lowres_noise_cond.3", "lowres_dense2")
    w.norm("norm_cond", "norm_cond")
    w.norm("norm_mid_cond", "norm_mid_cond")

    num = cfg.num_stages
    self_attn, nblocks = _cast(cfg.self_attn, num), _cast(cfg.num_resnet_blocks, num)
    me = cfg.memory_efficient
    if me:
        resnet("init_resnet_block", "init_resnet_block")
    for ind in range(num):
        tp = f"downs.{ind}"
        if me:
            downsample(f"{tp}.0", f"down{ind}_pre")
        resnet(f"{tp}.1", f"down{ind}_init_block")
        for j in range(nblocks[ind]):
            resnet(f"{tp}.2.{j}", f"down{ind}_block{j}")
        if self_attn[ind]:  # RearrangeToSequence(Residual(Attention)): two .fn hops
            attention(f"{tp}.3.fn.fn", f"down{ind}_attn.attn")
        if ind < num - 1 and not me:
            downsample(f"{tp}.4", f"down{ind}_post")
        else:
            conv(f"{tp}.4", f"down{ind}_post")
    resnet("mid_block1", "mid_block1")
    if cfg.attend_at_middle:
        attention("mid_attn.fn.fn", "mid_attn.attn")
    resnet("mid_block2", "mid_block2")
    for ind in range(num):
        tp = f"ups.{ind}"
        resnet(f"{tp}.0", f"up{ind}_init_block")
        for j in range(nblocks[num - 1 - ind]):
            resnet(f"{tp}.1.{j}", f"up{ind}_block{j}")
        if self_attn[num - 1 - ind]:
            attention(f"{tp}.2.fn.fn", f"up{ind}_attn.attn")
        if ind < num - 1 or me:
            upsample(f"{tp}.3", f"up{ind}_upsample")
    resnet("final_resnet_block", "final_resnet_block")
    conv("to_out", "to_out")
    return w.done()


def decoder_walk(decoder) -> List[Entry]:
    """Every unet's walk under ``unets.{i}.`` (a VideoDecoder's
    ``state_dict`` also holds the non-parameter buffers of
    ``DECODER_NONPARAM_PREFIXES``, which no walk lists)."""
    return [dataclasses.replace(e, ref_key=f"unets.{i}.{e.ref_key}",
                                port_key=None if e.port_key is None else f"{i}.{e.port_key}")
            for i, unet in enumerate(decoder.unets) for e in unet3d_walk(unet)]


# ---------------------------------------------------------------------- #
# applying a walk
# ---------------------------------------------------------------------- #
def apply_walk(entries: Sequence[Entry], state_dict: Mapping[str, Any], *,
               strict: bool = True, what: str = "import"
               ) -> "OrderedDict[str, torch.Tensor]":
    """The port state dict the walk makes of ``state_dict``: every entry's
    key must be present (KeyError) with its shape (ValueError); with
    ``strict`` no key of ``state_dict`` may be left unconsumed
    (ValueError)."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for e in entries:
        t = torch.as_tensor(state_dict[e.ref_key])
        if tuple(t.shape) != e.ref_shape:
            raise ValueError(f"{what}: {e.ref_key} has shape {tuple(t.shape)}, the module's "
                             f"{e.ref_shape}: checkpoint geometry does not match the config")
        if e.port_key is not None:
            out[e.port_key] = e.convert(t)
    if strict:
        leftover = sorted(set(state_dict) - {e.ref_key for e in entries})
        if leftover:
            raise ValueError(f"{what} left {len(leftover)} torch keys unmapped (first 10: "
                             f"{leftover[:10]}): config / checkpoint mismatch")
    return out


def _meta(build):
    with torch.device("meta"):
        return build()


def vivit_params_from_torch(state_dict: Mapping[str, Any], cfg: ViViTConfig
                            ) -> "OrderedDict[str, torch.Tensor]":
    """A reference ViViT ``state_dict()`` as the state dict of
    ``ViViT(cfg)``: KeyError on a missing key, ValueError on a geometry
    mismatch or an unmapped key."""
    entries = vivit_walk(_meta(lambda: ViViT(cfg)))
    pos = next(e for e in entries if e.ref_key == "pos_embedding")
    got = tuple(torch.as_tensor(state_dict["pos_embedding"]).shape)
    if got != pos.ref_shape:
        raise ValueError(f"pos_embedding {got} != {pos.ref_shape}: checkpoint geometry does "
                         "not match ViViTConfig")
    return apply_walk(entries, state_dict, what="vivit import")


def _torch_load(path: str, weights_only: bool = True):
    with open(path, "rb") as f:  # a missing file raises FileNotFoundError
        return torch.load(f, map_location="cpu", weights_only=weights_only)


def load_vivit_torch_ckpt(path: str, cfg: ViViTConfig) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``video_encoder_{last,best}.pt`` (a raw state dict) from
    disk, as ``vivit_params_from_torch`` returns it."""
    return vivit_params_from_torch(_torch_load(path), cfg)


def unet3d_params_from_torch(state_dict: Mapping[str, Any], cfg: UNet3DConfig, *,
                             strict: bool = True) -> "OrderedDict[str, torch.Tensor]":
    """A reference ``Unet3D.state_dict()`` as the state dict of
    ``UNet3D(cfg)``; ``strict`` raises on any reference key left
    unconsumed, the proof that no trained parameter was dropped."""
    return apply_walk(unet3d_walk(_meta(lambda: UNet3D(cfg))), state_dict, strict=strict,
                      what="unet import")


def _split_decoder_keys(state_dict: Mapping[str, Any], n: int, strict: bool
                        ) -> Tuple[Dict[int, Dict[str, Any]], List[str]]:
    per_unet: Dict[int, Dict[str, Any]] = {}
    skipped: List[str] = []
    for k, v in state_dict.items():
        if k.startswith("unets."):
            i, rest = k[len("unets."):].split(".", 1)
            per_unet.setdefault(int(i), {})[rest] = v
        elif k.startswith(DECODER_NONPARAM_PREFIXES):
            skipped.append(k)
        else:
            raise ValueError(f"unrecognized decoder state_dict key: {k}")
    if strict and sorted(per_unet) != list(range(n)):
        raise ValueError(f"checkpoint has unets {sorted(per_unet)}, decoder expects {n}")
    return per_unet, skipped


def decoder_params_from_torch(state_dict: Mapping[str, Any], decoder, *, strict: bool = True
                              ) -> Tuple[List["OrderedDict[str, torch.Tensor]"], List[str]]:
    """A reference ``decoder_{last,best}.pt`` (raw ``VideoDecoder.state_dict()``)
    as ``(per-unet state dicts for decoder.unets, skipped keys)``; the
    skipped keys are the buffers under ``DECODER_NONPARAM_PREFIXES``,
    another key outside ``unets.`` raises."""
    per_unet, skipped = _split_decoder_keys(state_dict, len(decoder.unets), strict)
    params = [apply_walk(unet3d_walk(decoder.unets[i]), per_unet[i], strict=strict,
                         what=f"unet {i} import") for i in sorted(per_unet)]
    return params, skipped


@torch.no_grad()
def _load_unets(decoder, params: Sequence[Mapping[str, torch.Tensor]]) -> None:
    for unet, sd in zip(decoder.unets, params):
        unet.load_state_dict(sd, strict=True)
    decoder._sampling_unets.clear()  # the bf16 / flash copies are rebuilt


def load_decoder_torch_ckpt(path: str, decoder) -> List[str]:
    """Load ``decoder_{last,best}.pt`` from disk into ``decoder``'s unets
    (strict); returns the skipped non-parameter keys."""
    params, skipped = decoder_params_from_torch(_torch_load(path), decoder)
    _load_unets(decoder, params)
    return skipped


@torch.no_grad()
def trainer_state_from_torch(bundle: Mapping[str, Any], trainer) -> None:
    """A reference ``VideoDecoderTrainer.save`` bundle into ``trainer`` (a
    ``DecoderTrainer``): its unets' parameters, fresh optimiser state, the
    EMA shadows (``ema``: ``{i}.ema_model.<unet key>`` and ``{i}.step``;
    a unet the bundle has no shadow for starts its EMA from the parameters
    at update 0, as a fresh JAX state does) and the per-unet steps."""
    from dalle2_video_tpu_torch.train.ema import EMAState, ema_init

    decoder = trainer.decoder
    params, _ = decoder_params_from_torch(bundle["model"], decoder)
    _load_unets(decoder, params)
    for opt in trainer.optimizers:
        opt.state.clear()
    steps = [int(s) for s in torch.as_tensor(bundle["steps"]).reshape(-1).tolist()]
    if len(steps) != trainer.num_unets:
        raise ValueError(f"the bundle has {len(steps)} step counts for {trainer.num_unets} unets")
    if trainer.cfg.use_ema:
        ema_sd = bundle.get("ema") or {}
        for i, unet in enumerate(decoder.unets):
            pref = f"{i}.ema_model."
            sub = {k[len(pref):]: v for k, v in ema_sd.items() if k.startswith(pref)}
            if not sub:
                trainer.ema[i] = ema_init(trainer.params(i))
                continue
            shadow = apply_walk(unet3d_walk(unet), sub, what=f"unet {i} EMA import")
            step = int(ema_sd[f"{i}.step"]) if f"{i}.step" in ema_sd else steps[i]
            trainer.ema[i] = EMAState({k: v.to(decoder.device) for k, v in shadow.items()}, step)
    trainer.steps = steps


def load_trainer_torch_ckpt(path: str, trainer) -> None:
    """Load a reference trainer bundle from disk into ``trainer`` (see
    ``trainer_state_from_torch``). The bundle is unpickled
    (``weights_only=False``), as the JAX loader does: only a trusted file."""
    trainer_state_from_torch(_torch_load(path, weights_only=False), trainer)


def draw_walk(entries: Iterable[Entry], generator: torch.Generator
              ) -> "OrderedDict[str, torch.Tensor]":
    """A reference-layout state dict of seeded random tensors for the
    walk's keys and shapes: weights of 2 or more dims N(0, 1 / fan-in),
    1-d weights and ``g`` 1 + 0.1 N(0, 1), other tensors 0.1 N(0, 1)
    (the nulls, ``null_kv`` and the position embedding N(0, 1))."""
    out: "OrderedDict[str, torch.Tensor]" = OrderedDict()
    for e in entries:
        z = torch.randn(e.ref_shape, generator=generator)
        leaf = e.ref_key.rsplit(".", 1)[-1]
        if leaf == "weight" and len(e.ref_shape) >= 2:
            z = z / float(np.prod(e.ref_shape[1:])) ** 0.5
        elif leaf in ("weight", "g"):
            z = 1.0 + 0.1 * z
        elif not (leaf.startswith("null") or leaf == "pos_embedding"):
            z = 0.1 * z
        out[e.ref_key] = z
    return out
