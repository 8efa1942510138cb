"""ViViT, the factorised space / time video tower of the video-CLIP (port of
dalle2_video_tpu/models/vivit.py).

Patch embedding ``b t (h p1) (w p2) c -> b t (h w) (p1 p2 c)`` (that order
sets the rows of ``patch_embed``'s weight), a learned (frame, patch)
position embedding of which only ``[:t, :n]`` is added (it has ``n + 1``
patch slots and no CLS token is appended), a space transformer per frame
(frames folded into the batch), the transformed patch-0 token as each
frame's representation, a temporal transformer, and a head that folds time
into channels twice by ``scale_dim_conv`` with a 3-tap conv after each
fold, then flatten, LayerNorm and a projection to ``dim``.

Module names follow the flax tree (``patch_embed``, ``space_transformer.
attn0.to_qkv`` ...), so ``weights.load_from_jax`` carries JAX weights
across; the flax 1-D conv kernel (3, in, out) becomes Conv1d's (out, in, 3)
and the head convolves (b, channels, time) where JAX convolves (b, time,
channels). LayerNorms are flax's (eps 1e-6), the GELU exact.

Dropout follows flax's ``nn.Dropout``: it acts only in training mode with
a rate above 0, keeps each value with probability 1 - rate from an
explicit ``torch.Generator`` and scales the kept ones by 1 / (1 - rate). A
forward that would drop without a generator raises: training never skips
configured dropout silently.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from dalle2_video_tpu_torch.models.layers import Dense, LayerNorm, kernel_init_
from dalle2_video_tpu_torch.utils.keys import batch_draw


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None):
        if not self.training or self.rate == 0.0:
            return x
        if generator is None:
            raise ValueError("ViViT dropout / emb_dropout is configured: pass a generator so "
                             "training applies it")
        if self.rate == 1.0:
            return torch.zeros_like(x)
        keep = batch_draw(lambda s: torch.rand(s, generator=generator, device=x.device),
                          x.shape) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


class MHAttention(nn.Module):
    """Multi-head self-attention with full per-head k and v (flax names
    ``to_qkv``, ``to_out``); no output projection when heads == 1 and
    dim_head == dim."""

    def __init__(self, dim: int, heads: int = 8, dim_head: int = 64, dropout: float = 0.0):
        super().__init__()
        self.heads, self.dim_head = heads, dim_head
        inner = heads * dim_head
        self.to_qkv = Dense(dim, inner * 3, bias=False)
        self.project_out = not (heads == 1 and dim_head == dim)
        if self.project_out:
            self.to_out = Dense(inner, dim)
        self.attn_drop = Dropout(dropout)
        self.out_drop = Dropout(dropout)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        b, n, _ = x.shape
        h, d = self.heads, self.dim_head
        q, k, v = (a.reshape(b, n, h, d) for a in self.to_qkv(x).chunk(3, dim=-1))
        attn = torch.softmax(torch.einsum("bnhd,bmhd->bhnm", q * d**-0.5, k), dim=-1)
        attn = self.attn_drop(attn, generator)
        out = torch.einsum("bhnm,bmhd->bnhd", attn, v).reshape(b, n, h * d)
        if self.project_out:
            out = self.out_drop(self.to_out(out), generator)
        return out


class FeedForward(nn.Module):
    """Dense -> exact GELU -> dropout -> Dense -> dropout (flax names
    ``Dense_0``, ``Dense_1``)."""

    def __init__(self, dim: int, hidden_dim: int, dropout: float = 0.0):
        super().__init__()
        self.Dense_0 = Dense(dim, hidden_dim)
        self.Dense_1 = Dense(hidden_dim, dim)
        self.drop = Dropout(dropout)

    def forward(self, x, generator: Optional[torch.Generator] = None):
        x = self.drop(F.gelu(self.Dense_0(x)), generator)
        return self.drop(self.Dense_1(x), generator)


class Transformer(nn.Module):
    """Pre-norm transformer: per layer ``attn_norm{i}`` -> ``attn{i}`` and
    ``ff_norm{i}`` -> ``ff{i}``, each added to the residual."""

    def __init__(self, dim: int, depth: int, heads: int, dim_head: int, mlp_dim: int,
                 dropout: float = 0.0):
        super().__init__()
        self.depth = depth
        for i in range(depth):
            self.add_module(f"attn_norm{i}", LayerNorm(dim))
            self.add_module(f"attn{i}", MHAttention(dim, heads, dim_head, dropout))
            self.add_module(f"ff_norm{i}", LayerNorm(dim))
            self.add_module(f"ff{i}", FeedForward(dim, mlp_dim, dropout))

    def forward(self, x, generator: Optional[torch.Generator] = None):
        for i in range(self.depth):
            x = x + getattr(self, f"attn{i}")(getattr(self, f"attn_norm{i}")(x), generator)
            x = x + getattr(self, f"ff{i}")(getattr(self, f"ff_norm{i}")(x), generator)
        return x


@dataclasses.dataclass(frozen=True)
class ViViTConfig:
    frame_size: int = 224
    patch_size: int = 56
    num_frames: int = 150
    dim: int = 512
    depth: int = 4
    heads: int = 3
    in_channels: int = 3
    dim_head: int = 64
    dropout: float = 0.0
    emb_dropout: float = 0.0
    scale_dim_attn: int = 4
    scale_dim_conv: int = 5

    def __post_init__(self):
        if self.frame_size % self.patch_size:
            raise ValueError(f"frame_size {self.frame_size} is not a multiple of patch_size "
                             f"{self.patch_size}")
        if self.num_frames % (self.scale_dim_conv**2):
            raise ValueError("temporal-conv head folds time by scale_dim_conv twice "
                             f"({self.num_frames} % {self.scale_dim_conv**2} != 0)")

    @property
    def has_dropout(self) -> bool:
        return self.dropout > 0 or self.emb_dropout > 0


def _conv1d(channels_in: int, channels_out: int) -> nn.Conv1d:
    """flax nn.Conv(k=3, SAME) with the JAX package's torch_kernel_init."""
    conv = nn.Conv1d(channels_in, channels_out, 3, padding=1)
    kernel_init_(conv.weight, 3 * channels_in)
    nn.init.zeros_(conv.bias)
    return conv


class ViViT(nn.Module):
    """(b, t, h, w, c) video -> (b, dim) embedding."""

    def __init__(self, cfg: ViViTConfig):
        super().__init__()
        self.cfg = cfg
        p, d, s = cfg.patch_size, cfg.dim, cfg.scale_dim_conv
        n = (cfg.frame_size // p) ** 2
        self.patch_embed = Dense(p * p * cfg.in_channels, d)
        self.pos_embedding = nn.Parameter(torch.randn(1, cfg.num_frames, n + 1, d))
        self.emb_drop = Dropout(cfg.emb_dropout)
        mlp = d * cfg.scale_dim_attn
        self.space_transformer = Transformer(d, cfg.depth, cfg.heads, cfg.dim_head, mlp,
                                             cfg.dropout)
        self.temporal_transformer = Transformer(d, cfg.depth, cfg.heads, cfg.dim_head, mlp,
                                                cfg.dropout)
        self.temporal_conv1 = _conv1d(s * d, d)
        self.temporal_conv2 = _conv1d(s * d, d)
        self.out_norm = LayerNorm(d * cfg.num_frames // s**2)
        self.to_out = Dense(d * cfg.num_frames // s**2, d)

    def forward(self, video: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.cfg
        b, t, hh, ww, c = video.shape
        p, d, s = cfg.patch_size, cfg.dim, cfg.scale_dim_conv
        nh, nw = hh // p, ww // p
        n = nh * nw
        x = video.reshape(b, t, nh, p, nw, p, c).permute(0, 1, 2, 4, 3, 5, 6)
        x = self.patch_embed(x.reshape(b, t, n, p * p * c))
        x = self.emb_drop(x + self.pos_embedding[:, :t, :n], generator)

        x = self.space_transformer(x.reshape(b * t, n, d), generator)
        x = x[:, 0].reshape(b, t, d)  # each frame: its transformed patch-0 token
        x = self.temporal_transformer(x, generator)

        # fold time by s into channels (channel index = i * d + j for frame
        # i of a group), a 3-tap conv over the folded time, twice
        h = x.reshape(b, t // s, s * d)
        h = self.temporal_conv1(h.transpose(1, 2)).transpose(1, 2)
        h = h.reshape(b, t // (s * s), s * d)
        h = F.silu(self.temporal_conv2(h.transpose(1, 2)).transpose(1, 2))
        return self.to_out(self.out_norm(h.reshape(b, -1)))
