"""Frozen CLIP text tower (port of dalle2_video_tpu/models/clip_text.py):
ViT-B/32 text transformer -- 12 layers, width 512, 8 heads, 77-token
context, quick-gelu, argmax-EOT pooling through a text projection.

Parameter names follow the flax module (``block{i}.attn_in`` ...), so
``weights.load_from_jax`` carries JAX weights across. Loading OpenAI CLIP
weights waits until they are in the repository; random weights are for
smoke runs only and are not CLIP-compatible.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn as nn

from dalle2_video_tpu_torch.models.layers import Dense, LayerNorm


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    context_length: int = 77
    width: int = 512
    heads: int = 8
    layers: int = 12
    embed_dim: int = 512


def quick_gelu(x):
    return x * torch.sigmoid(1.702 * x)


class ResidualAttentionBlock(nn.Module):
    def __init__(self, width: int, heads: int):
        super().__init__()
        self.heads = heads
        self.ln_1 = LayerNorm(width)
        self.attn_in = Dense(width, 3 * width)
        self.attn_out = Dense(width, width)
        self.ln_2 = LayerNorm(width)
        self.mlp_fc = Dense(width, 4 * width)
        self.mlp_proj = Dense(4 * width, width)

    def forward(self, x, causal_mask):
        b, n, d = x.shape
        h = self.heads
        q, k, v = self.attn_in(self.ln_1(x)).chunk(3, dim=-1)
        rs = lambda a: a.reshape(b, n, h, d // h)
        q, k, v = rs(q), rs(k), rs(v)
        sim = torch.einsum("bnhd,bmhd->bhnm", q * (d // h) ** -0.5, k)
        sim = sim.masked_fill(~causal_mask[None, None], torch.finfo(sim.dtype).min)
        out = torch.einsum("bhnm,bmhd->bnhd", torch.softmax(sim, -1), v).reshape(b, n, d)
        x = x + self.attn_out(out)
        return x + self.mlp_proj(quick_gelu(self.mlp_fc(self.ln_2(x))))


class CLIPTextEncoder(nn.Module):
    def __init__(self, cfg: CLIPTextConfig = CLIPTextConfig()):
        super().__init__()
        self.cfg = cfg
        self.token_embedding = nn.Parameter(torch.randn(cfg.vocab_size, cfg.width) * 0.02)
        self.positional_embedding = nn.Parameter(
            torch.randn(cfg.context_length, cfg.width) * 0.01)
        for i in range(cfg.layers):
            self.add_module(f"block{i}", ResidualAttentionBlock(cfg.width, cfg.heads))
        self.ln_final = LayerNorm(cfg.width)
        self.text_projection = nn.Parameter(
            torch.randn(cfg.width, cfg.embed_dim) * cfg.width**-0.5)

    def forward(self, tokens: torch.Tensor, return_encodings: bool = False):
        """tokens (b, n) int -> embed (b, embed_dim) [, encodings (b, n, width)]."""
        n = tokens.shape[1]
        x = self.token_embedding[tokens.long()] + self.positional_embedding[None, :n]
        mask = torch.tril(torch.ones(n, n, dtype=torch.bool, device=tokens.device))
        for i in range(self.cfg.layers):
            x = getattr(self, f"block{i}")(x, mask)
        x = self.ln_final(x)
        eot = tokens.argmax(dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        embed = pooled @ self.text_projection
        return (embed, x) if return_encodings else embed
